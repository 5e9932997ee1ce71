"""SGD / NAG / Adam on torch tensors (own copy of
cxxnet_tpu/updater/updaters.py).

Each updater owns its state dict ({"m"} or {"m1", "m2"}, the JAX
package's `state["ustate"]` leaves) and updates the float32 master
weight and that state IN PLACE under `torch.no_grad()` - the port keeps
one copy of each tensor instead of the JAX package's functional
(state, w) -> (state', w').

Formula parity:
- SGD   (sgd_updater-inl.hpp:72-84):
    m = mom*m - lr*(clip(grad) + wd*w); w += m
  where clip() clamps to +-clip_gradient and maps NaN -> 0 (:15-22).
- NAG   (nag_updater-inl.hpp:65-72):
    m_old = m; m = mom*m - lr*(grad + wd*w); w += (1+mom)*m - mom*m_old
- Adam  (adam_updater-inl.hpp:17-83) with decay1/decay2 = 0.1/0.001
  (beta expressed as 1-beta), bias-corrected lr, eps=1e-8, and the
  reference's weight-decay sign quirk `grad -= wd*w` preserved.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cxxnet_tpu_torch.updater.param import UpdaterParam, f32

State = Dict[str, torch.Tensor]


def _clip_nan(grad: torch.Tensor, bound: float) -> torch.Tensor:
    """clip functor: NaN -> 0, then clamp to [-bound, bound]
    (sgd_updater:15)."""
    grad = torch.where(torch.isnan(grad), torch.zeros_like(grad), grad)
    return grad.clamp(-bound, bound)


class Updater:
    """Base per-tensor updater bound to an UpdaterParam."""

    kind = ""

    def __init__(self, param: UpdaterParam):
        self.param = param

    def init_state(self, w: torch.Tensor) -> State:
        raise NotImplementedError

    def apply(self, state: State, w: torch.Tensor, grad: torch.Tensor,
              epoch: int) -> None:
        """One update of `w` and `state` in place from `grad` at update
        count `epoch`."""
        raise NotImplementedError


class SGDUpdater(Updater):
    kind = "sgd"

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    @torch.no_grad()
    def apply(self, state, w, grad, epoch):
        p = self.param
        lr, mom = p.schedule(epoch)
        if p.clip_gradient != 0.0:
            grad = _clip_nan(grad, p.clip_gradient)
        m = state["m"]
        m.copy_(mom * m - lr * (grad + p.wd * w))
        w.add_(m)


class NAGUpdater(Updater):
    kind = "nag"

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    @torch.no_grad()
    def apply(self, state, w, grad, epoch):
        p = self.param
        lr, mom = p.schedule(epoch)
        m_old = state["m"]
        m = mom * m_old - lr * (grad + p.wd * w)
        w.add_((1.0 + mom) * m - mom * m_old)
        m_old.copy_(m)


class AdamUpdater(Updater):
    kind = "adam"

    def __init__(self, param: UpdaterParam, decay1: float = 0.1,
                 decay2: float = 0.001):
        super().__init__(param)
        self.decay1 = decay1
        self.decay2 = decay2

    def init_state(self, w):
        return {"m1": torch.zeros_like(w), "m2": torch.zeros_like(w)}

    @torch.no_grad()
    def apply(self, state, w, grad, epoch):
        p = self.param
        if p.wd > 0.0:
            grad = grad - p.wd * w  # reference sign quirk
        t = f32(epoch) + f32(1.0)
        fix1 = f32(1.0) - np.power(f32(1.0 - self.decay1), t)
        fix2 = f32(1.0) - np.power(f32(1.0 - self.decay2), t)
        lr_t = float(f32(p.base_lr) * np.sqrt(fix2) / fix1)
        m1, m2 = state["m1"], state["m2"]
        m1.copy_(m1 + self.decay1 * (grad - m1))
        m2.copy_(m2 + self.decay2 * (grad * grad - m2))
        w.sub_(lr_t * (m1 / (torch.sqrt(m2) + 1e-8)))


_UPDATERS = {"sgd": SGDUpdater, "nag": NAGUpdater, "adam": AdamUpdater}


def create_updater(kind: str, param: UpdaterParam, **kwargs) -> Updater:
    """Factory (updater_impl-inl.hpp:18-40 CreateUpdater_)."""
    if kind not in _UPDATERS:
        raise ValueError(f"unknown updater type {kind}")
    return _UPDATERS[kind](param, **kwargs)
