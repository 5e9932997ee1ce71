"""SGD / NAG / Adam on torch tensors (own copy of
cxxnet_tpu/updater/updaters.py).

Each updater owns its state dict ({"m"} or {"m1", "m2"}, the JAX
package's `state["ustate"]` leaves). `step` is the JAX package's
functional (state, w) -> (state', w'), out of place, with the epoch's
schedule values (`sched`) given either as Python floats or as 0-d
float32 device tensors (a fused chunk reads them from a device table,
`schedule_table`, indexed by its own update counter); `apply` is `step`
written back IN PLACE under `torch.no_grad()` - the port keeps one copy
of each tensor. Both forms of `sched` hold the same float32 values, and
every product with them rounds once in float32, so the two give the
same bits.

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

from typing import Dict, Tuple

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
    """Base per-tensor updater bound to an UpdaterParam.

    `zero_shardable`: the update is elementwise, so under zero_stage >=
    2 (or a model axis) it may run on a slice of the weight and its
    gradient and give that slice of the whole update. An updater whose
    math reduces over the whole tensor must set it False; the trainer
    then refuses zero_stage >= 2 (the JAX package's contract)."""

    kind = ""
    zero_shardable = True

    def __init__(self, param: UpdaterParam):
        self.param = param

    def init_state(self, w: torch.Tensor) -> State:
        raise NotImplementedError

    def sched(self, epoch: int) -> Tuple[float, ...]:
        """The schedule values at update count `epoch` (float32 numbers
        as Python floats)."""
        raise NotImplementedError

    def step(self, state: State, w: torch.Tensor, grad: torch.Tensor,
             sched) -> Tuple[torch.Tensor, State]:
        """(w', state') from `grad` under the schedule values `sched`;
        the inputs are left as they are."""
        raise NotImplementedError

    def update_(self, state: State, w: torch.Tensor, grad: torch.Tensor,
                sched) -> None:
        """`step` computed in place: `w` and `state` are overwritten with
        (w', state') - the same arithmetic, op for op, so the same bits -
        with no param-sized copy."""
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, state: State, w: torch.Tensor, grad: torch.Tensor,
              epoch: int) -> None:
        """One update of `w` and `state` in place from `grad` at update
        count `epoch`."""
        self.update_(state, w, grad, self.sched(epoch))


def schedule_table(updaters, e0: int, n: int) -> np.ndarray:
    """(len(updaters), n, 2) float32: each updater's schedule values at
    update counts e0 .. e0 + n - 1 (unused columns 0), computed on the
    host exactly as `sched` computes them."""
    out = np.zeros((len(updaters), n, 2), np.float32)
    for i, up in enumerate(updaters):
        for e in range(n):
            vals = up.sched(e0 + e)
            out[i, e, :len(vals)] = vals
    return out


class SGDUpdater(Updater):
    kind = "sgd"

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    def sched(self, epoch):
        return self.param.schedule(epoch)

    @torch.no_grad()
    def step(self, state, w, grad, sched):
        p = self.param
        lr, mom = sched[0], sched[1]
        if p.clip_gradient != 0.0:
            grad = _clip_nan(grad, p.clip_gradient)
        m = mom * state["m"] - lr * (grad + p.wd * w)
        return w + m, {"m": m}

    @torch.no_grad()
    def update_(self, state, w, grad, sched):
        p = self.param
        lr, mom = sched[0], sched[1]
        if p.clip_gradient != 0.0:
            grad = _clip_nan(grad, p.clip_gradient)
        d = grad + p.wd * w
        d.mul_(lr)
        m = state["m"]
        m.mul_(mom).sub_(d)
        w.add_(m)


class NAGUpdater(Updater):
    kind = "nag"

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    def sched(self, epoch):
        return self.param.schedule(epoch)

    @torch.no_grad()
    def step(self, state, w, grad, sched):
        p = self.param
        lr, mom = sched[0], sched[1]
        m_old = state["m"]
        m = mom * m_old - lr * (grad + p.wd * w)
        return w + ((1.0 + mom) * m - mom * m_old), {"m": m}

    @torch.no_grad()
    def update_(self, state, w, grad, sched):
        p = self.param
        lr, mom = sched[0], sched[1]
        m = state["m"]
        v = mom * m
        d = grad + p.wd * w
        d.mul_(lr)
        torch.sub(v, d, out=m)
        u = (1.0 + mom) * m
        u.sub_(v)
        w.add_(u)


class AdamUpdater(Updater):
    kind = "adam"

    def __init__(self, param: UpdaterParam, decay1: float = 0.1,
                 decay2: float = 0.001):
        super().__init__(param)
        self.decay1 = decay1
        self.decay2 = decay2

    def init_state(self, w):
        return {"m1": torch.zeros_like(w), "m2": torch.zeros_like(w)}

    def sched(self, epoch):
        """(lr_t,): the bias-corrected step size at update `epoch`."""
        t = f32(epoch) + f32(1.0)
        fix1 = f32(1.0) - np.power(f32(1.0 - self.decay1), t)
        fix2 = f32(1.0) - np.power(f32(1.0 - self.decay2), t)
        return (float(f32(self.param.base_lr) * np.sqrt(fix2) / fix1),)

    @torch.no_grad()
    def step(self, state, w, grad, sched):
        p = self.param
        if p.wd > 0.0:
            grad = grad - p.wd * w  # reference sign quirk
        m1, m2 = state["m1"], state["m2"]
        m1 = m1 + self.decay1 * (grad - m1)
        m2 = m2 + self.decay2 * (grad * grad - m2)
        w_new = w - sched[0] * (m1 / (torch.sqrt(m2) + 1e-8))
        return w_new, {"m1": m1, "m2": m2}

    @torch.no_grad()
    def update_(self, state, w, grad, sched):
        p = self.param
        if p.wd > 0.0:
            grad = grad - p.wd * w
        m1, m2 = state["m1"], state["m2"]
        t = grad - m1
        t.mul_(self.decay1)
        m1.add_(t)
        t = grad * grad
        t.sub_(m2)
        t.mul_(self.decay2)
        m2.add_(t)
        s = torch.sqrt(m2)
        s.add_(1e-8)
        q = m1 / s
        q.mul_(sched[0])
        w.sub_(q)


_UPDATERS = {"sgd": SGDUpdater, "nag": NAGUpdater, "adam": AdamUpdater}


def create_updater(kind: str, param: UpdaterParam, **kwargs) -> Updater:
    """Factory (updater_impl-inl.hpp:18-40 CreateUpdater_)."""
    if kind not in _UPDATERS:
        raise ValueError(f"unknown updater type {kind}")
    return _UPDATERS[kind](param, **kwargs)
