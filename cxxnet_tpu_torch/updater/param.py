"""UpdaterParam: learning-rate/momentum schedules + tag scoping (own copy
of cxxnet_tpu/updater/param.py; src/updater/param.h:13-133).

- params: lr|eta, wd, momentum, clip_gradient, momentum_schedule,
  base/final_momentum, saturation_epoch, lr:schedule|gamma|alpha|step|
  factor|minimum_lr|start_epoch.
- tag scoping: a param set as "<tag>:<name>" (e.g. `wmat:lr`, `bias:wd`)
  only applies to updaters whose tag matches - the prefix is stripped and
  the rest processed normally (param.h:100-105).
- schedules (ScheduleEpoch, param.h:76-94), `epoch` = number of updates:
    constant:  lr = base_lr
    expdecay:  lr = base_lr * gamma^(epoch / step)        (continuous)
    polydecay: lr = base_lr * (1 + (epoch//step)*gamma)^(-alpha)
    factor:    lr = base_lr * factor^(epoch // step)      (integer div)
  then lr clamped to >= minimum_lr; epochs before start_epoch use base_lr.
- momentum schedule: the stateless form of the reference's accumulation
  (evaluated from the current epoch, clamped to final_momentum).

The epoch lives on the host, so the schedule is scalar arithmetic. It is
done in float32 (numpy scalars), as the JAX package evaluates it inside
its jitted step: a float64 schedule would differ from it by float32
rounding (Adam's bias correction 1 - 0.999^t most of all).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_SCHEDULES = {"constant": 0, "expdecay": 1, "polydecay": 2, "factor": 3}

f32 = np.float32


class UpdaterParam:
    def __init__(self, tag: str = ""):
        self.tag = tag
        self.base_lr = 0.01
        self.wd = 0.0
        self.momentum = 0.9
        self.clip_gradient = 0.0
        self.lr_schedule = 0
        self.momentum_schedule = 0
        self.lr_step = 1
        self.lr_gamma = 0.5
        self.lr_alpha = 0.5
        self.lr_factor = 0.1
        self.lr_minimum = 0.00001
        self.start_epoch = 0
        self.base_momentum = 0.5
        self.final_momentum = 0.90
        self.saturation_epoch = 0
        self.silent = 0

    def set_param(self, name: str, val: str) -> None:
        if self.tag and name.startswith(self.tag + ":"):
            name = name[len(self.tag) + 1:]
        if name == "lr" or name == "eta":
            self.base_lr = float(val)
        if name == "wd":
            self.wd = float(val)
        if name == "momentum":
            self.momentum = float(val)
        if name == "silent":
            self.silent = int(val)
        if name == "momentum_schedule":
            self.momentum_schedule = int(val)
        if name == "clip_gradient":
            self.clip_gradient = float(val)
        if name == "final_momentum":
            self.final_momentum = float(val)
        if name == "base_momentum":
            self.base_momentum = float(val)
        if name == "saturation_epoch":
            self.saturation_epoch = int(val)
        for prefix in ("lr:", "eta:"):
            if name.startswith(prefix):
                sub = name[len(prefix):]
                if sub == "schedule":
                    if val in _SCHEDULES:
                        self.lr_schedule = _SCHEDULES[val]
                if sub == "gamma":
                    self.lr_gamma = float(val)
                if sub == "alpha":
                    self.lr_alpha = float(val)
                if sub == "step":
                    self.lr_step = int(val)
                if sub == "factor":
                    self.lr_factor = float(val)
                if sub == "minimum_lr":
                    self.lr_minimum = float(val)
                if sub == "start_epoch":
                    self.start_epoch = int(val)

    # ------------------------------------------------------------------
    def schedule(self, epoch: int) -> Tuple[float, float]:
        """(learning_rate, momentum) at `epoch`, float32 arithmetic."""
        e = f32(epoch)
        if self.lr_schedule == 0:
            lr = f32(self.base_lr)
        elif self.lr_schedule == 1:
            lr = f32(self.base_lr) * np.power(f32(self.lr_gamma),
                                              e / f32(self.lr_step))
        elif self.lr_schedule == 2:
            steps = np.floor(e / f32(self.lr_step))
            lr = f32(self.base_lr) * np.power(
                f32(1.0) + steps * f32(self.lr_gamma), f32(-self.lr_alpha))
        elif self.lr_schedule == 3:
            steps = np.floor(e / f32(self.lr_step))
            lr = f32(self.base_lr) * np.power(f32(self.lr_factor), steps)
        else:
            raise ValueError("unknown schedule type")

        momentum = f32(self.momentum)
        if self.momentum_schedule and self.saturation_epoch:
            momentum = (momentum + f32((self.final_momentum
                                        - self.base_momentum)
                                       / self.saturation_epoch) * e
                        + f32(self.base_momentum))
        momentum = min(momentum, f32(self.final_momentum))
        lr = max(f32(lr), f32(self.lr_minimum))
        if e < f32(self.start_epoch):
            lr = f32(self.base_lr)
        return float(lr), float(momentum)
