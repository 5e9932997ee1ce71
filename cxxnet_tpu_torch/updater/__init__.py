"""Updaters: SGD / NAG / Adam with the reference's schedule semantics
(cxxnet_tpu/updater counterpart)."""

from cxxnet_tpu_torch.updater.param import UpdaterParam
from cxxnet_tpu_torch.updater.updaters import (
    AdamUpdater, NAGUpdater, SGDUpdater, Updater, create_updater)

__all__ = [
    "UpdaterParam", "Updater", "create_updater",
    "SGDUpdater", "NAGUpdater", "AdamUpdater",
]
