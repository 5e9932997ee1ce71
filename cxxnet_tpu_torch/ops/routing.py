"""Record or replay the discrete decisions of a training step.

Two float32 steps that sum in different orders (the card and the CPU, or
two thread counts) can put a value that lies within rounding of a
decision boundary on different sides of it: a max-pool window whose top
values tie on one leg and not on the other (the ties backward then
credits other positions), or a relu input within rounding of zero (its
gate opens on one leg only). Each such decision moves one whole gradient
element; in GoogLeNet a handful of them moves an early tensor's update
by ~1e-3 of its norm, far above what rounding alone does (~1e-6).

Inside `with Routing():` the ties max-pool backward (ops/pooling.py) and
relu (ops/nn.py) keep each decision under a key (the op's kind and its
order in the forward); inside `with Routing(replay=recorded):` they take
the recorded decision in place of their own and count in `differ` those
they would have made the other way. Replaying one leg's decisions into
another leaves only rounding between two training steps. Outside a
`with`, and without autograd, nothing changes."""

from __future__ import annotations

from typing import Dict, Optional

import torch


class Routing:
    """The discrete decisions of one training step, kept or replayed."""

    active: Optional["Routing"] = None

    def __init__(self, replay: Optional["Routing"] = None):
        self.replay = replay
        self.decisions: Dict[tuple, torch.Tensor] = {}
        self.differ = {"max-pool": 0, "relu": 0}
        self.total = {"max-pool": 0, "relu": 0}
        self._order = {"max-pool": 0, "relu": 0}

    def __enter__(self) -> "Routing":
        if Routing.active is not None:
            raise RuntimeError("a Routing is already active")
        Routing.active = self
        return self

    def __exit__(self, *exc) -> None:
        Routing.active = None

    def next_key(self, kind: str) -> tuple:
        """The key of the next op of `kind` in forward order."""
        self._order[kind] += 1
        return (kind, self._order[kind] - 1)

    def decide(self, key: tuple, own: torch.Tensor) -> torch.Tensor:
        """`own` (this leg's decision tensor), recorded, or replaced by the
        decision recorded under `key`."""
        kind = key[0]
        self.total[kind] += own.numel()
        if self.replay is None:
            self.decisions[key] = own.cpu()
            return own
        want = self.replay.decisions[key].to(own.device)
        if want.shape != own.shape:
            raise ValueError(f"decisions {key}: recorded "
                             f"{tuple(want.shape)}, this leg "
                             f"{tuple(own.shape)} - not the same graph")
        self.differ[kind] += int((want != own).sum())
        return want

    def relu(self, x: torch.Tensor) -> torch.Tensor:
        """max(x, 0) with a recorded or replayed gate. The gate holds the
        derivative in halves - 2 where x > 0, 1 at exactly 0 (the half
        gradient of jnp.maximum), 0 below - and a replayed gate is
        applied as x * gate / 2, which has that derivative."""
        gate = (x > 0).to(torch.int8) * 2 + (x == 0).to(torch.int8)
        gate = self.decide(self.next_key("relu"), gate)
        if self.replay is None:
            return torch.maximum(x, x.new_zeros(()))
        return x * (gate.to(x.dtype) * 0.5)
