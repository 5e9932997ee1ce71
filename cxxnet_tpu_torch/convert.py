"""Carry weights and training state between the JAX package and the port.

Both packages keep params as {param_key: {"wmat": ..., "bias": ...}}
with the same layouts (OIHW conv weights, (nhidden, nin) fullc weights,
batch_norm's per-channel `slope` and `bias`, the bias layer's `bias`),
so no transpose is needed: a conversion is a type change plus a check.
`params_from_numpy` takes the JAX package's params as numpy arrays (in
tests, `jax.device_get(trainer.state["params"])`); `params_to_numpy`
returns the port's params in the same form. Both check key sets, shapes
and dtypes against what the receiving network expects and raise on any
mismatch. `ustate_from_numpy` / `ustate_to_numpy` do the same for the
updater state, {param_key: {name: {"m"} or {"m1", "m2"}}} - the JAX
trainer's `state["ustate"]` - checked against the receiving trainer's
own state; `train_state_from_numpy` / `train_state_to_numpy` carry a
whole train state (params, ustate and the update counter `epoch`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Shapes = Mapping[str, Mapping[str, tuple]]


def _check(tree: Mapping, expected: Shapes, where: str) -> None:
    if set(tree) != set(expected):
        raise ValueError(
            f"{where}: layer keys differ - missing "
            f"{sorted(set(expected) - set(tree))}, unexpected "
            f"{sorted(set(tree) - set(expected))}")
    for lk, d in tree.items():
        if set(d) != set(expected[lk]):
            raise ValueError(
                f"{where}: {lk} carries {sorted(d)}, expected "
                f"{sorted(expected[lk])}")
        for pn, arr in d.items():
            if tuple(arr.shape) != tuple(expected[lk][pn]):
                raise ValueError(
                    f"{where}: {lk}/{pn} has shape {tuple(arr.shape)}, "
                    f"expected {tuple(expected[lk][pn])}")


def params_from_numpy(tree: Mapping[str, Mapping[str, np.ndarray]],
                      expected: Shapes,
                      device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX-package params (numpy, float32) -> port params (float32
    tensors on `device`), checked against `expected` ({key: {name:
    shape}}, e.g. `Network.param_shapes()`)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for lk, d in tree.items():
        out[lk] = {}
        for pn, arr in d.items():
            a = np.asarray(arr)
            if a.dtype != np.float32:
                raise ValueError(
                    f"params_from_numpy: {lk}/{pn} is {a.dtype}, expected "
                    "float32")
            out[lk][pn] = torch.from_numpy(a.copy()).to(device)
    _check(out, expected, "params_from_numpy")
    return out


def params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]],
                    expected: Shapes) -> Dict[str, Dict[str, np.ndarray]]:
    """Port params (float32 tensors, any device) -> numpy float32 arrays
    in the JAX package's pytree form, checked against `expected`."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for lk, d in params.items():
        out[lk] = {}
        for pn, t in d.items():
            if t.dtype != torch.float32:
                raise ValueError(
                    f"params_to_numpy: {lk}/{pn} is {t.dtype}, expected "
                    "torch.float32")
            out[lk][pn] = t.detach().cpu().numpy().copy()
    _check(out, expected, "params_to_numpy")
    return out


def _leaves(tree: Mapping, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def ustate_from_numpy(tree: Mapping, like: Mapping,
                      device="cpu") -> Dict[str, Any]:
    """JAX-package updater state (nested dicts of float32 numpy arrays)
    -> float32 tensors on `device`, with exactly the structure and
    shapes of `like` (the receiving trainer's own ustate)."""
    want = {p: tuple(t.shape) for p, t in _leaves(like)}
    got = {p: np.asarray(a) for p, a in _leaves(tree)}
    if set(got) != set(want):
        raise ValueError(
            f"ustate_from_numpy: leaves differ - missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    for p, a in got.items():
        if a.dtype != np.float32 or tuple(a.shape) != want[p]:
            raise ValueError(
                f"ustate_from_numpy: {p} is {a.dtype} {tuple(a.shape)}, "
                f"expected float32 {want[p]}")

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(device)
    return build(tree)


def ustate_to_numpy(tree: Mapping) -> Dict[str, Any]:
    """Port updater state -> nested dicts of float32 numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: ustate_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def train_state_to_numpy(trainer) -> Dict[str, Any]:
    """{"params", "ustate", "epoch"} of a port NetTrainer, as numpy, the
    params and updater state whole: under a ZeRO cut (zero_stage >= 1)
    or a model, expert or pipe axis each cut tensor is gathered from the
    ranks' slices, so every rank calls this together."""
    return {"params": params_to_numpy(trainer._whole_params(),
                                      trainer.net.param_shapes()),
            "ustate": ustate_to_numpy(trainer._full_ustate()),
            "epoch": int(trainer.epoch)}


def train_state_from_numpy(trainer, state: Mapping) -> None:
    """Load {"params", "ustate", "epoch"} (e.g. the JAX trainer's state
    through jax.device_get, the updater state whole) into a port
    NetTrainer built from the same conf (a JAX state of any ZeRO stage
    and mesh is whole once device_get has it); each rank keeps its
    model, expert and pipe shards and its ZeRO cut of it (a seq axis cuts
    nothing: its ranks each keep the whole). The gradient accumulator
    and counters start empty."""
    params = params_from_numpy(state["params"], trainer.net.param_shapes(),
                               trainer.device)
    trainer.set_train_state(
        params,
        ustate_from_numpy(state["ustate"], trainer._fresh_ustate(params),
                          trainer.device),
        int(state["epoch"]))
