"""Carry weights between the JAX package and the port.

Both packages keep params as {param_key: {"wmat": ..., "bias": ...}}
with the same layouts (OIHW conv weights, (nhidden, nin) fullc weights),
so no transpose is needed: a conversion is a type change plus a check.
`params_from_numpy` takes the JAX package's params as numpy arrays (in
tests, `jax.device_get(trainer.state["params"])`); `params_to_numpy`
returns the port's params in the same form. Both check key sets, shapes
and dtypes against what the receiving network expects and raise on any
mismatch.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
