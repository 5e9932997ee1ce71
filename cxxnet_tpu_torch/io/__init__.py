"""Data pipeline (counterpart of cxxnet_tpu/io/__init__.py): `iter = <name>`
lines of a config block build the iterator; params following an `iter =`
line apply to it. This slice ports `iter = mnist`; every other iterator
type raises NotImplementedError."""

from __future__ import annotations

from typing import List, Tuple

from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.iterators import DataIter


def create_iterator(cfg: List[Tuple[str, str]]) -> DataIter:
    from cxxnet_tpu_torch.io.iter_mnist import MNISTIterator

    it: DataIter = None
    for name, val in cfg:
        if name == "iter":
            if val == "mnist":
                assert it is None, "mnist cannot chain over other iterators"
                it = MNISTIterator()
            elif val == "end":
                break
            else:
                raise NotImplementedError(
                    f"iter = {val}: this iterator is not ported to "
                    "cxxnet_tpu_torch yet (ported: mnist)")
        elif it is not None:
            it.set_param(name, val)
    if it is None:
        raise ValueError("must specify iterator by iter=itername")
    return it


__all__ = ["DataBatch", "DataIter", "create_iterator"]
