"""Data pipeline (counterpart of cxxnet_tpu/io/__init__.py): `iter = <name>`
lines of a config block build the chain (src/io/data.cpp:23-74: base
instance iterators are wrapped in augment + batch adapters); params
following an `iter =` line are applied to the whole current chain.

Iterators: mnist, img, imgbin / imgbinx, threadbuffer, membuffer and
attachtxt, with the transient-IO retry wrapper. Unported routes raise
NotImplementedError naming their key: `use_native = 1` (the native
decoder) and `dist_num_worker > 1` (multi-worker sharding).
"""

from __future__ import annotations

from typing import List, Tuple

from cxxnet_tpu_torch.io.data import DataBatch, DataInst
from cxxnet_tpu_torch.io.iterators import DataIter, RetryIterator


def create_iterator(cfg: List[Tuple[str, str]]) -> DataIter:
    from cxxnet_tpu_torch.io.augment import AugmentIterator
    from cxxnet_tpu_torch.io.iter_batch import (BatchAdaptIterator,
                                                ThreadBufferIterator)
    from cxxnet_tpu_torch.io.iter_extra import (AttachTxtIterator,
                                                DenseBufferIterator)
    from cxxnet_tpu_torch.io.iter_img import ImageBinIterator, ImageIterator
    from cxxnet_tpu_torch.io.iter_mnist import MNISTIterator

    it: DataIter = None
    for name, val in cfg:
        if name == "iter":
            if val == "mnist":
                _base(it, val)
                it = MNISTIterator()
            elif val in ("imgbin", "imgbinx"):
                _base(it, val)
                it = BatchAdaptIterator(
                    AugmentIterator(ImageBinIterator()))
            elif val == "img":
                _base(it, val)
                it = BatchAdaptIterator(AugmentIterator(ImageIterator()))
            elif val == "threadbuffer":
                _over(it, val)
                # the retry must sit UNDER the producer thread: a read
                # error inside the producer surfaces to the consumer as
                # RuntimeError (iter_batch.py next()) with the producer
                # already dead, where no outer retry can help
                it = ThreadBufferIterator(RetryIterator(it))
            elif val == "membuffer":
                _over(it, val)
                it = DenseBufferIterator(it)
            elif val == "attachtxt":
                _over(it, val)
                it = AttachTxtIterator(it)
            elif val == "end":
                break
            else:
                raise ValueError(f"unknown iterator type {val}")
        elif it is not None:
            it.set_param(name, val)
    if it is None:
        raise ValueError("must specify iterator by iter=itername")
    # transient-IO-error retry around the whole chain (iterators.py:
    # RetryIterator; io_retry / io_retry_backoff config keys). A
    # threadbuffer top already carries the retry inside its producer,
    # and retrying a dead producer from outside cannot help - skip the
    # redundant outer wrapper there. Replay the retry keys from the
    # block so they reach the wrapper (set_param forwards down the
    # chain) even though it is created after the block params applied.
    if not isinstance(it, ThreadBufferIterator):
        it = RetryIterator(it)
    for name, val in cfg:
        if name in ("io_retry", "io_retry_backoff", "dist_num_worker"):
            it.set_param(name, val)
        elif name == "iter" and val == "end":
            break
    return it


def _base(it, val: str) -> None:
    if it is not None:
        raise ValueError(f"{val} cannot chain over other iterators")


def _over(it, val: str) -> None:
    if it is None:
        raise ValueError(f"must specify input of {val}")


__all__ = ["DataBatch", "DataInst", "DataIter", "RetryIterator",
           "create_iterator"]
