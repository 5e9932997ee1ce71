"""IIterator base protocol (src/io/data.h:18-38), the transient-IO retry
wrapper and the per-worker shard quota (counterpart of
cxxnet_tpu/io/iterators.py; the fault-injection points of the JAX
package's wrapper are not ported)."""

from __future__ import annotations

import sys
from typing import Generic, TypeVar


T = TypeVar("T")


class DataIter(Generic[T]):
    """SetParam / Init / BeforeFirst / Next / Value protocol."""

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    def value(self) -> T:
        raise NotImplementedError

    # iteration sugar
    def __iter__(self):
        self.before_first()
        while self.next():
            yield self.value()


class RetryIterator(DataIter):
    """Transparent wrapper adding transient-IO-error retry around
    next()/before_first() (utils/fault.retry): a network-mount hiccup
    on a shared dataset costs a backoff, not the training run.

    Config keys (forwarded to the wrapped chain as well):
    - ``io_retry``: attempts per call (default 3; 1 disables retry)
    - ``io_retry_backoff``: initial backoff seconds (default 0.05)

    Only OSError (and subclasses) is considered transient; anything else
    propagates immediately. NOTE a retried next() re-invokes the
    underlying chain, which may skip the batch the failed call was
    assembling - the contract is at-most-once delivery per instance,
    matching the reference's tolerance for dropped tail batches.

    create_iterator puts a RetryIterator at (or, under a threadbuffer,
    directly below) the top of every chain, so it sees every key of the
    block and of the global section."""

    def __init__(self, inner: "DataIter"):
        self.inner = inner
        self.attempts = 3
        self.backoff = 0.05
        self._next = None
        self._bf = None

    def set_param(self, name: str, val: str) -> None:
        if name == "io_retry":
            self.attempts = max(1, int(val))
            self._next = self._bf = None
        elif name == "io_retry_backoff":
            self.backoff = float(val)
            self._next = self._bf = None
        self.inner.set_param(name, val)

    def init(self) -> None:
        self.inner.init()

    def _build(self) -> None:
        from cxxnet_tpu_torch import telemetry
        from cxxnet_tpu_torch.utils.fault import (
            default_on_retry, fault_point, retry)

        def notify(fn, attempt, total, exc, sleep_s):
            # io-scoped retry count beside the global fault.retry
            telemetry.inc("io.retry")
            default_on_retry(fn, attempt, total, exc, sleep_s)

        deco = retry(attempts=self.attempts, backoff=self.backoff,
                     retry_on=(OSError,), on_retry=notify)

        def raw_next():
            fault_point("io.next")
            return self.inner.next()

        def raw_before_first():
            fault_point("io.before_first")
            self.inner.before_first()

        self._next = deco(raw_next)
        self._bf = deco(raw_before_first)

    def before_first(self) -> None:
        if self._bf is None:
            self._build()
        self._bf()

    def next(self) -> bool:
        if self._next is None:
            self._build()
        return self._next()

    def value(self):
        return self.inner.value()

    def __getattr__(self, name):
        # transparent delegation for chain-specific surface (close,
        # labels, handles) so wrapping is invisible to callers
        return getattr(self.inner, name)


def shard_quota(n: int, num_worker: int, rank: int):
    """Equalized per-worker shard accounting shared by the base
    iterators (reference discipline iter_thread_imbin-inl.hpp:189-220,
    tightened for sync SPMD): every worker must serve EXACTLY
    floor(n/num_worker) instances - unequal per-worker batch counts
    would desynchronize the per-batch collectives. A dataset smaller
    than the worker count cannot satisfy that and fails loudly.

    Returns (quota, rank). Callers either slice `rows[rank::nw][:quota]`
    or filter ordinals `ord % nw == rank` counting served up to quota.
    """
    if num_worker <= 1:
        return n, 0
    if n < num_worker:
        raise ValueError(
            f"dataset of {n} instances cannot shard over "
            f"{num_worker} workers (fewer instances than workers)")
    return n // num_worker, rank


def say(silent: int, text: str) -> None:
    """An iterator's progress line on stdout (the JAX package prints the
    same lines through its telemetry layer, which the port has not)."""
    if not silent:
        sys.stdout.write(text + "\n")
