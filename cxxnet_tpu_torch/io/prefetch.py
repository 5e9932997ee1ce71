"""Staged prefetch: the trainer's staging of batch k+1 runs on a worker
thread while step k runs (counterpart of cxxnet_tpu/io/prefetch.py).

The reference hides disk/decode latency behind compute with a generic
two-semaphore double buffer (utils/thread_buffer.h:22-202) and a
batch-level ThreadBufferIterator (iter_batch_proc-inl.hpp:136-224). At
the host->device edge the analogous stall is the per-step pad + cast +
copy of the next batch, which serializes after step k unless it runs on
its own thread.

StagedPrefetcher wraps any DataIter and runs the trainer's one staging
function (NetTrainer.stage_batch: pad, host cast or not by stage_dtype,
copy to the device) on a worker thread, `depth` batches ahead. value()
yields StagedBatch objects, which NetTrainer.update() consumes with no
per-step host work. Trajectory-identical to streaming the DataBatches
(a streamed update is one stage_batch call; the random streams fold on
the step counter, not on wall time).

On a CUDA device the worker owns a PinnedRing: `depth + 1` slots of
pinned host buffers, allocated once and reused (pinning a 79 MB batch
costs milliseconds), from which the copies are issued non_blocking on a
side CUDA stream; an event recorded after them is the StagedBatch's
`ready`, which update() makes the current stream wait on before it
calls record_stream on the staged tensors (so the caching allocator
keeps their memory until the step that reads them is done). A slot is
written again only after its previous copy's event has completed. A
failure to pin raises. On the CPU there is no host-to-device step: the
worker stages on its thread and nothing is pinned.

Fused dispatch (steps_per_dispatch = K): chunk = K makes the worker
assemble K staged batches into one StagedChunk (chunk_fn, the trainer's
stage_chunk, stacking on the ring's side stream) per queue item; the
last item of a pass may be a SHORT chunk. Device memory then holds
K * (depth + 1) batches.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch

from cxxnet_tpu_torch.io.thread_util import drain_and_join

_END = object()


class PinnedSlot:
    """One slot of a PinnedRing: its pinned host buffers (by position,
    reallocated only when a batch's shape or dtype changes) and the
    event of its last copy."""

    def __init__(self, ring: "PinnedRing"):
        self.ring = ring
        self.bufs: Dict[int, torch.Tensor] = {}
        self.done: Optional[torch.cuda.Event] = None

    def fill(self, i: int, arr: np.ndarray, dtype: torch.dtype
             ) -> torch.Tensor:
        """Buffer i, holding `arr` converted to `dtype` (one host pass:
        the cast is the copy into pinned memory)."""
        buf = self.bufs.get(i)
        if buf is None or buf.shape != arr.shape or buf.dtype != dtype:
            buf = self.bufs[i] = torch.empty(arr.shape, dtype=dtype,
                                             pin_memory=True)
        buf.copy_(torch.from_numpy(arr))
        return buf

    def release(self) -> torch.cuda.Event:
        """Record the slot's copies (issued on the ring's stream) as
        done-when; returns the event the consumer waits on."""
        ev = torch.cuda.Event()
        ev.record(self.ring.stream)
        self.done = ev
        return ev


class PinnedRing:
    """`slots` reusable PinnedSlots and the side stream their copies go
    on. Used by one staging thread at a time."""

    def __init__(self, slots: int, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._slots = [PinnedSlot(self) for _ in range(slots)]
        self._pos = 0

    def acquire(self) -> PinnedSlot:
        """The next slot, once its previous copy has completed."""
        slot = self._slots[self._pos]
        self._pos = (self._pos + 1) % len(self._slots)
        if slot.done is not None:
            slot.done.synchronize()
        return slot


class StagedPrefetcher:
    """DataIter-protocol wrapper: before_first()/next()/value(), where
    value() returns the staged (device-resident) batch. stage_fn(batch,
    ring) is NetTrainer.stage_batch; source is any DataIter yielding
    DataBatches. Up to depth+1 staged batches are resident at once
    (depth queued plus the one the worker holds while the queue is
    full), each holding its device buffers until consumed - budget
    device memory for depth+1, not depth."""

    def __init__(self, stage_fn, source, depth: int = 1,
                 device="cpu", chunk: int = 1, chunk_fn=None):
        self.stage_fn = stage_fn
        self.source = source
        self.depth = max(1, int(depth))
        self.chunk = max(1, int(chunk))
        if self.chunk > 1 and chunk_fn is None:
            raise ValueError("chunk > 1 requires chunk_fn")
        self.chunk_fn = chunk_fn
        self.device = torch.device(device)
        self._ring: Optional[PinnedRing] = None
        self._q = None
        self._thread = None
        self._stop = threading.Event()
        self._cur = None
        self._exhausted = False
        self._closed = False
        self._pending_error = None

    # -- DataIter protocol -------------------------------------------------
    def before_first(self) -> None:
        self._shutdown()
        # restarting the pass abandons any undelivered worker error
        # (the rewind re-reads the same data; a persistent fault will
        # re-raise on this pass)
        self._pending_error = None
        self.source.before_first()
        if self.device.type == "cuda" and self._ring is None:
            self._ring = PinnedRing(self.depth + 1, self.device)
        self._q = queue.Queue(maxsize=self.depth)
        self._stop.clear()
        self._exhausted = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="staged-prefetch", daemon=True)
        self._thread.start()

    def next(self) -> bool:
        if self._closed:
            # close() is terminal for the current pass: a stray next()
            # from a consumer's cleanup path must not silently rewind
            # the source and resurrect a worker nothing will close
            return False
        if self._q is None:
            self.before_first()
        if self._exhausted:
            # the worker put ONE _END and exited; a blocking get here
            # would hang forever
            return False
        while True:
            try:
                # the timeout exists only as the dead-worker sweep: a
                # healthy worker always delivers a batch, _END, or its
                # exception
                item = self._q.get(timeout=2.0)
                break
            except queue.Empty:
                if self._thread is not None and self._thread.is_alive():
                    continue
                # worker died without delivering a batch, _END, or an
                # exception: one last race-free sweep, then fail
                # instead of hanging forever
                try:
                    item = self._q.get_nowait()
                    break
                except queue.Empty:
                    self._exhausted = True
                    raise RuntimeError(
                        "staged-prefetch worker died without delivering "
                        "a batch or an error; the data pipeline is gone "
                        "(see stderr for the worker's traceback)")
        if item is _END:
            self._exhausted = True
            return False
        if isinstance(item, BaseException):
            # the worker exits after putting its exception; a caller
            # that catches it and calls next() again must get False,
            # not a hang on a dead producer's queue
            self._exhausted = True
            raise item
        self._cur = item
        return True

    def value(self):
        return self._cur

    def close(self) -> None:
        """Stop the worker and drop queued staged batches. REQUIRED
        when abandoning a pass mid-stream (consumer error): the worker
        otherwise spins in _put holding staged batches - device memory
        - alive for the life of the process. Terminal for the pass:
        next() returns False until before_first() reopens. Idempotent.

        A worker exception still queued (the consumer stopped before
        next() could deliver it) is raised here rather than swallowed -
        unless close() is itself running from an exception handler, in
        which case the in-flight error wins and the worker's is noted
        on stderr."""
        self._shutdown()
        self._closed = True
        err, self._pending_error = self._pending_error, None
        if err is not None:
            if sys.exc_info()[1] is None:
                raise err
            sys.stderr.write(
                f"staged-prefetch: worker error superseded by the "
                f"consumer's: {type(err).__name__}: {err}\n")

    # -- worker ------------------------------------------------------------
    def _put(self, item) -> bool:
        """Bounded put that stays responsive to _shutdown (a plain
        blocking put would deadlock against a consumer that stopped
        consuming)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # graftlint: hot-path (the staging worker: no host syncs here)
    def _run(self) -> None:
        try:
            pending = []
            while not self._stop.is_set() and self.source.next():
                staged = self.stage_fn(self.source.value(), self._ring)
                if self.chunk <= 1:
                    if not self._put(staged):
                        return
                    continue
                pending.append(staged)
                if len(pending) >= self.chunk:
                    # the singles are released before the (possibly
                    # long) put: holding them through a full queue
                    # would keep K more batches on the device
                    item = self.chunk_fn(pending, self._ring)
                    pending = []
                    if not self._put(item):
                        return
            if pending and not self._stop.is_set():
                # the pass ended mid-chunk: a SHORT chunk trains the
                # tail this round
                item = self.chunk_fn(pending, self._ring)
                pending = []
                if not self._put(item):
                    return
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised in next()
            self._put(e)

    def _shutdown(self) -> None:
        if self._thread is None:
            return
        # bounded drain-while-join (thread_util): a worker stuck outside
        # q.put fails loudly after the timeout instead of hanging the
        # trainer; drained worker exceptions are kept, not discarded
        def keep_error(item):
            if (isinstance(item, BaseException)
                    and self._pending_error is None):
                self._pending_error = item

        drain_and_join(self._q, self._thread, self._stop,
                       on_item=keep_error)
        self._q = None
        self._thread = None
