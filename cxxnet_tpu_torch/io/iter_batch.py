"""Instance->batch collation and batch-level prefetch (counterpart of
cxxnet_tpu/io/iter_batch.py).

- BatchAdaptIterator (iter_batch_proc-inl.hpp:16-133): collates DataInst
  into DataBatch; `round_batch=1` wraps to the start to fill the final
  short batch, recording num_batch_padd (and returning False on the next
  round until before_first); round_batch=0 zero-pads instead.
- ThreadBufferIterator (iter_batch_proc-inl.hpp:136-224): double-buffers
  whole batches on a background thread (the ThreadBuffer role).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from cxxnet_tpu_torch.io.data import DataBatch, DataInst
from cxxnet_tpu_torch.io.iterators import DataIter, say
from cxxnet_tpu_torch.io.thread_util import (
    ErrorBox, drain_and_join, stoppable_put)


class BatchAdaptIterator(DataIter):
    def __init__(self, base: DataIter):
        self.base = base
        self.batch_size = 0
        self.label_width = 1
        self.round_batch = 0
        self.num_overflow = 0
        self.test_skipread = 0
        self.silent = 0
        self._head = 1

    def set_param(self, name: str, val: str) -> None:
        self.base.set_param(name, val)
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "label_width":
            self.label_width = int(val)
        if name == "round_batch":
            self.round_batch = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "test_skipread":
            self.test_skipread = int(val)

    def init(self) -> None:
        self.base.init()

    def before_first(self) -> None:
        if self.round_batch == 0 or self.num_overflow == 0:
            self.base.before_first()
        else:
            self.num_overflow = 0
        self._head = 1

    def _collect(self, insts) -> DataBatch:
        # uint8 instances (device_augment raw passthrough) stay uint8:
        # the 1/4-size H2D staging is the point of that mode
        data = np.stack([d.data for d in insts])
        if data.dtype != np.uint8:
            data = data.astype(np.float32, copy=False)
        label = np.zeros((len(insts), self.label_width), dtype=np.float32)
        for i, d in enumerate(insts):
            w = min(self.label_width, len(d.label))
            label[i, :w] = d.label[:w]
        inst_index = np.asarray([d.index for d in insts], dtype=np.uint32)
        extra = []
        if insts[0].extra_data:
            for k in range(len(insts[0].extra_data)):
                extra.append(np.stack([d.extra_data[k] for d in insts]))
        return DataBatch(data=data, label=label, inst_index=inst_index,
                         extra_data=extra)

    def next(self) -> bool:
        # test_skipread: serve the same batch forever after the first read
        if self.test_skipread and not self._head:
            return True
        self._head = 0
        if self.num_overflow:
            return False
        insts = []
        while self.base.next():
            insts.append(self.base.value())
            if len(insts) >= self.batch_size:
                self._out = self._collect(insts)
                return True
        if not insts:
            return False
        top = len(insts)
        if self.round_batch:
            self.base.before_first()
            self.num_overflow = 0
            while len(insts) < self.batch_size:
                if not self.base.next():
                    raise ValueError(
                        "number of inputs must exceed batch size")
                insts.append(self.base.value())
                self.num_overflow += 1
            self._out = self._collect(insts)
            self._out.num_batch_padd = self.num_overflow
        else:
            # zero-pad the short tail
            pad = self.batch_size - top
            template = insts[0]
            for _ in range(pad):
                insts.append(DataInst(
                    index=0,
                    data=np.zeros_like(template.data),
                    label=np.zeros_like(template.label),
                    extra_data=[np.zeros_like(e)
                                for e in template.extra_data]))
            self._out = self._collect(insts)
            self._out.num_batch_padd = pad
        return True

    def value(self) -> DataBatch:
        return self._out


class ThreadBufferIterator(DataIter):
    """Prefetches batches from `base` on a daemon thread."""

    def __init__(self, base: DataIter):
        self.base = base
        self.buffer_size = 2
        self.silent = 0
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()

    def set_param(self, name: str, val: str) -> None:
        self.base.set_param(name, val)
        if name == "buffer_size":
            self.buffer_size = int(val)
        if name == "silent":
            self.silent = int(val)

    def init(self) -> None:
        self.base.init()
        say(self.silent,
            f"ThreadBufferIterator: buffer_size={self.buffer_size}")

    def _producer(self, q: "queue.Queue", stop: threading.Event) -> None:
        try:
            self.base.before_first()
            while not stop.is_set() and self.base.next():
                if not stoppable_put(q, stop, self.base.value()):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in next()
            # a producer failure must surface in the consumer, not
            # masquerade as a clean end-of-data (lock-guarded handoff:
            # the write is published before the sentinel put below)
            self._err.put(e)
        finally:
            stoppable_put(q, stop, None)

    def before_first(self) -> None:
        self._shutdown()
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.buffer_size)
        self._err = ErrorBox()
        self._done = False
        self._thread = threading.Thread(
            target=self._producer, args=(self._q, self._stop), daemon=True)
        self._thread.start()

    def _shutdown(self) -> None:
        if self._thread is not None:
            drain_and_join(self._q, self._thread, self._stop)
            self._thread = None

    def next(self) -> bool:
        if self._q is None:
            self.before_first()
        if self._done:
            # reference ThreadBuffer keeps returning false after EOF;
            # blocking on the dead producer's empty queue would hang
            return False
        item = self._q.get()
        if item is None:
            self._done = True
            exc = self._err.take()
            if exc is not None:
                raise RuntimeError(
                    "ThreadBufferIterator: producer thread failed") \
                    from exc
            return False
        self._out = item
        return True

    def value(self) -> DataBatch:
        return self._out
