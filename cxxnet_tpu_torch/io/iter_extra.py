"""DenseBufferIterator (`membuffer`) and AttachTxtIterator (`attachtxt`)
(counterpart of cxxnet_tpu/io/iter_extra.py).

- membuffer (iter_mem_buffer-inl.hpp:16-77): caches the first max_nbatch
  batches in RAM and serves only those from then on.
- attachtxt (iter_attach_txt-inl.hpp:15-101): joins per-instance side
  features from a text table into batch.extra_data by inst_index.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.iterators import DataIter, say


class DenseBufferIterator(DataIter):
    def __init__(self, base: DataIter):
        self.base = base
        self.max_nbatch = 0
        self.silent = 0
        self._cache: List[DataBatch] = []
        self._filled = False
        self._pos = 0

    def set_param(self, name: str, val: str) -> None:
        self.base.set_param(name, val)
        if name == "max_nbatch":
            self.max_nbatch = int(val)
        if name == "silent":
            self.silent = int(val)

    def init(self) -> None:
        self.base.init()
        if self.max_nbatch <= 0:
            raise ValueError("membuffer requires max_nbatch > 0")

    def before_first(self) -> None:
        self._pos = 0
        if not self._filled:
            # restarting mid-fill: refill from scratch to avoid duplicates
            self._cache = []
            self.base.before_first()

    def next(self) -> bool:
        if not self._filled:
            if (len(self._cache) < self.max_nbatch and self.base.next()):
                b = self.base.value()
                self._cache.append(DataBatch(
                    data=b.data.copy(), label=b.label.copy(),
                    inst_index=None if b.inst_index is None
                    else b.inst_index.copy(),
                    num_batch_padd=b.num_batch_padd,
                    extra_data=[e.copy() for e in b.extra_data]))
                self._out = self._cache[-1]
                self._pos = len(self._cache)
                return True
            self._filled = True
        if self._pos < len(self._cache):
            self._out = self._cache[self._pos]
            self._pos += 1
            return True
        return False

    def value(self) -> DataBatch:
        return self._out


class AttachTxtIterator(DataIter):
    """Joins a text table `index feat...` into batch.extra_data."""

    def __init__(self, base: DataIter):
        self.base = base
        self.filename = ""
        self.silent = 0
        self._table: Dict[int, np.ndarray] = {}
        self._width = 0

    def set_param(self, name: str, val: str) -> None:
        self.base.set_param(name, val)
        if name == "filename":
            self.filename = val
        if name == "silent":
            self.silent = int(val)

    def init(self) -> None:
        self.base.init()
        with open(self.filename, "r", encoding="utf-8") as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                idx = int(float(toks[0]))
                feats = np.asarray([float(t) for t in toks[1:]],
                                   dtype=np.float32)
                self._table[idx] = feats
                self._width = max(self._width, len(feats))
        say(self.silent, f"AttachTxtIterator: {len(self._table)} rows of "
                         f"width {self._width}")

    def before_first(self) -> None:
        self.base.before_first()

    def next(self) -> bool:
        if not self.base.next():
            return False
        b = self.base.value()
        extra = np.zeros((b.batch_size, 1, 1, self._width),
                         dtype=np.float32)
        for i, idx in enumerate(b.inst_index):
            row = self._table.get(int(idx))
            if row is not None:
                extra[i, 0, 0, :len(row)] = row
        self._out = DataBatch(
            data=b.data, label=b.label, inst_index=b.inst_index,
            num_batch_padd=b.num_batch_padd,
            extra_data=b.extra_data + [extra])
        return True

    def value(self) -> DataBatch:
        return self._out
