"""MNIST idx-format iterator (src/io/iter_mnist-inl.hpp:14-156; counterpart
of cxxnet_tpu/io/iter_mnist.py).

Reads the (optionally gzipped) idx files, normalizes to [0,1) by 1/256,
optionally shuffles, serves full batches only (the final partial batch
is dropped, exactly like the reference Next() :63-71). input_flat=1
yields matrix nodes (b,1,1,784); input_flat=0 yields images
(b,1,28,28). Multi-worker sharding (dist_num_worker) belongs to the
parallelism slice and raises.
"""

from __future__ import annotations

import gzip
import struct
import sys

import numpy as np

from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.iterators import DataIter


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, count, rows, cols = struct.unpack(">iiii", f.read(16))
        buf = f.read(count * rows * cols)
    return np.frombuffer(buf, dtype=np.uint8).reshape(count, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, count = struct.unpack(">ii", f.read(8))
        buf = f.read(count)
    return np.frombuffer(buf, dtype=np.uint8)


class MNISTIterator(DataIter):
    def __init__(self) -> None:
        self.mode = 1  # input_flat
        self.inst_offset = 0
        self.silent = 0
        self.shuffle = 0
        self.batch_size = 0
        self.path_img = ""
        self.path_label = ""
        self.seed = 0
        self.loc = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "silent":
            self.silent = int(val)
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "input_flat":
            self.mode = int(val)
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "index_offset":
            self.inst_offset = int(val)
        if name == "path_img":
            self.path_img = val
        if name == "path_label":
            self.path_label = val
        if name == "seed_data":
            self.seed = int(val)
        if name == "dist_num_worker" and int(val) > 1:
            raise NotImplementedError(
                f"dist_num_worker = {val}: sharded iterators are not "
                "ported to cxxnet_tpu_torch yet")

    def init(self) -> None:
        img = _read_idx_images(self.path_img).astype(np.float32) / 256.0
        labels = _read_idx_labels(self.path_label).astype(np.float32)
        inst = np.arange(len(labels), dtype=np.uint32) + self.inst_offset
        if self.shuffle:
            rng = np.random.RandomState(self.seed)
            order = rng.permutation(len(labels))
            img, labels, inst = img[order], labels[order], inst[order]
        if self.mode == 1:
            self.data = img.reshape(len(labels), 1, 1, -1)
        else:
            self.data = img[:, None, :, :]
        self.labels = labels.reshape(-1, 1)
        self.inst = inst
        self.loc = 0
        if not self.silent:
            s = (self.batch_size,) + self.data.shape[1:]
            sys.stdout.write(f"MNISTIterator: load {len(labels)} images, "
                             f"shuffle={self.shuffle}, shape={s}\n")

    def before_first(self) -> None:
        self.loc = 0

    def next(self) -> bool:
        if self.loc + self.batch_size <= self.data.shape[0]:
            s = slice(self.loc, self.loc + self.batch_size)
            self._out = DataBatch(data=self.data[s], label=self.labels[s],
                                  inst_index=self.inst[s])
            self.loc += self.batch_size
            return True
        return False

    def value(self) -> DataBatch:
        return self._out
