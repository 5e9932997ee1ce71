"""DataInst / SparseInst / DataBatch: the host-side containers
(counterpart of cxxnet_tpu/io/data.py).

Parity with src/io/data.h:41-181: an instance carries its index, its
(c, h, w) image and its label row; a batch carries host arrays data
(b,c,h,w) and label (b,label_width), the instance indices, the count of
padding rows in a final short batch (num_batch_padd), and the extra-data
arrays that `attachtxt` joins on, which feed a net's extra input nodes
in_1..in_k (`extra_data_num`). A batch may instead carry a sparse CSR
view (data.h:96-181: sparse_row_ptr + (findex, fvalue) entries; the
reference's Entry array-of-structs split into parallel index / value
arrays), built by the caller's own iterator. No iterator of the package
produces one. The trainer and the CLI's serve loop densify a CSR batch
on the host to the net's input shape (`to_dense`) and stage it as any
dense batch; nothing computes on the sparse form. All arrays are numpy;
the trainer moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class DataInst:
    """Single instance (data.h:41-56)."""
    index: int
    data: np.ndarray            # (c, h, w)
    label: np.ndarray           # (label_width,)
    extra_data: List[np.ndarray] = field(default_factory=list)


@dataclass
class SparseInst:
    """One row of a sparse batch (data.h:51-72)."""
    index: int
    label: np.ndarray            # (label_width,)
    findex: np.ndarray           # (nnz,) uint32 feature indices
    fvalue: np.ndarray           # (nnz,) float32 feature values

    @property
    def length(self) -> int:
        return int(self.findex.shape[0])


@dataclass
class DataBatch:
    """Batch of instances (data.h:79-181)."""
    data: Optional[np.ndarray] = None      # (b, c, h, w) float32 or uint8
    label: np.ndarray = None               # (b, label_width) float32
    inst_index: Optional[np.ndarray] = None  # (b,) uint32
    num_batch_padd: int = 0
    extra_data: List[np.ndarray] = field(default_factory=list)
    # the sparse CSR view (data.h:96-100): row_ptr[b+1] and parallel
    # entry arrays; `data` is None in a CSR batch
    sparse_row_ptr: Optional[np.ndarray] = None   # (b+1,) int64
    sparse_findex: Optional[np.ndarray] = None    # (nnz,) uint32
    sparse_fvalue: Optional[np.ndarray] = None    # (nnz,) float32

    @property
    def batch_size(self) -> int:
        if self.data is not None:
            return int(self.data.shape[0])
        return int(self.sparse_row_ptr.shape[0]) - 1

    def is_sparse(self) -> bool:
        """data.h:166-168."""
        return self.sparse_row_ptr is not None

    def get_row_sparse(self, rid: int) -> SparseInst:
        """rid'th row of the sparse view (data.h:169-180)."""
        if not self.is_sparse():
            raise ValueError("GetRowSparse on a dense batch")
        a, b = int(self.sparse_row_ptr[rid]), int(
            self.sparse_row_ptr[rid + 1])
        return SparseInst(
            index=int(self.inst_index[rid])
            if self.inst_index is not None else 0,
            label=self.label[rid],
            findex=self.sparse_findex[a:b],
            fvalue=self.sparse_fvalue[a:b])

    def to_dense(self, num_features: int) -> np.ndarray:
        """The CSR view as (b, 1, 1, num_features) float32. Feature
        indices >= num_features are dropped (the net's input shape is
        fixed); an empty row is all zeros."""
        if not self.is_sparse():
            raise ValueError("to_dense on a dense batch")
        b = self.batch_size
        out = np.zeros((b, num_features), np.float32)
        ptr = self.sparse_row_ptr
        rows = np.repeat(np.arange(b), np.diff(ptr))
        cols = self.sparse_findex.astype(np.int64)
        keep = cols < num_features
        out[rows[keep], cols[keep]] = self.sparse_fvalue[keep]
        return out.reshape(b, 1, 1, num_features)

    def densified(self, input_shape) -> "DataBatch":
        """This batch with its CSR view densified to (b,) + input_shape
        (c, y, x), the other fields kept; a dense batch is returned as
        it is (the JAX trainer's densify before padding)."""
        if not self.is_sparse():
            return self
        c, y, x = input_shape
        return DataBatch(
            data=self.to_dense(c * y * x).reshape(self.batch_size, c, y, x),
            label=self.label, inst_index=self.inst_index,
            num_batch_padd=self.num_batch_padd, extra_data=self.extra_data)

    def valid_mask(self) -> np.ndarray:
        """(b,) float mask zeroing the trailing padding rows."""
        b = self.batch_size
        mask = np.ones(b, dtype=np.float32)
        if self.num_batch_padd:
            mask[b - self.num_batch_padd:] = 0.0
        return mask
