"""DataInst / DataBatch: the host-side containers (counterpart of
cxxnet_tpu/io/data.py, dense batches only - the sparse CSR view comes
with the iterators that produce it).

Parity with src/io/data.h:41-181: an instance carries its index, its
(c, h, w) image and its label row; a batch carries host arrays data
(b,c,h,w) and label (b,label_width), the instance indices, the count of
padding rows in a final short batch (num_batch_padd), and the extra-data
arrays that `attachtxt` joins on (the trainer refuses extra_data_num
for now, so they ride along unread). The trainer moves them to the
device.
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
class DataBatch:
    """Batch of instances (data.h:79-181)."""
    data: np.ndarray                       # (b, c, h, w) float32 or uint8
    label: np.ndarray = None               # (b, label_width) float32
    inst_index: Optional[np.ndarray] = None  # (b,) uint32
    num_batch_padd: int = 0
    extra_data: List[np.ndarray] = field(default_factory=list)

    @property
    def batch_size(self) -> int:
        return int(self.data.shape[0])
