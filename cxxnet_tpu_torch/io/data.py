"""DataBatch: the host-side batch container (counterpart of
cxxnet_tpu/io/data.py, dense batches only - the sparse CSR view comes
with the iterators that produce it).

Parity with src/io/data.h:79-181: a batch carries host arrays data
(b,c,h,w) and label (b,label_width), the instance indices, and the count
of padding rows in a final short batch (num_batch_padd). The trainer
moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class DataBatch:
    """Batch of instances (data.h:79-181)."""
    data: np.ndarray                       # (b, c, h, w) float32
    label: np.ndarray = None               # (b, label_width) float32
    inst_index: Optional[np.ndarray] = None  # (b,) uint32
    num_batch_padd: int = 0

    @property
    def batch_size(self) -> int:
        return int(self.data.shape[0])
