"""Pooling forward on NCHW tensors (counterpart of cxxnet_tpu/ops/pooling.py).

Output-size parity: the reference uses a ceil-flavored formula
(pooling_layer-inl.hpp:103-106):

    out = min(in - k + stride - 1, in - 1) // stride + 1

so the last window may be truncated at the boundary. As in the JAX
package the input is padded explicitly - `pad` low, and whatever high
padding makes the window count come out to `out` - with a value neutral
for the reducer (-inf for max, 0 for sum/avg, in the input's dtype), and
then pooled with no implicit padding. torch's own `padding=` cannot be
used: it rejects pad > k/2, where the reference allows any pad < k.
Average pooling divides by the FULL window size ky*kx even for
truncated windows (mshadow pool<sum> scaled by 1/(ky*kx)).

The tie-duplicating max-pool backward belongs to the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool_out_dim(in_dim: int, ksize: int, stride: int, pad: int = 0) -> int:
    """The reference pooling output-size formula (pad is an extension over
    the reference, which has no pooling padding; pad=0 is exact parity)."""
    in_dim = in_dim + 2 * pad
    return min(in_dim - ksize + stride - 1, in_dim - 1) // stride + 1


def _pool_padding(in_dim: int, ksize: int, stride: int, pad: int) -> int:
    """High padding needed so the pool emits pool_out_dim outputs."""
    out = pool_out_dim(in_dim, ksize, stride, pad)
    return max(0, (out - 1) * stride + ksize - (in_dim + pad))


def pool2d(x: torch.Tensor, mode: str, ksize_y: int, ksize_x: int,
           stride: int, pad_y: int = 0, pad_x: int = 0) -> torch.Tensor:
    """Pool an NCHW tensor. mode in {'max', 'sum', 'avg'}."""
    if mode not in ("max", "sum", "avg"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    hi_y = _pool_padding(x.shape[2], ksize_y, stride, pad_y)
    hi_x = _pool_padding(x.shape[3], ksize_x, stride, pad_x)
    fill = float("-inf") if mode == "max" else 0.0
    if pad_y or pad_x or hi_y or hi_x:
        x = F.pad(x, (pad_x, hi_x, pad_y, hi_y), value=fill)
    k = (ksize_y, ksize_x)
    if mode == "max":
        return F.max_pool2d(x, k, stride)
    out = F.avg_pool2d(x, k, stride, divisor_override=1)  # window sums
    if mode == "avg":
        out = out * (1.0 / (ksize_y * ksize_x))
    return out
