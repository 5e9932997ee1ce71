"""Cross-channel LRN: the CUDA kernel K1-fwd and its plain version.

Replaces the TPU kernel `cxxnet_tpu/ops/pallas_lrn.py:_fwd_kernel`
(launched by `_call` -> `pl.pallas_call`, entry `lrn_pallas`). For NCHW
`x`, with lo = n // 2 and hi = n - lo - 1:

    norm_c = knorm + alpha/n * sum_{j in [c-lo, c+hi]} x_j^2
    out_c  = x_c * norm_c^(-beta)

Channels outside [0, C) count as zero. The math is float32; input and
output are float32 or bfloat16 and the output keeps the input's type.

The kernel (`csrc/lrn_fwd.cu`) is bound by memory traffic: one read and
one write per element at a few flops each. Its design keeps every access
coalesced - one thread per (batch, spatial position) column walking the
channels, so neighbouring threads read neighbouring addresses of the
contiguous H*W axis - and re-reads the n-wide window from cache instead
of keeping a subtracting running sum (which drifts in float32).

`lrn` takes a CUDA tensor only and launches the kernel or raises;
`lrn_reference` is the plain PyTorch version that the CPU path
(`ops.nn.lrn`) and the kernel's tests use. The backward kernel belongs
to the training slice: until then `lrn`'s backward raises rather than
returning a silent gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cxxnet_tpu_torch import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lrn_reference(x: torch.Tensor, local_size: int, alpha: float,
                  beta: float, knorm: float) -> torch.Tensor:
    """Plain PyTorch LRN over the channel axis of NCHW `x`: float32 math,
    output in x's dtype."""
    xf = x.float()
    lo = local_size // 2
    hi = local_size - lo - 1
    sq = F.pad(xf * xf, (0, 0, 0, 0, lo, hi))
    c = x.shape[1]
    window = sq[:, 0:c]
    for d in range(1, local_size):
        window = window + sq[:, d:d + c]
    norm = knorm + (alpha / local_size) * window
    return (xf * torch.pow(norm, -beta)).to(x.dtype)


def _launch(x: torch.Tensor, local_size: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError("lrn kernel: x must be a CUDA tensor (the CPU "
                         "path is ops.nn.lrn -> lrn_reference)")
    if x.dim() != 4:
        raise ValueError(f"lrn kernel: x must be NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"lrn kernel: dtype must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("lrn kernel: x must be contiguous")
    if local_size < 1:
        raise ValueError(f"lrn kernel: local_size must be >= 1, "
                         f"got {local_size}")
    lib = kernels.load("lrn_fwd")
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lrn_fwd(x.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
                         b, c, h * w, local_size, alpha / local_size,
                         -beta, knorm, stream)
    kernels.check("lrn_fwd", rc)
    return y


class _LRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, local_size, alpha, beta, knorm):
        return _launch(x, local_size, alpha, beta, knorm)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "LRN backward kernel: training slice, see ROADMAP")


def lrn(x: torch.Tensor, local_size: int, alpha: float, beta: float,
        knorm: float) -> torch.Tensor:
    """LRN through the CUDA kernel: `x` must be a contiguous 4-D CUDA
    tensor of float32 or bfloat16; anything else raises."""
    return _LRN.apply(x, int(local_size), float(alpha), float(beta),
                      float(knorm))
