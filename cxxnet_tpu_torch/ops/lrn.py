"""Cross-channel LRN: the CUDA kernels K1-fwd / K1-bwd and their plain
versions.

Replaces the TPU kernels `cxxnet_tpu/ops/pallas_lrn.py:_fwd_kernel` and
`_bwd_kernel` (launched by `_call` -> `pl.pallas_call`; the backward
from the custom_vjp rule `_vjp_bwd`). For NCHW `x`, with lo = n // 2
and hi = n - lo - 1:

    norm_c = knorm + alpha/n * sum_{j in [c-lo, c+hi]} x_j^2
    out_c  = x_c * norm_c^(-beta)
    gin_c  = g_c * norm_c^(-beta)
             - (2 alpha beta / n) * x_c * sum_{j in [c-hi, c+lo]} u_j,
    u_j    = g_j * x_j * norm_j^(-beta-1)

Channels outside [0, C) count as zero; the backward's sum runs over the
reversed window. The math is float32; tensors are float32 or bfloat16
and results keep x's type.

Both kernels (`csrc/lrn_fwd.cu`, `csrc/lrn_bwd.cu`) are bound by memory
traffic. Their design keeps every access coalesced - one thread per
(batch, spatial position) column walking a chunk of channels, so
neighbouring threads read neighbouring addresses of the contiguous H*W
axis - and re-reads each window from cache instead of keeping a
subtracting running sum (which drifts in float32). The backward
recomputes norm from x, as the TPU kernel does: the forward saves only
x.

`lrn` takes a CUDA tensor only and launches K1-fwd, and its backward
launches K1-bwd, or raises; `lrn_backward` is K1-bwd's own wrapper.
`lrn_cpu` is the same autograd rule on the CPU with the plain versions,
`lrn_reference` and `lrn_bwd_reference` (the analytic formula above,
not autograd of the forward), which the CPU path (`ops.nn.lrn`) and the
kernels' tests use.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from cxxnet_tpu_torch import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _window_sum(a: torch.Tensor, below: int, above: int) -> torch.Tensor:
    """sum_{j in [c-below, c+above]} a_j over the channel axis of NCHW
    `a`, zero padded."""
    p = F.pad(a, (0, 0, 0, 0, below, above))
    c = a.shape[1]
    s = p[:, 0:c]
    for d in range(1, below + above + 1):
        s = s + p[:, d:d + c]
    return s


def _norm(xf: torch.Tensor, n: int, alpha: float,
          knorm: float) -> torch.Tensor:
    lo = n // 2
    return knorm + (alpha / n) * _window_sum(xf * xf, lo, n - lo - 1)


def lrn_reference(x: torch.Tensor, local_size: int, alpha: float,
                  beta: float, knorm: float) -> torch.Tensor:
    """Plain PyTorch LRN over the channel axis of NCHW `x`: float32 math,
    output in x's dtype."""
    xf = x.float()
    norm = _norm(xf, local_size, alpha, knorm)
    return (xf * torch.pow(norm, -beta)).to(x.dtype)


def lrn_bwd_terms(x: torch.Tensor, g: torch.Tensor, local_size: int,
                  alpha: float, beta: float, knorm: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two float32 terms of the LRN input gradient, (g*norm^-beta,
    (2 alpha beta/n) * x * reversed-window sum of u); their difference is
    the gradient. The kernels' tests scale their tolerance by the
    terms' magnitude, since the gradient is a difference of the two."""
    xf, gf = x.float(), g.float()
    n = local_size
    lo = n // 2
    norm = _norm(xf, n, alpha, knorm)
    u = gf * xf * torch.pow(norm, -beta - 1.0)
    rsum = _window_sum(u, n - lo - 1, lo)  # reversed window [c-hi, c+lo]
    return (gf * torch.pow(norm, -beta),
            (2.0 * alpha * beta / n) * xf * rsum)


def lrn_bwd_reference(x: torch.Tensor, g: torch.Tensor, local_size: int,
                      alpha: float, beta: float,
                      knorm: float) -> torch.Tensor:
    """Plain PyTorch LRN input gradient (the analytic formula, float32
    math), in x's dtype."""
    t1, t2 = lrn_bwd_terms(x, g, local_size, alpha, beta, knorm)
    return (t1 - t2).to(x.dtype)


def _check(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor (the CPU path "
                         "is ops.nn.lrn -> lrn_cpu)")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"{what}: dtype must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")


def _check_n(local_size: int, what: str) -> None:
    if local_size < 1:
        raise ValueError(f"{what}: local_size must be >= 1, "
                         f"got {local_size}")


def _launch(x: torch.Tensor, local_size: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    _check(x, "lrn kernel")
    _check_n(local_size, "lrn kernel")
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


def lrn_backward(x: torch.Tensor, g: torch.Tensor, local_size: int,
                 alpha: float, beta: float, knorm: float) -> torch.Tensor:
    """K1-bwd: the LRN input gradient for contiguous 4-D CUDA tensors x
    and g of one shape and one dtype (float32 or bfloat16); anything
    else raises."""
    _check(x, "lrn_bwd kernel")
    _check(g, "lrn_bwd kernel (g)")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"lrn_bwd kernel: g {tuple(g.shape)} {g.dtype} on {g.device} "
            f"must match x {tuple(x.shape)} {x.dtype} on {x.device}")
    _check_n(local_size, "lrn_bwd kernel")
    lib = kernels.load("lrn_bwd")
    gin = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lrn_bwd(x.data_ptr(), g.data_ptr(), gin.data_ptr(),
                         _DTYPE_CODE[x.dtype], b, c, h * w, local_size,
                         alpha / local_size, -beta,
                         2.0 * alpha * beta / local_size, knorm, stream)
    kernels.check("lrn_bwd", rc)
    return gin


class _LRN(torch.autograd.Function):
    """LRN with the analytic backward: the CUDA kernels for a CUDA
    tensor, the plain versions for a CPU one. Saves only x - the tensor
    the forward read (bfloat16 under dtype = bfloat16)."""

    @staticmethod
    def forward(ctx, x, local_size, alpha, beta, knorm):
        ctx.save_for_backward(x)
        ctx.hparams = (local_size, alpha, beta, knorm)
        if x.is_cuda:
            return _launch(x, local_size, alpha, beta, knorm)
        return lrn_reference(x, local_size, alpha, beta, knorm)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        # autograd may hand over a non-contiguous gradient: the kernel
        # takes contiguous tensors only
        grad = grad.contiguous()
        if x.is_cuda:
            gin = lrn_backward(x, grad, *ctx.hparams)
        else:
            gin = lrn_bwd_reference(x, grad, *ctx.hparams)
        return gin, None, None, None, None


def lrn(x: torch.Tensor, local_size: int, alpha: float, beta: float,
        knorm: float) -> torch.Tensor:
    """LRN through the CUDA kernels: `x` must be a contiguous 4-D CUDA
    tensor of float32 or bfloat16; anything else raises. Its backward
    launches K1-bwd."""
    _check(x, "lrn kernel")
    return _LRN.apply(x, int(local_size), float(alpha), float(beta),
                      float(knorm))


def lrn_cpu(x: torch.Tensor, local_size: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    """The same autograd rule on a CPU tensor, through the plain
    versions."""
    if x.is_cuda:
        raise ValueError("lrn_cpu takes a CPU tensor; a CUDA tensor goes "
                         "to lrn (the kernels)")
    return _LRN.apply(x, int(local_size), float(alpha), float(beta),
                      float(knorm))
