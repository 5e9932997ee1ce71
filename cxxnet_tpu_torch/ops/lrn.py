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
traffic. A block takes one image and a chunk of channels, copies the
chunk's slab (the chunk and its window's halo, all of H*W: one
contiguous range in NCHW) into shared memory with 16-byte copies,
computes in float32 from there with each window sum added afresh from
a register ring (never a subtracting running sum, which drifts in
float32), and writes the output range back with 16-byte stores
(`csrc/lrn_slab.cuh`). `lrn_plan` picks each launch's chunk, spatial
segment, threads and shared memory; the wrappers pass it to the C
entries. A window over so many channels that no slab fits shared
memory takes the kernels' direct instances, which read device memory.
The backward recomputes norm from x, as the TPU kernel does:
the forward saves only x.

`lrn` takes a CUDA tensor only and launches K1-fwd, and its backward
launches K1-bwd, or raises; `lrn_backward` is K1-bwd's own wrapper.
`lrn_cpu` is the same autograd rule on the CPU with the plain versions,
`lrn_reference` and `lrn_bwd_reference` (the analytic formula above,
not autograd of the forward), which the CPU path (`ops.nn.lrn`) and the
kernels' tests use.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

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


# ---------------------------------------------------------------------------
# the launch plan: which block takes which slab
# ---------------------------------------------------------------------------

# streaming multiprocessors of the H100 SXM: the plan wants two blocks
# for each
SMS = 132
# shared memory a block may ask for so that two share an SM: (228 KB -
# 1 KB the card keeps for each block) / 2
SMEM_BUDGET = 113 * 1024
# a block's dynamic shared memory limit on sm_90 (one block an SM)
SMEM_MAX = 232448
# the window of AlexNet's and GoogLeNet's LRN layers: the one n with a
# kernel instance that knows it at compile time (register rings); every
# other n takes the generic instance
RING_N = 5
# a slab that lets three blocks share an SM: what the plan's first
# choices fit in (on the H100, at AlexNet's shapes, these ran fastest)
SMEM_THREE = 75 * 1024
# channel chunks tried in order (the first that fits three blocks an SM
# and still gives two blocks an SM), then the small ones for wide
# windows and large H*W
CHUNKS = (32, 16, 8)
SMALL_CHUNKS = (8, 4, 2, 1)
MAX_THREADS = 256
# the direct instances (no slab): channels a grid row, threads a block;
# a grid has at most 65535 rows
DIRECT_CHUNK = 8
DIRECT_THREADS = 128
MAX_GRID_Y = 65535


def _align16(v: int) -> int:
    return -(-v // 16) * 16


def lrn_smem_bytes(shape, n: int, dtype: torch.dtype, backward: bool,
                   chunk: int, seg: int) -> int:
    """Shared memory of one block under the plan (chunk, seg): the slab
    regions at the most rows a chunk reaches. A region holds its rows
    as one range (seg = H*W: L bytes, which start up to 16 - size bytes
    past a 16-byte boundary, take align16(L + 16 - size)) or row by row
    (each row at its global alignment mod 16).
    The generic instances (n != RING_N) add the forward's output
    region, and the backward's float32 u and norm^-beta of phase 1.
    The C entries (lrn_fwd_smem, lrn_bwd_smem) compute the same."""
    channels = shape[1]
    hw = shape[2] * shape[3]
    size = 4 if dtype == torch.float32 else 2
    ch = min(chunk, channels)

    def region(rows):
        if seg == hw:
            return _align16(rows * hw * size + 16 - size)
        # a row's pieces (<= seg * size + 30 bytes) at the tensor's row
        # step mod 16
        return _align16(rows * (_align16(seg * size + 30)
                                + hw * size % 16))

    span = n - 1
    generic = n != RING_N
    if not backward:
        need = region(min(channels, ch + span)) + (region(ch) if generic
                                                   else 0)
    else:
        rg = min(channels, ch + span)
        need = (region(min(channels, ch + 2 * span)) + region(rg)
                 + (4 * seg * (rg + ch) if generic else 0))
    return _align16(need)


def _max_seg(shape, n, dtype, backward, chunk, room) -> int:
    """The longest segment shorter than H*W whose row-by-row slab fits
    `room` bytes (0 if not even one position does)."""
    hw = shape[2] * shape[3]
    lo_s, hi_s = 0, hw - 1
    while lo_s < hi_s:
        mid = (lo_s + hi_s + 1) // 2
        if lrn_smem_bytes(shape, n, dtype, backward, chunk, mid) <= room:
            lo_s = mid
        else:
            hi_s = mid - 1
    return lo_s


@functools.lru_cache(maxsize=256)
def lrn_plan(shape: Tuple[int, int, int, int], n: int, dtype: torch.dtype,
             backward: bool) -> Dict[str, int]:
    """The launch plan of K1-fwd (backward=False) or K1-bwd for an NCHW
    `shape`. A block takes one image x `chunk` channels x `seg`
    positions of H*W (H*W itself unless a row and its halo do not fit);
    `blocks` of them; `threads` a block; `smem_bytes` of dynamic shared
    memory (<= SMEM_BUDGET, which lets two blocks share an SM; up to
    SMEM_MAX only where a window is too wide for that). The chunk is the
    first of CHUNKS whose slab lets three blocks share an SM and that
    still gives two blocks an SM; else the largest of SMALL_CHUNKS whose
    slab fits with whole rows or, cutting H*W into equal segments loaded
    row by row, with segments. Where even one channel at one position
    does not fit, `seg` is 0: no slab, the direct instances read every
    window from device memory, one thread an (image, position) column
    and `chunk` channels a grid row."""
    b, channels, h, w = (int(d) for d in shape)
    hw = h * w
    shape = (b, channels, h, w)
    if min(b, channels, hw) == 0:
        return {"chunk": 1, "seg": max(hw, 1), "threads": 32,
                "smem_bytes": 0, "blocks": 0, "whole": 1}

    def fits(ch, seg, room=SMEM_BUDGET):
        return lrn_smem_bytes(shape, n, dtype, backward, ch, seg) <= room

    def blocks(ch, seg):
        return b * -(-channels // ch) * -(-hw // seg)

    chunk, seg = 0, hw
    for cand in CHUNKS:
        ch = min(cand, channels)
        if fits(ch, hw, SMEM_THREE) and blocks(ch, hw) >= 2 * SMS:
            chunk = ch
            break
    # else the largest small chunk whose whole rows fit, or whose rows cut
    # into segments of H*W fit; a window so wide that no slab lets two
    # blocks share an SM gets up to a block's whole shared memory
    for room in (SMEM_BUDGET, SMEM_MAX):
        for cand in SMALL_CHUNKS:
            if chunk:
                break
            ch = min(cand, channels)
            if fits(ch, hw, room):
                chunk = ch
            else:
                cut = _max_seg(shape, n, dtype, backward, ch, room)
                if cut:
                    chunk, seg = ch, cut
    if not chunk:
        chunk = max(DIRECT_CHUNK, -(-channels // MAX_GRID_Y))
        return {"chunk": chunk, "seg": 0, "threads": DIRECT_THREADS,
                "smem_bytes": 0, "whole": 0,
                "blocks": -(-b * hw // DIRECT_THREADS) * -(-channels // chunk)}
    if seg < hw:
        nseg = -(-hw // seg)
        seg = -(-hw // nseg)  # equal segments, none longer than before
    return {"chunk": chunk, "seg": seg,
            "threads": min(MAX_THREADS, -(-seg // 32) * 32),
            "smem_bytes": lrn_smem_bytes(shape, n, dtype, backward, chunk,
                                         seg),
            "blocks": blocks(chunk, seg), "whole": int(seg == hw)}


def _plan_args(x: torch.Tensor, n: int, backward: bool):
    p = lrn_plan(tuple(x.shape), n, x.dtype, backward)
    return p["chunk"], p["seg"], p["threads"], p["smem_bytes"]


def _on_device(x: torch.Tensor, launch):
    """Call `launch(stream)` with the raw handle of x's device's current
    stream. The C entry launches on the current device: only a tensor on
    another card enters a device context."""
    idx = x.device.index
    if idx == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return launch(torch._C._cuda_getCurrentRawStream(idx))


def _launch(x: torch.Tensor, local_size: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    # x passed lrn's _check
    _check_n(local_size, "lrn kernel")
    lib = kernels.load("lrn_fwd")
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    plan = _plan_args(x, local_size, False)
    rc = _on_device(x, lambda stream: lib.lrn_fwd(
        x.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype], b, c, h * w,
        local_size, alpha / local_size, -beta, knorm, *plan, stream))
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
    plan = _plan_args(x, local_size, True)
    rc = _on_device(x, lambda stream: lib.lrn_bwd(
        x.data_ptr(), g.data_ptr(), gin.data_ptr(), _DTYPE_CODE[x.dtype],
        b, c, h * w, local_size, alpha / local_size, -beta,
        2.0 * alpha * beta / local_size, knorm, *plan, stream))
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
