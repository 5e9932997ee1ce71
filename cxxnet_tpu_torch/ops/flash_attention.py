"""Flash attention: the CUDA kernels K2-fwd / K2-dq / K2-dkv and their
plain versions.

Replaces the TPU kernels of cxxnet_tpu/ops/pallas_attention.py:
`_fwd_kernel` (:90, launched by `_fwd` :138), `_dq_kernel` (:172) and
`_dkv_kernel` (:211), both launched by `_bwd_impl` (:256), and the
custom_vjp `flash_attention` (:312) around them. For q, k, v of layout
(B, H, S, D), with s = q.k^T * scale in float32 and, under `causal`,
entries whose key position exceeds the query position set to -1e30:

    forward  online softmax over key tiles: m, l, acc in float32;
             p = exp(s - m) (0 where masked), l sums the float32 p,
             acc += p.to(v.dtype) . v;  o = acc / l  (q's dtype),
             lse = m + log(l)  (float32, (B, H, S))
    dq       p = exp(s - lse), ds = p * (do . v^T - delta),
             dq = scale * sum_kv ds.to(k.dtype) . k
    dk, dv   dv = sum_q p.to(do.dtype)^T . do,
             dk = scale * sum_q ds.to(q.dtype)^T . q

with delta = rowsum(do * o) in float32. delta stays a torch reduction
here, outside the kernels, as it is outside them in the JAX package
(`_bwd_impl` :262). The `_STAT_LANES` broadcast of lse/delta there is a
Mosaic tiling artifact and is not carried over: both are (B, H, S).
The rounding points above (p and ds rounded to the working type before
their products, l summed from the unrounded p) are where bfloat16
results round; the plain versions round at the same places.

On the card every kernel has two instances, picked by dtype: bfloat16
runs on the tensor cores (wgmma with float32 accumulators,
csrc/attn_tc.cuh), float32 on the CUDA cores, whose float32 products
keep the float32 bar of the plain versions (TF32 would not). A bfloat16
CUDA tensor always takes the tensor-core instance; nothing falls back.

`flash_attention` is the public entry, one autograd Function for both
devices: a CUDA tensor runs the kernels (its backward launches K2-dq
and K2-dkv) or raises; a CPU tensor runs the plain versions
`flash_fwd_reference` and `flash_bwd_reference` (the analytic formula
with p recomputed from lse, not autodiff of the forward; it is
`flash_dq_reference` + `flash_dkv_reference`, one plain version per
kernel). The kernels' own wrappers are `attn_fwd`, `attn_dq` and
`attn_dkv`. Any sequence
length is taken and any head_dim up to 256; a longer head_dim raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.ops.attention import _NEG, _causal_bias, _mm, _scale

MAX_HEAD_DIM = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale):
    """float32 (B, H, Sq, Sk) scores and the causal mask (None when not
    causal)."""
    s = _mm(q, k.transpose(-1, -2)) * scale
    if not causal:
        return s, None
    masked = _causal_bias(q.shape[2], k.shape[2], 0, 0, q.device) < 0
    return torch.where(masked, _NEG, s), masked


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2-fwd: (o in q's dtype, lse float32 (B, H, Sq)),
    over the whole key range at once (one tile of the online softmax)."""
    s, masked = _scores(q, k, causal, _scale(q, scale))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if masked is not None:
        p = torch.where(masked, 0.0, p)
    l = p.sum(dim=-1)
    safe = torch.where(l > 0, l, 1.0)
    o = _mm(p.to(v.dtype), v) / safe[..., None]
    return o.to(q.dtype), m + torch.log(safe)


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in float32, (B, H, S)."""
    return (do.float() * o.float()).sum(dim=-1)


def _p_ds(q, k, v, do, lse, delta, causal, sc):
    """p = exp(s - lse) (0 where masked) and ds = p * (do.v^T - delta),
    float32 (B, H, Sq, Sk)."""
    s, masked = _scores(q, k, causal, sc)
    p = torch.exp(s - lse[..., None])
    if masked is not None:
        p = torch.where(masked, 0.0, p)
    return p, p * (_mm(do, v.transpose(-1, -2)) - delta[..., None])


def flash_dq_reference(q, k, v, do, lse, delta, causal=False, scale=None):
    """Plain PyTorch K2-dq (the arguments of attn_dq): dq in q's dtype."""
    sc = _scale(q, scale)
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, sc)
    return (sc * _mm(ds.to(k.dtype), k)).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal=False, scale=None):
    """Plain PyTorch K2-dkv (the arguments of attn_dkv): (dk, dv) in
    k's and v's dtypes."""
    sc = _scale(q, scale)
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, sc)
    dk = sc * _mm(ds.to(q.dtype).transpose(-1, -2), q)
    dv = _mm(p.to(do.dtype).transpose(-1, -2), do)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2-dq + K2-dkv: (dq, dk, dv), each in its input's
    dtype, from p = exp(s - lse) recomputed - the analytic gradient, not
    autodiff of the forward."""
    delta = flash_delta(o, do)
    dq = flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
    return (dq,) + flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                       scale)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check_qkv(q, k, v, what: str) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA tensor (a CPU "
                             "tensor takes flash_fwd_reference / "
                             "flash_bwd_reference)")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be (B, H, S, D), got "
                             f"{tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v dtypes differ ({q.dtype}, "
                         f"{k.dtype}, {v.dtype})")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if q.device != k.device or q.device != v.device:
        raise ValueError(f"{what}: q, k, v on different devices")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {q.shape[3]} exceeds the "
                         f"kernels' limit of {MAX_HEAD_DIM}")


def _check_like(t: torch.Tensor, shape, dtype, name: str, what: str):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_cuda:
        raise ValueError(f"{what}: {name} must be a CUDA {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _dims(q, k, causal, scale):
    b, h, sq, d = q.shape
    return (b * h, sq, k.shape[2], d, int(bool(causal)),
            float(_scale(q, scale)))


def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = False, scale: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-fwd: (o, lse) for CUDA q (B,H,Sq,D), k and v (B,H,Sk,D) of one
    dtype (float32 or bfloat16); anything else raises."""
    _check_qkv(q, k, v, "attn_fwd kernel")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = kernels.load("attn_fwd")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype],
                          *_dims(q, k, causal, scale), stream)
    kernels.check("attn_fwd", rc)
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, what):
    _check_qkv(q, k, v, what)
    do = _check_like(do, q.shape, q.dtype, "do", what)
    lse = _check_like(lse, q.shape[:3], torch.float32, "lse", what)
    delta = _check_like(delta, q.shape[:3], torch.float32, "delta", what)
    return (q.contiguous(), k.contiguous(), v.contiguous(), do, lse, delta)


def attn_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
            causal: bool = False, scale: Optional[float] = None
            ) -> torch.Tensor:
    """K2-dq: dq for CUDA q/k/v/do (as attn_fwd takes them), lse and
    delta (B,H,Sq) float32."""
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta,
                                        "attn_dq kernel")
    lib = kernels.load("attn_dq")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attn_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         dq.data_ptr(), _DTYPE_CODE[q.dtype],
                         *_dims(q, k, causal, scale), stream)
    kernels.check("attn_dq", rc)
    return dq


def attn_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
             causal: bool = False, scale: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-dkv: (dk, dv) for the same arguments as attn_dq."""
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta,
                                        "attn_dkv kernel")
    lib = kernels.load("attn_dkv")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attn_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype],
                          *_dims(q, k, causal, scale), stream)
    kernels.check("attn_dkv", rc)
    return dk, dv


def tc_plan(name: str, d: int, sq: Optional[int] = None) -> dict:
    """The tile plan of the bfloat16 (tensor-core) instance of `name`
    ("attn_fwd", "attn_dq" or "attn_dkv") at head_dim d, as its C entry
    reports it: DP (d rounded up to a power of two of at least 64),
    threads per block and dynamic shared memory bytes; for attn_fwd also
    the query rows a block owns at `sq` query rows (default: a long
    sequence), since a sequence of at most 64 takes one warpgroup. Needs
    the card's toolchain (it loads the kernel's library)."""
    if name not in ("attn_fwd", "attn_dq", "attn_dkv"):
        raise ValueError(f"tc_plan: no tensor-core plan for {name}")
    lib = kernels.load(name)
    keys = ["dp", "threads", "smem_bytes"]
    if name == "attn_fwd":
        keys.append("rows")
        out = (ctypes.c_int * 4)()
        rc = lib.attn_fwd_plan(int(d), int(1 << 30 if sq is None else sq),
                               out)
    else:
        out = (ctypes.c_int * 3)()
        rc = getattr(lib, f"{name}_plan")(int(d), out)
    if rc != 0:
        raise ValueError(f"tc_plan: {name} takes no head_dim {d}")
    return dict(zip(keys, list(out)))


# ---------------------------------------------------------------------------
# the autograd Function and the public entry
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The custom_vjp of pallas_attention.py:312-335: the forward saves
    (q, k, v, o, lse) - the tensors the kernel read and wrote - and the
    backward recomputes p from lse. The kernels for CUDA tensors, the
    plain versions for CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.is_cuda:
            o, lse = attn_fwd(q, k, v, causal, scale)
        else:
            o, lse = flash_fwd_reference(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.hparams = (causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over a non-contiguous gradient: the kernels
        # take contiguous tensors only
        do = do.contiguous()
        if q.is_cuda:
            delta = flash_delta(o, do)
            dq = attn_dq(q, k, v, do, lse, delta, *ctx.hparams)
            dk, dv = attn_dkv(q, k, v, do, lse, delta, *ctx.hparams)
        else:
            dq, dk, dv = flash_bwd_reference(q, k, v, o, lse, do,
                                             *ctx.hparams)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q.k^T * scale [+ causal mask]).v, semantics ==
    ops.attention.naive_attention: the kernels K2-fwd (and K2-dq, K2-dkv
    in the backward) for CUDA tensors, the plain versions for CPU ones.
    head_dim above 256 raises on either device, so the two agree on what
    they take."""
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {q.shape[-1]} exceeds "
                         f"the kernels' limit of {MAX_HEAD_DIM}")
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 None if scale is None else float(scale))
