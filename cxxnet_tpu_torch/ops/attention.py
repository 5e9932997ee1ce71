"""Scaled-dot-product attention, plain PyTorch: naive, blockwise, and the
online-softmax partial/merge primitives (own copy of
cxxnet_tpu/ops/attention.py).

Layout: [batch, heads, seq, head_dim] (BHSD). Scores and the softmax are
float32 whatever the input dtype; p is cast to v's dtype before p.v (as
the JAX package's naive path feeds the matrix unit), products of the
working type accumulate in float32, and the output takes q's dtype.

A partial is (acc, m, l): unnormalised weighted values, running row max
and running denominator, merged associatively. The ring and Ulysses
routes built on them belong to the parallelism slice; here they serve
`blockwise_attention`, which the CPU tests hold against the kernels'
plain versions (ops/flash_attention.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Finite stand-in for -inf in masked score entries: -inf would give
# inf - inf = nan in the max subtraction. A row whose entries are all
# masked carries l = 0 and is resolved by finalize_partial.
_NEG = -1e30

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    """1/sqrt(head_dim) of the true head_dim, unless given."""
    return (1.0 / (q.shape[-1] ** 0.5)) if scale is None else scale


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of working-type values in float32: products of bfloat16
    values are exact in float32, and the sums are float32 - what
    preferred_element_type=float32 asks of the JAX package's products."""
    return torch.matmul(a.float(), b.float())


def _causal_bias(sq: int, sk: int, q_offset: int, kv_offset: int,
                 device) -> torch.Tensor:
    """(sq, sk) additive bias: 0 where key position <= query position in
    global coordinates, _NEG elsewhere."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = kv_offset + torch.arange(sk, device=device)[None, :]
    return torch.where(kpos <= qpos, 0.0, _NEG)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q.k^T * scale [+ causal mask]).v with the full (sq, sk)
    score matrix materialised: the reference semantics."""
    s = _mm(q, k.transpose(-1, -2)) * _scale(q, scale)
    if causal:
        s = s + _causal_bias(q.shape[2], k.shape[2], 0, 0, q.device)
    p = torch.softmax(s, dim=-1)
    return _mm(p.to(v.dtype), v).to(q.dtype)


def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: Optional[float] = None, causal: bool = False,
                      q_offset: int = 0, kv_offset: int = 0,
                      kv_valid: Optional[int] = None) -> Partial:
    """One K/V block's contribution as an online-softmax partial:
    (acc [B,H,Sq,D] float32 unnormalised, m [B,H,Sq] float32 row max,
    l [B,H,Sq] float32 denominator). Offsets place the blocks on the
    global sequence for the causal mask; `kv_valid` masks key positions
    >= kv_valid (the tail padding of blockwise_attention)."""
    s = _mm(q, k.transpose(-1, -2)) * _scale(q, scale)
    if causal:
        s = s + _causal_bias(q.shape[2], k.shape[2], q_offset, kv_offset,
                             q.device)
    if kv_valid is not None:
        kpos = kv_offset + torch.arange(k.shape[2], device=q.device)
        s = torch.where(kpos < kv_valid, s, _NEG)
    m = s.amax(dim=-1)
    # a fully masked row has p = exp(_NEG - _NEG) = 1: force p = 0 there
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= _NEG * 0.5, 0.0, p)
    l = p.sum(dim=-1)
    acc = torch.matmul(p, v.float())
    return acc, m, l


def merge_partials(a: Partial, b: Partial) -> Partial:
    """Associative merge of two online-softmax partials."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    return (acc_a * ca[..., None] + acc_b * cb[..., None],
            m, l_a * ca + l_b * cb)


def finalize_partial(acc: torch.Tensor, l: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """acc / l, with fully masked rows (l = 0) resolved to 0."""
    safe = torch.where(l > 0, l, 1.0)
    return (acc / safe[..., None]).to(dtype)


def empty_partial(q: torch.Tensor) -> Partial:
    b, h, sq, d = q.shape
    return (torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, sq), _NEG, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, sq), dtype=torch.float32, device=q.device))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_block: int = 512) -> torch.Tensor:
    """Memory-efficient attention: a loop over K/V blocks with the
    online-softmax recurrence; peak score memory is (Sq, kv_block).
    Semantics == naive_attention. A length that is not a multiple of
    kv_block is padded up to one and the tail masked (a divisor would
    degrade to tiny blocks on prime lengths)."""
    sk = k.shape[2]
    kv_block = max(1, min(kv_block, sk))
    pad = (-sk) % kv_block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    kv_valid = sk if pad else None
    part = empty_partial(q)
    for i in range(k.shape[2] // kv_block):
        sl = slice(i * kv_block, (i + 1) * kv_block)
        part = merge_partials(part, attention_partial(
            q, k[:, :, sl], v[:, :, sl], scale=scale, causal=causal,
            kv_offset=i * kv_block, kv_valid=kv_valid))
    acc, _, l = part
    return finalize_partial(acc, l, q.dtype)
