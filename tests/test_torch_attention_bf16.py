"""The bfloat16 rounding points of the flash-attention backward, on the
CPU: the plain versions flash_dq_reference and flash_dkv_reference
(cxxnet_tpu_torch/ops/flash_attention.py) on bfloat16 inputs, held to
the JAX package's TPU kernels _dq_kernel and _dkv_kernel
(cxxnet_tpu/ops/pallas_attention.py) run in interpret mode with 8-row
tiles, through jax.vjp of flash_attention, on the same numpy-seeded
inputs. The tensor-core kernels K2-dq and K2-dkv (csrc/attn_dq.cu,
csrc/attn_dkv.cu) are held to these plain versions on the card, so
this pins what they must compute: p and ds rounded to bfloat16 as the
operands of their products, float32 sums, the result rounded once.

Tolerance, the bfloat16 bar of chip_smoke.py's attn_close:
|got - want| <= 1e-2 |want| + 1e-2 max|want| + 1e-5. Both sides round
p, ds and the result to bfloat16 at the same points; they part where a
float32 value (lse from the online softmax against the whole-row one,
a per-tile scale against one at the end) sits on either side of a
rounding boundary, one bfloat16 ulp (2^-8 relative) apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.ops import pallas_attention as PA
from cxxnet_tpu_torch.ops import flash_attention as FA


@pytest.fixture
def small_blocks(monkeypatch):
    """8-row tiles in the TPU kernels: multi-tile grids at test sizes."""
    monkeypatch.setattr(PA, "BLOCK_Q", 8)
    monkeypatch.setattr(PA, "BLOCK_K", 8)


def _bf16_close(got: torch.Tensor, want: np.ndarray) -> bool:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    bar = 1e-2 * np.abs(w) + 1e-2 * np.abs(w).max() + 1e-5
    return bool(np.all(np.abs(g - w) <= bar))


BF16_GRAD_CASES = [
    # (sq, sk, d, causal, scale)
    (24, 24, 7, False, None), (24, 24, 7, True, None),
    (16, 16, 16, False, 0.3), (32, 32, 16, True, None),
    (32, 32, 64, False, None), (24, 24, 64, True, None),
    (16, 24, 16, False, None), (16, 24, 16, True, None),
]


@pytest.mark.parametrize("sq,sk,d,causal,scale", BF16_GRAD_CASES)
def test_bf16_dq_dkv_references_match_jax_kernels(small_blocks, sq, sk, d,
                                                  causal, scale):
    rng = np.random.RandomState(1000 + 7 * sq + sk + d)
    q, do = (rng.randn(1, 2, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, sk, d).astype(np.float32) for _ in range(2))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jo, vjp = jax.vjp(
        lambda a, b, c: PA.flash_attention(a, b, c, causal, scale, True),
        jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = FA.flash_fwd_reference(tq, tk, tv, causal, scale)
    assert _bf16_close(o, jo)
    delta = FA.flash_delta(o, tdo)
    dq = FA.flash_dq_reference(tq, tk, tv, tdo, lse, delta, causal, scale)
    dk, dv = FA.flash_dkv_reference(tq, tk, tv, tdo, lse, delta, causal,
                                    scale)
    for name, got, w in (("dq", dq, want[0]), ("dk", dk, want[1]),
                         ("dv", dv, want[2])):
        assert got.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert got.shape == w.shape, name
        err = np.abs(got.float().numpy() - np.asarray(w, np.float32)).max()
        assert _bf16_close(got, w), f"{name}: max abs {err:.3e}"


def test_bf16_references_round_p_and_ds_before_their_products():
    """The rounding points themselves: on bfloat16 inputs dq, dk, dv equal
    the float32 formula with p and ds rounded to bfloat16 before the
    products and the float32 result rounded once - bitwise."""
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 20, 12).astype(
        np.float32)).bfloat16() for _ in range(4))
    o, lse = FA.flash_fwd_reference(q, k, v, True)
    delta = FA.flash_delta(o, do)
    sc = 12 ** -0.5
    s = q.float() @ k.float().transpose(-1, -2) * sc
    mask = torch.ones(20, 20).triu(1).bool()
    p = torch.where(mask, 0.0, torch.exp(torch.where(mask, -1e30, s)
                                         - lse[..., None]))
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    want_dq = (sc * (ds.bfloat16().float() @ k.float())).bfloat16()
    want_dk = (sc * (ds.bfloat16().float().transpose(-1, -2)
                     @ q.float())).bfloat16()
    want_dv = (p.bfloat16().float().transpose(-1, -2)
               @ do.float()).bfloat16()
    assert torch.equal(FA.flash_dq_reference(q, k, v, do, lse, delta, True),
                       want_dq)
    dk, dv = FA.flash_dkv_reference(q, k, v, do, lse, delta, True)
    assert torch.equal(dk, want_dk)
    assert torch.equal(dv, want_dv)
