"""The attention core of the port on the CPU, against the JAX package:
ops/attention.py (naive, blockwise) and the plain versions of the
flash-attention kernels (ops/flash_attention.py: flash_fwd_reference,
flash_bwd_reference, the autograd Function on a CPU tensor), held to
cxxnet_tpu/ops/attention.py and to the TPU kernels of
cxxnet_tpu/ops/pallas_attention.py run in interpret mode with 8 x 8
tiles (multi-tile grids at these sizes, as tests/test_pallas_attention.py
runs them).

Tolerances (float32 throughout; XLA:CPU and torch sum in other orders,
and the TPU kernels' online softmax rescales per tile):
- forward o and lse: rtol 1e-5 / atol 1e-5 (tests/test_pallas_attention.py
  :38);
- gradients: rtol 1e-4 / atol 1e-5 (tests/test_pallas_attention.py:65);
- bfloat16 naive attention, port vs JAX: rtol 2e-2 / atol 2e-2 (both
  round p and o to bfloat16 once; a value may land one bfloat16 ulp,
  2^-8 relative, apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.ops import attention as JA
from cxxnet_tpu.ops import pallas_attention as PA
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.ops import attention as A
from cxxnet_tpu_torch.ops import flash_attention as FA

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def small_blocks(monkeypatch):
    """8 x 8 tiles in the TPU kernels: multi-tile grids at test sizes."""
    monkeypatch.setattr(PA, "BLOCK_Q", 8)
    monkeypatch.setattr(PA, "BLOCK_K", 8)


def _qkv(b, h, s, d, seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


FWD_CASES = [
    # (s, d, causal, scale)
    (12, 7, False, None), (12, 7, True, None), (16, 8, True, None),
    (28, 7, False, None), (28, 16, True, None), (32, 16, False, None),
    (32, 8, True, 0.5), (16, 7, False, 0.3),
]


@pytest.mark.parametrize("s,d,causal,scale", FWD_CASES)
def test_flash_fwd_reference_matches_jax(small_blocks, s, d, causal, scale):
    """o against JAX's naive_attention and the TPU forward kernel (o and
    lse) in interpret mode."""
    q, k, v = _qkv(2, 3, s, d, seed=s + d)
    o, lse = FA.flash_fwd_reference(*_t(q, k, v), causal, scale)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    naive = JA.naive_attention(jq, jk, jv, causal=causal, scale=scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(naive), **FWD_TOL)
    sc = JA._scale(jq, scale)
    po, plse = PA._fwd(jq, jk, jv, sc, causal, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(po), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(plse)[..., 0],
                               **FWD_TOL)
    # the public entry on a CPU tensor is the same plain version
    got = FA.flash_attention(*_t(q, k, v), causal, scale)
    assert torch.equal(got, o)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, s)


GRAD_CASES = [(16, 8, False, None), (16, 8, True, None),
              (12, 7, True, None), (28, 7, False, None),
              (32, 16, True, 0.5)]


@pytest.mark.parametrize("s,d,causal,scale", GRAD_CASES)
def test_flash_bwd_reference_matches_jax_grads(small_blocks, s, d, causal,
                                               scale):
    """dq, dk, dv of sum(cos(attention)) against jax.grad through the
    naive path and through the TPU kernels (custom_vjp, interpret
    mode), and against torch autodiff of the port's naive_attention."""
    q, k, v = _qkv(1, 2, s, d, seed=3 * s + d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def loss_naive(q, k, v):
        return jnp.sum(jnp.cos(JA.naive_attention(q, k, v, causal=causal,
                                                  scale=scale)))

    def loss_flash(q, k, v):
        return jnp.sum(jnp.cos(PA.flash_attention(q, k, v, causal, scale,
                                                  True)))

    want_naive = jax.grad(loss_naive, argnums=(0, 1, 2))(jq, jk, jv)
    want_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = _t(q, k, v)
    o, lse = FA.flash_fwd_reference(tq, tk, tv, causal, scale)
    do = -torch.sin(o)  # d sum(cos(o)) / do
    got = FA.flash_bwd_reference(tq, tk, tv, o, lse, do, causal, scale)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    torch.cos(A.naive_attention(*leaves, causal=causal, scale=scale)).sum(
        ).backward()
    for name, g, wn, wf, auto in zip("qkv", got, want_naive, want_flash,
                                     leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(wn), **GRAD_TOL,
                                   err_msg=f"d{name} vs jax naive")
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), **GRAD_TOL,
                                   err_msg=f"d{name} vs jax flash")
        np.testing.assert_allclose(g.numpy(), auto.grad.numpy(), **GRAD_TOL,
                                   err_msg=f"d{name} vs torch autodiff")
    # autograd through the public entry runs the same plain backward
    leaves2 = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    torch.cos(FA.flash_attention(*leaves2, causal, scale)).sum().backward()
    for g, leaf in zip(got, leaves2):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("s,kv_block,causal", [
    (28, 5, False), (28, 5, True), (33, 8, True), (12, 512, False),
    (17, 1, True)])
def test_blockwise_matches_naive_and_jax(s, kv_block, causal):
    """Ragged kv_block: pad-and-mask, as the JAX package does."""
    q, k, v = _qkv(2, 2, s, 8, seed=s + kv_block)
    got = A.blockwise_attention(*_t(q, k, v), causal=causal,
                                kv_block=kv_block)
    np.testing.assert_allclose(
        got.numpy(), A.naive_attention(*_t(q, k, v), causal=causal).numpy(),
        **FWD_TOL)
    want = JA.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_partials_merge_like_jax():
    q, k, v = _qkv(1, 2, 6, 4, seed=9)
    parts = []
    for lo, hi in ((0, 3), (3, 6)):
        tk, tv = _t(k[:, :, lo:hi], v[:, :, lo:hi])
        parts.append(A.attention_partial(torch.from_numpy(q), tk, tv,
                                         causal=True, kv_offset=lo))
    acc, m, l = A.merge_partials(A.merge_partials(
        A.empty_partial(torch.from_numpy(q)), parts[0]), parts[1])
    jparts = [JA.attention_partial(jnp.asarray(q), jnp.asarray(k[:, :, lo:hi]),
                                   jnp.asarray(v[:, :, lo:hi]), causal=True,
                                   kv_offset=lo) for lo, hi in ((0, 3), (3, 6))]
    jacc, jm, jl = JA.merge_partials(jparts[0], jparts[1])
    for got, want in ((acc, jacc), (m, jm), (l, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(
        A.finalize_partial(acc, l, torch.float32).numpy(),
        np.asarray(JA.finalize_partial(jacc, jl, jnp.float32)), **FWD_TOL)


def test_naive_bf16_matches_jax():
    q, k, v = _qkv(2, 2, 16, 8, seed=4)
    got = A.naive_attention(*[t.bfloat16() for t in _t(q, k, v)],
                            causal=True)
    want = JA.naive_attention(*[jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)], causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_bf16_reference_rounds_p_to_the_working_type():
    """The plain forward rounds p to v's dtype before p.v and sums l from
    the float32 p - the casting points of the TPU kernel - so in
    bfloat16 it differs from a float32 p.v by bfloat16 rounding only."""
    q, k, v = [t.bfloat16() for t in _t(*_qkv(1, 2, 24, 8, seed=5))]
    o, lse = FA.flash_fwd_reference(q, k, v)
    o32, lse32 = FA.flash_fwd_reference(q.float(), k.float(), v.float())
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse32.numpy(), **FWD_TOL)
    np.testing.assert_allclose(o.float().numpy(), o32.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_kernel_wrappers_refuse_cpu_tensors_and_wide_heads():
    """A CPU tensor never reaches the loader; head_dim over 256 raises on
    either device."""
    q, k, v = _t(*_qkv(1, 1, 4, 8))
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.attn_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.attn_dq(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.attn_dkv(q, k, v, q, lse, lse)
    wide = torch.zeros(1, 1, 4, 257)
    with pytest.raises(ValueError, match="head_dim 257 exceeds"):
        FA.flash_attention(wide, wide, wide)
    for name in ("attn_fwd", "attn_dq", "attn_dkv"):
        assert name in kernels.SOURCES and name in kernels.LAUNCHES
        assert name not in kernels._libs or torch.cuda.is_available()
