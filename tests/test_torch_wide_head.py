"""Attention with heads wider than 256 on the CPU, against the JAX
package: the head dims the TPU kernel takes and the port's kernels take
on their wide route (csrc/attn_*.cu past head_dim 256).

- The kernel functions at head_dim 257, 320 and 512, causal and not:
  the port's public entry `flash_attention` (forward and autograd
  backward) and the plain versions of K2-fwd, K2-dq and K2-dkv, against
  the TPU kernels of cxxnet_tpu/ops/pallas_attention.py in interpret
  mode over 8 x 8 tiles (as tests/test_torch_attention.py runs them),
  the output also against XLA's `blockwise_attention`; float32 at
  tests/test_torch_attention.py's bars (forward rtol / atol 1e-5,
  gradients rtol 1e-4 / atol 1e-5), bfloat16 at
  tests/test_torch_attention_bf16.py's (|got - want| <= 1e-2 |want| +
  1e-2 max|want| + 1e-5).
- The layers of the `wide_head` configuration (chip_smoke.py phase 8f:
  examples/LongSeq/seq_mnist.conf with its block widened to 1,024
  features, two heads of 512) at a reduced size (nlayer 1, batch 4, 16
  steps, float32): the non-causal attention layer and the causal
  transformer_stack alone, from the JAX layers' own init carried by
  cxxnet_tpu_torch/convert.py (output and the vector-Jacobian product
  at tests/test_torch_stack_moe.py's attention bars).
- The seq axis at head_dim 320: ring and Ulysses attention at `mesh =
  seq:2` on two gloo ranks against the JAX trainer at the same mesh,
  three steps from one JAX checkpoint, through the harness of
  tests/test_torch_seq_parallel.py (rtol 2e-4 / atol 2e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.ops import attention as JA
from cxxnet_tpu.ops import pallas_attention as PA
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.ops import flash_attention as FA
from test_torch_seq_parallel import assert_held, run_seq
from test_torch_stack_moe import ATTN_GRAD_TOL, ATTN_OUT_TOL, pair

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def small_blocks(monkeypatch):
    """8 x 8 tiles in the TPU kernels: multi-tile grids at test sizes."""
    monkeypatch.setattr(PA, "BLOCK_Q", 8)
    monkeypatch.setattr(PA, "BLOCK_K", 8)


def _jax_kernels(q, k, v, do, causal, scale):
    """The TPU kernels in interpret mode - o and lse of `_fwd`, (dq, dk,
    dv) of `_bwd_impl` as flash_attention's custom_vjp runs them - and
    blockwise_attention's output, in one jitted program."""
    o, lse = PA._fwd(q, k, v, scale, causal, True)
    grads = PA._bwd_impl(q, k, v, o, lse, do, scale, causal, True)
    return o, lse, grads, JA.blockwise_attention(q, k, v, causal=causal,
                                                 kv_block=8)


_jax_kernels_jit = jax.jit(_jax_kernels, static_argnums=(4, 5))


def _bf16_close(got: torch.Tensor, want) -> bool:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    bar = 1e-2 * np.abs(w) + 1e-2 * np.abs(w).max() + 1e-5
    return bool(np.all(np.abs(g - w) <= bar))


# (d, causal, Sk): every head dim causal and not; Sq = 16, and Sq != Sk
# (the blocks the ring hands the kernels) in two of them
KERNEL_CASES = [(257, False, 16), (257, True, 16), (320, False, 16),
                (320, True, 24), (512, False, 24), (512, True, 16)]


@pytest.mark.parametrize("d,causal,sk", KERNEL_CASES)
def test_wide_head_kernel_functions_match_jax(small_blocks, d, causal, sk):
    """float32: o and lse of flash_fwd_reference, dq of
    flash_dq_reference and dk, dv of flash_dkv_reference, and
    flash_attention's output and autograd gradients (the same plain
    versions), against the TPU kernels in interpret mode (o, lse and the
    gradients of the custom_vjp's backward) and o against
    blockwise_attention."""
    rng = np.random.RandomState(d + sk + causal)
    q, do = (rng.randn(1, 2, 16, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, sk, d).astype(np.float32) for _ in range(2))
    jo, jlse, want, bo = _jax_kernels_jit(*map(jnp.asarray, (q, k, v, do)),
                                          causal, d ** -0.5)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = FA.flash_fwd_reference(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(bo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               **FWD_TOL)
    delta = FA.flash_delta(o, tdo)
    dq = FA.flash_dq_reference(tq, tk, tv, tdo, lse, delta, causal)
    dk, dv = FA.flash_dkv_reference(tq, tk, tv, tdo, lse, delta, causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = FA.flash_attention(*leaves, causal)
    out.backward(tdo)
    assert torch.equal(out.detach(), o)
    for name, got, leaf, w in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                  leaves, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"{name} vs the TPU kernels")
        assert torch.equal(leaf.grad, got), name


@pytest.mark.parametrize("d,causal,sk", KERNEL_CASES[1::2])
def test_wide_head_bf16_rounding_points_match_jax(small_blocks, d, causal,
                                                  sk):
    """bfloat16: the plain versions' rounding points (p and ds rounded
    to bfloat16 as the operands of their products, float32 sums) against
    the TPU kernels in interpret mode, at the wide head dims."""
    rng = np.random.RandomState(1000 + d + sk)
    q, do = (rng.randn(1, 2, 16, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, sk, d).astype(np.float32) for _ in range(2))
    jo, _, want, _ = _jax_kernels_jit(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)), causal,
        d ** -0.5)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = FA.flash_fwd_reference(tq, tk, tv, causal)
    assert o.dtype == torch.bfloat16 and _bf16_close(o, jo)
    delta = FA.flash_delta(o, tdo)
    dq = FA.flash_dq_reference(tq, tk, tv, tdo, lse, delta, causal)
    dk, dv = FA.flash_dkv_reference(tq, tk, tv, tdo, lse, delta, causal)
    for name, got, w in (("dq", dq, want[0]), ("dk", dk, want[1]),
                         ("dv", dv, want[2])):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape, name
        err = np.abs(got.float().numpy() - np.asarray(w, np.float32)).max()
        assert _bf16_close(got, w), f"{name}: max abs {err:.3e}"


@pytest.mark.parametrize("layer,settings", [
    ("attention", [("nhead", "2"), ("causal", "0")]),
    ("transformer_stack", [("nlayer", "1"), ("nhead", "2"),
                           ("nhidden", "4096"), ("causal", "1")]),
])
def test_wide_head_layers_match_jax(layer, settings):
    """wide_head's two attention layers alone at (4, 1, 16, 1024), two
    heads of 512, the JAX layer's params carried into the port by
    convert.params_from_numpy: output and the vector-Jacobian product
    of a seeded cotangent with respect to the input and every param."""
    shape = (4, 1, 16, 1024)
    jl, pl_, jp = pair(layer, settings, shape)
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)

    @jax.jit
    def jax_vjp(p, x, g):
        out, vjp = jax.vjp(lambda p, x: jl.apply(p, [x], train=True)[0],
                           p, x)
        return out, vjp(g)
    jout, (jgp, jgx) = jax_vjp({n: jnp.asarray(a) for n, a in jp.items()},
                               jnp.asarray(x), jnp.asarray(g))
    tp = convert.params_from_numpy(
        {"l": jp}, {"l": pl_.param_shapes([shape])})["l"]
    for t in tp.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = pl_(tp, [tx], train=True)[0]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **ATTN_OUT_TOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               **ATTN_GRAD_TOL, err_msg="dx")
    for n in jp:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jgp[n]),
                                   **ATTN_GRAD_TOL, err_msg=f"d{n}")


# a seq_mnist-like block at 640 features, two heads of 320, on the seq
# axis
WIDE_SEQ_NET = """
netconfig=start
layer[0->1] = pos_embed:pe
layer[1->2,3] = split
layer[2->4] = layernorm:ln1
layer[4->5] = attention:att1
  nhead = 2
  causal = {causal}
  seq_parallel = {sp}
layer[5,3->6] = add
layer[6->7] = flatten
layer[7->8] = fullc:head
  nhidden = 4
layer[8->8] = softmax
netconfig=end
input_shape = 1,8,640
batch_size = 8
eta = 0.05
momentum = 0.9
random_type = xavier
metric = error
"""


@pytest.mark.parametrize("sp,causal", [("ring", 1), ("ulysses", 0)])
def test_wide_head_seq_axis_trains_as_jax(tmp_path, sp, causal):
    """Head dim 320 at mesh = seq:2 (two gloo ranks, one sequence block
    of 4 steps each): three steps of ring (causal: the diagonal block
    masked, the earlier one whole) or Ulysses attention from one JAX
    checkpoint, every rank's params bitwise equal and within the bar of
    the JAX trainer's at the same mesh."""
    cfg = WIDE_SEQ_NET.format(causal=causal, sp=sp)
    _, jp, ports, reps = run_seq(tmp_path, cfg, "seq:2", (1, 8, 640))
    assert_held(jp, ports, reps)
    for rep in reps:
        assert rep["ring_calls"][sp] > 0


def test_bench_attn_takes_a_wide_head(capsys):
    """tools/bench_attn.py at a --shape whose head_dim is past 256: four
    JSON lines (fwd, fwd_bwd; causal and not) at head_dim 257, here
    through the plain versions on the CPU."""
    import json
    from cxxnet_tpu_torch.tools import bench_attn
    assert bench_attn.main(["--shape", "1,1,8,257",
                            "--steps", "1", "--dev", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == 4
    for row in rows:
        assert row["shape"] == [1, 1, 8, 257] and "error" not in row, row
