"""The port's LRN (cxxnet_tpu_torch/ops/lrn.py) against the JAX package:
the plain version against ops.nn.lrn (XLA path) and against the Pallas
kernel in interpret mode, every window size 1..7 including the even
ones (where a flipped lo/hi window would show); the CPU dispatcher never
reaching the kernel loader. The backward's plain version
(lrn_bwd_reference, the analytic formula K1-bwd computes) against the
TPU kernel _bwd_kernel in interpret mode, JAX's autodiff of the XLA
path and torch's autodiff of lrn_reference. The CUDA kernels against
their plain versions run on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cxxnet_tpu.ops import nn as jax_nn
from cxxnet_tpu.ops.pallas_lrn import lrn_pallas
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.ops import lrn as lrn_ops
from cxxnet_tpu_torch.ops import nn as port_nn

# the four shapes of tests/test_pallas_lrn.py, an AlexNet-like one and
# a channel count that is not a multiple of 8
SHAPES = [(2, 16, 7, 9), (2, 8, 5, 5), (1, 32, 3, 3), (3, 8, 1, 1),
          (2, 96, 7, 7), (2, 13, 4, 5)]
WINDOWS = [1, 2, 3, 4, 5, 7]
ALPHA, BETA, KNORM = 0.001, 0.75, 1.0

# float32: the same float32 math summed in another order, and torch.pow
# against jnp.power - a few ulp apart (the bar test_pallas_lrn.py holds
# the Pallas kernel to)
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _x(shape, seed=0, scale=4.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _bf16_within_one_ulp(got, ref):
    """Both sides round float32 math to bfloat16: at most one rounding
    boundary apart, i.e. within one bfloat16 ulp (2^-7 relative)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7 + 1e-30)


@pytest.mark.parametrize("n", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_xla(shape, n):
    x = _x(shape)
    want = np.asarray(jax_nn.lrn(jnp.asarray(x), n, ALPHA, BETA, KNORM))
    got = lrn_ops.lrn_reference(torch.from_numpy(x), n, ALPHA, BETA, KNORM)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("n", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_interpret(shape, n):
    x = _x(shape, seed=1)
    want = np.asarray(lrn_pallas(jnp.asarray(x), n, ALPHA, BETA, KNORM,
                                 True))
    got = lrn_ops.lrn_reference(torch.from_numpy(x), n, ALPHA, BETA, KNORM)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("n", [2, 4, 5])
@pytest.mark.parametrize("shape", [(2, 16, 7, 9), (2, 13, 4, 5)])
def test_bf16_within_one_ulp_of_jax(shape, n):
    """bfloat16 in, float32 math, bfloat16 out - as the Pallas kernel
    (interpret mode) does it, and as the XLA path does it on the
    float32-widened input rounded once at the end."""
    xb = torch.from_numpy(_x(shape, seed=2)).to(torch.bfloat16)
    got = lrn_ops.lrn_reference(xb, n, ALPHA, BETA, KNORM)
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    pallas = lrn_pallas(xj, n, ALPHA, BETA, KNORM, True)
    assert pallas.dtype == jnp.bfloat16
    _bf16_within_one_ulp(got.float().numpy(),
                         np.asarray(pallas.astype(jnp.float32)))
    xla = jax_nn.lrn(xj.astype(jnp.float32), n, ALPHA, BETA, KNORM)
    _bf16_within_one_ulp(got.float().numpy(),
                         np.asarray(xla.astype(jnp.bfloat16)
                                    .astype(jnp.float32)))


@pytest.mark.parametrize("n", [2, 4])
def test_even_window_orientation(n):
    """A single lit channel: with lo = n//2 below and hi = n-lo-1 above,
    channel c is normalised by channels [c-lo, c+hi]. A flipped window
    would light the other neighbours."""
    x = np.ones((1, 9, 1, 1), np.float32)
    x[0, 4] = 30.0
    got = lrn_ops.lrn_reference(torch.from_numpy(x), n, 1.0, 1.0, 1.0)
    lo, hi = n // 2, n - n // 2 - 1
    lit = [c for c in range(9) if c - lo <= 4 <= c + hi]
    dim = np.where(got.numpy()[0, :, 0, 0] < 0.1)[0].tolist()
    assert dim == [c for c in lit if c != 4] or dim == lit
    want = np.asarray(jax_nn.lrn(jnp.asarray(x), n, 1.0, 1.0, 1.0))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_zero_knorm_matches_jax():
    """knorm = 0 over an all-zero window: 0 * 0^-beta is nan in both
    (matched, not guarded)."""
    x = _x((1, 8, 3, 3), seed=3)
    x[0, :, 1, 1] = 0.0
    want = np.asarray(jax_nn.lrn(jnp.asarray(x), 3, ALPHA, BETA, 0.0))
    got = lrn_ops.lrn_reference(torch.from_numpy(x), 3, ALPHA, BETA, 0.0)
    assert np.isnan(want[0, :, 1, 1]).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


def test_torch_local_response_norm_is_the_same_window():
    """torch's one-call LRN (the chip-run yardstick, never called by the
    port) pads (n//2, (n-1)//2): the same window, even n included."""
    x = _x((2, 13, 4, 5), seed=4)
    for n in WINDOWS:
        got = lrn_ops.lrn_reference(torch.from_numpy(x), n, ALPHA, BETA,
                                    KNORM)
        lib = F.local_response_norm(torch.from_numpy(x), n, ALPHA, BETA,
                                    KNORM)
        np.testing.assert_allclose(got.numpy(), lib.numpy(), **F32_TOL)


def test_cpu_dispatch_never_touches_kernel_loader(monkeypatch):
    def boom(name):
        raise AssertionError(f"kernel loader reached for {name}")
    monkeypatch.setattr(kernels, "load", boom)
    before = kernels.launches()
    x = torch.from_numpy(_x((2, 16, 7, 9)))
    out = port_nn.lrn(x, 5, ALPHA, BETA, KNORM)
    np.testing.assert_array_equal(
        out.numpy(), lrn_ops.lrn_reference(x, 5, ALPHA, BETA,
                                           KNORM).numpy())
    assert kernels.launches() == before


def test_kernel_wrapper_refuses_cpu_tensor():
    """The kernel wrapper takes CUDA tensors only: a CPU tensor raises
    instead of falling back."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        lrn_ops.lrn(torch.zeros(1, 4, 2, 2), 3, ALPHA, BETA, KNORM)


# ---------------------------------------------------------------------------
# the backward (K1-bwd's plain version, lrn_bwd_reference)
# ---------------------------------------------------------------------------

BWD_WINDOWS = [1, 2, 3, 4, 5, 6, 7]


def _xg(shape, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*shape) * 4.0).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _bwd_ref(x, g, n, knorm=KNORM):
    return lrn_ops.lrn_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                     n, ALPHA, BETA, knorm).numpy()


@pytest.mark.parametrize("n", BWD_WINDOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reference_matches_pallas_vjp_interpret(shape, n):
    """Against the TPU kernel _bwd_kernel itself (jax.vjp of lrn_pallas
    runs it through _vjp_bwd), in interpret mode."""
    x, g = _xg(shape, seed=5)
    _, vjp = jax.vjp(lambda a: lrn_pallas(a, n, ALPHA, BETA, KNORM, True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(_bwd_ref(x, g, n), want, **F32_TOL)


@pytest.mark.parametrize("n", BWD_WINDOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reference_matches_jax_xla_vjp(shape, n):
    """Against JAX's autodiff of the XLA path (ops.nn.lrn)."""
    x, g = _xg(shape, seed=6)
    _, vjp = jax.vjp(lambda a: jax_nn.lrn(a, n, ALPHA, BETA, KNORM),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(_bwd_ref(x, g, n), want, **F32_TOL)


@pytest.mark.parametrize("n", BWD_WINDOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reference_matches_torch_autograd(shape, n):
    """The analytic formula against torch's own autodiff of the plain
    forward - two independent derivations of one gradient."""
    x, g = _xg(shape, seed=7)
    xt = torch.from_numpy(x).requires_grad_(True)
    lrn_ops.lrn_reference(xt, n, ALPHA, BETA, KNORM).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(_bwd_ref(x, g, n), xt.grad.numpy(), **F32_TOL)


@pytest.mark.parametrize("n", [2, 4, 5])
@pytest.mark.parametrize("shape", [(2, 16, 7, 9), (2, 13, 4, 5)])
def test_bwd_bf16_matches_pallas_vjp(shape, n):
    """bfloat16 x and g, float32 math, one rounding to bfloat16 at the
    end - on both sides. Bar: one bfloat16 ulp of the result plus 8
    float32 ulps of the larger of the two terms (the gradient is their
    difference, and the float32 sums run in another order)."""
    x, g = _xg(shape, seed=8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    got = lrn_ops.lrn_bwd_reference(xb, gb, n, ALPHA, BETA, KNORM)
    assert got.dtype == torch.bfloat16
    t1, t2 = lrn_ops.lrn_bwd_terms(xb, gb, n, ALPHA, BETA, KNORM)
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    gj = jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: lrn_pallas(a, n, ALPHA, BETA, KNORM, True),
                     xj)
    want = vjp(gj)[0]
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    bar = (np.abs(want) * 2.0 ** -7
           + 8 * 2.0 ** -23 * np.maximum(t1.abs().numpy(), t2.abs().numpy()))
    assert np.all(np.abs(got.float().numpy() - want) <= bar)


def test_bwd_zero_knorm_nan_matches_jax():
    """knorm = 0 over an all-zero window: 0 * 0^(-beta-1) is nan, in the
    TPU kernel's formula as here (matched, not guarded)."""
    x, g = _xg((1, 8, 3, 3), seed=9)
    x[0, :, 1, 1] = 0.0
    _, vjp = jax.vjp(lambda a: lrn_pallas(a, 3, ALPHA, BETA, 0.0, True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _bwd_ref(x, g, 3, knorm=0.0)
    assert np.isnan(want[0, :, 1, 1]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("n", [2, 4])
def test_bwd_even_window_orientation(n):
    """One lit upstream channel: the reversed window [c-hi, c+lo] sends
    its second term to the channels whose forward window holds it. A
    window not reversed would light the mirrored neighbours."""
    x = np.ones((1, 9, 1, 1), np.float32)
    g = np.zeros((1, 9, 1, 1), np.float32)
    g[0, 4] = 1.0
    got = lrn_ops.lrn_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                    n, 1.0, 1.0, 1.0).numpy()[0, :, 0, 0]
    lo, hi = n // 2, n - n // 2 - 1
    # d out_4 / d x_j is nonzero for the j in channel 4's forward window
    lit = [j for j in range(9) if 4 - lo <= j <= 4 + hi]
    assert np.nonzero(got)[0].tolist() == lit
    _, vjp = jax.vjp(lambda a: jax_nn.lrn(a, n, 1.0, 1.0, 1.0),
                     jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0])[
        0, :, 0, 0], **F32_TOL)


def test_backward_through_lrn_layer_op_matches_pallas_vjp(monkeypatch):
    """Autograd through the CPU op (ops.nn.lrn -> the _LRN Function)
    runs lrn_bwd_reference and matches the TPU kernel's vjp; it never
    reaches the kernel loader and launches nothing."""
    def boom(name):
        raise AssertionError(f"kernel loader reached for {name}")
    monkeypatch.setattr(kernels, "load", boom)
    before = kernels.launches()
    x, g = _xg((2, 96, 7, 7), seed=10)
    xt = torch.from_numpy(x).requires_grad_(True)
    port_nn.lrn(xt, 5, ALPHA, BETA, KNORM).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), _bwd_ref(x, g, 5))
    _, vjp = jax.vjp(lambda a: lrn_pallas(a, 5, ALPHA, BETA, KNORM, True),
                     jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), **F32_TOL)
    assert kernels.launches() == before


def test_backward_kernel_wrapper_refuses_cpu_tensor():
    """K1-bwd's wrapper takes CUDA tensors only: a CPU tensor raises
    instead of falling back to the plain version."""
    z = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lrn_ops.lrn_backward(z, z, 3, ALPHA, BETA, KNORM)


# ---------------------------------------------------------------------------
# the kernels' launch plan (lrn_plan): which block takes which slab
# ---------------------------------------------------------------------------

# AlexNet's LRN inputs at a served batch (b64) and a training step
# (b256), GoogLeNet's ((32, 64, 56, 56), (32, 192, 56, 56)), and the
# ragged shapes of chip_smoke.py's phases 3 and 3b
PLAN_SHAPES = [(64, 96, 27, 27), (64, 256, 13, 13), (256, 96, 27, 27),
               (256, 256, 13, 13), (32, 64, 56, 56), (32, 192, 56, 56),
               (3, 3, 1, 1), (3, 3, 5, 7), (3, 13, 1, 1), (3, 13, 5, 7),
               (2, 40, 3, 3)]
# 41 is wider than the largest chunk (32)
PLAN_WINDOWS = [1, 2, 3, 4, 5, 6, 7, 19, 41]


def _blocks(shape, plan):
    """The (c0, c1, s0, s1) of every block of one image, in the order
    csrc/lrn_slab.cuh:block_of decomposes blockIdx.x."""
    _, c, h, w = shape
    hw = h * w
    chunk, seg = plan["chunk"], plan["seg"]
    nchunks, nsegs = -(-c // chunk), -(-hw // seg)
    for i in range(nchunks * nsegs):
        c0 = (i // nsegs) * chunk
        s0 = (i % nsegs) * seg
        yield c0, min(c0 + chunk, c), s0, min(s0 + seg, hw)


def _slab_rows(c0, c1, channels, n, backward):
    """The channel rows the kernels copy for a chunk [c0, c1), clipped
    to [0, C) (csrc/lrn_fwd.cu, csrc/lrn_bwd.cu): the forward's x over
    the chunk's windows, [c0 - lo, c1 + hi); the backward's g over the
    reversed windows, [c0 - hi, c1 + lo), and x over the windows of
    those g rows, [c0 - lo - hi, c1 + lo + hi)."""
    lo = n // 2
    hi = n - lo - 1
    if not backward:
        return (max(0, c0 - lo), min(channels, c1 + hi)), None
    return ((max(0, c0 - lo - hi), min(channels, c1 + lo + hi)),
            (max(0, c0 - hi), min(channels, c1 + lo)))


def _window(c, below, above, channels):
    return set(range(max(0, c - below), min(channels, c + above + 1)))


@pytest.mark.parametrize("n", PLAN_WINDOWS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_lrn_plan_covers_every_channel_with_its_window(shape, n):
    """Every (channel, position) in exactly one block; each block's x
    rows hold the windows of its chunk (for the backward: g's rows hold
    the reversed windows, x's rows the windows of those g rows - both
    halos); the shared memory the plan asks for holds every block's
    regions and stays within the two-blocks-an-SM budget."""
    b, c, h, w = shape
    hw = h * w
    lo, hi = n // 2, n - n // 2 - 1
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            plan = lrn_ops.lrn_plan(shape, n, dtype, backward)
            assert plan["smem_bytes"] <= lrn_ops.SMEM_BUDGET
            assert plan["smem_bytes"] == lrn_ops.lrn_smem_bytes(
                shape, n, dtype, backward, plan["chunk"], plan["seg"])
            assert 1 <= plan["seg"] <= hw and plan["whole"] == (
                plan["seg"] == hw)
            assert plan["threads"] % 32 == 0
            assert plan["threads"] <= lrn_ops.MAX_THREADS
            seen = np.zeros((c, hw), np.int64)
            blocks = list(_blocks(shape, plan))
            assert plan["blocks"] == b * len(blocks)
            for c0, c1, s0, s1 in blocks:
                seen[c0:c1, s0:s1] += 1
                (x0, x1), grows = _slab_rows(c0, c1, c, n, backward)
                xrows = set(range(x0, x1))
                # this block's regions fit the plan's shared memory
                ch = c1 - c0
                assert lrn_ops.lrn_smem_bytes(
                    shape, n, dtype, backward, ch,
                    plan["seg"]) <= plan["smem_bytes"]
                for cc in range(c0, c1):
                    assert _window(cc, lo, hi, c) <= xrows
                if not backward:
                    assert x1 - x0 <= min(c, plan["chunk"] + n - 1)
                    continue
                gset = set(range(*grows))
                assert grows[1] - grows[0] <= min(c, plan["chunk"] + n - 1)
                assert x1 - x0 <= min(c, plan["chunk"] + 2 * (n - 1))
                for cc in range(c0, c1):
                    assert _window(cc, hi, lo, c) <= gset
                for j in gset:
                    assert _window(j, lo, hi, c) <= xrows
            assert (seen == 1).all()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_plan_cuts_large_rows_into_segments(dtype, backward):
    """H*W so large that one channel row and its halo do not fit: the
    plan cuts H*W into equal segments (loaded row by row) and stays in
    budget; AlexNet's shapes keep the whole of H*W (one range)."""
    shape = (1, 64, 512, 512)
    plan = lrn_ops.lrn_plan(shape, 5, dtype, backward)
    hw = 512 * 512
    assert not plan["whole"] and plan["seg"] < hw
    nseg = -(-hw // plan["seg"])
    assert plan["seg"] * (nseg - 1) < hw <= plan["seg"] * nseg
    assert plan["smem_bytes"] <= lrn_ops.SMEM_BUDGET
    for alex in ((64, 96, 27, 27), (256, 96, 27, 27), (64, 256, 13, 13),
                 (256, 256, 13, 13)):
        assert lrn_ops.lrn_plan(alex, 5, dtype, backward)["whole"]


def test_lrn_plan_takes_a_block_of_shared_memory_only_for_wide_windows():
    """A window over thousands of channels gets up to a block's whole
    shared memory (one block an SM); one whose slab does not fit even
    one channel at one position gets the plan without a slab (seg 0)."""
    plan = lrn_ops.lrn_plan((1, 20000, 1, 1), 20001, torch.bfloat16, True)
    assert lrn_ops.SMEM_BUDGET < plan["smem_bytes"] <= lrn_ops.SMEM_MAX
    assert lrn_ops.lrn_plan((1, 20000, 1, 1), 20001, torch.float32,
                            True)["seg"] == 0


# the direct instances' shapes of tests/test_torch_cuda.py (the forward
# at n = 7501, the backward at n = 2501, over 8000 channels of 4 x 4),
# float32's backward at 20000 channels, and channels enough that a chunk
# of DIRECT_CHUNK would need more than MAX_GRID_Y grid rows
@pytest.mark.parametrize("shape,n,backward,dtype", [
    ((1, 8000, 4, 4), 7501, False, torch.float32),
    ((1, 8000, 4, 4), 7501, False, torch.bfloat16),
    ((1, 8000, 4, 4), 2501, True, torch.float32),
    ((1, 8000, 4, 4), 2501, True, torch.bfloat16),
    ((1, 20000, 1, 1), 20001, True, torch.float32),
    ((3, 600000, 1, 1), 1200001, False, torch.bfloat16)])
def test_lrn_plan_reads_device_memory_where_no_slab_fits(shape, n,
                                                         backward, dtype):
    """Where even one channel at one position of a slab does not fit a
    block's shared memory, the plan has no slab (seg 0, no shared
    memory): a grid row takes `chunk` channels (at most MAX_GRID_Y
    rows), a block DIRECT_THREADS (image, position) columns - every
    channel of every column in one block."""
    b, c, h, w = shape
    plan = lrn_ops.lrn_plan(shape, n, dtype, backward)
    for seg in range(1, h * w + 1):
        assert lrn_ops.lrn_smem_bytes(shape, n, dtype, backward, 1,
                                      seg) > lrn_ops.SMEM_MAX
    assert plan["seg"] == 0 and plan["smem_bytes"] == 0
    assert not plan["whole"]
    assert plan["threads"] == lrn_ops.DIRECT_THREADS
    rows = -(-c // plan["chunk"])
    assert rows <= lrn_ops.MAX_GRID_Y
    assert plan["chunk"] == max(lrn_ops.DIRECT_CHUNK,
                                -(-c // lrn_ops.MAX_GRID_Y))
    assert plan["blocks"] == rows * -(-b * h * w // plan["threads"])


def _by_slabs(x, g, n, alpha, beta, knorm, plan, backward):
    """The plain versions evaluated slab by slab over the plan's blocks
    (all images at once: a block's slab is the same rows of each)."""
    b, c, h, w = x.shape
    x4 = x.reshape(b, c, h * w, 1)
    g4 = None if g is None else g.reshape(b, c, h * w, 1)
    out = torch.full_like(x4, float("nan"))
    for c0, c1, s0, s1 in _blocks(x.shape, plan):
        (x0, x1), grows = _slab_rows(c0, c1, c, n, backward)
        xs = x4[:, x0:x1, s0:s1]
        if not backward:
            r = lrn_ops.lrn_reference(xs, n, alpha, beta, knorm)
        else:
            # g outside the block's g rows is not read: zero it
            gs = torch.zeros_like(xs)
            gs[:, grows[0] - x0:grows[1] - x0] = g4[:, grows[0]:grows[1],
                                                    s0:s1]
            r = lrn_ops.lrn_bwd_reference(xs, gs, n, alpha, beta, knorm)
        out[:, c0:c1, s0:s1] = r[:, c0 - x0:c1 - x0]
    return out.reshape(x.shape)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n", [1, 2, 5, 7, 19])
@pytest.mark.parametrize("shape", [
    (2, 40, 3, 3),      # one range, several chunks
    (3, 13, 5, 7),      # C not a multiple of a chunk
    (2, 9, 120, 120),   # H*W cut into segments
])
def test_slab_by_slab_equals_whole_tensor_bitwise(shape, n, backward):
    """The plain versions on each block's slab give the whole tensor's
    result bitwise (CPU, float32): the plan's halos are the rows the
    math reads. beta = 1 makes every power of the plain versions a
    division (torch's CPU pow rounds a general exponent differently in
    its vector and scalar loops, so an element's place in the tensor
    would move its last bit)."""
    alpha, beta, knorm = 0.01, 1.0, 1.0
    x, g = (torch.from_numpy(a) for a in _xg(shape, seed=11))
    plan = lrn_ops.lrn_plan(shape, n, torch.float32, backward)
    assert plan["whole"] == (shape[2] * shape[3] < 120 * 120)
    if backward:
        want = lrn_ops.lrn_bwd_reference(x, g, n, alpha, beta, knorm)
    else:
        want = lrn_ops.lrn_reference(x, n, alpha, beta, knorm)
    got = _by_slabs(x, g if backward else None, n, alpha, beta, knorm,
                    plan, backward)
    assert torch.equal(got, want)
