"""The port on the card: the CUDA kernels (K1-fwd, K1-bwd, the
flash-attention K2-fwd, K2-dq, K2-dkv, and the int8 dot K3) against
their plain versions, and the serving and training paths through them. Every test here needs an
NVIDIA card and skips without one (marker `cuda`). This file imports no
jax, so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import convert, kernels
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import flash_attention as FA
from cxxnet_tpu_torch.ops import int8 as int8_ops
from cxxnet_tpu_torch.ops import lrn as lrn_ops
from cxxnet_tpu_torch.serve import Server
from torch_port_util import NARROW_ALEXNET, cuda_device  # noqa: F401
from torch_port_util import numpy_keep

ALPHA, BETA, KNORM = 0.001, 0.75, 1.0

pytestmark = pytest.mark.cuda


def _x(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 4.0).astype(
        np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((64, 96, 27, 27), 5),
                                     ((64, 256, 13, 13), 5),
                                     ((3, 13, 5, 7), 2), ((2, 3, 1, 1), 7),
                                     ((3, 13, 1, 1), 4), ((1, 9, 3, 3), 1)])
def test_lrn_kernel_matches_reference(cuda_device, shape, n, dtype):
    """float32: rtol 1e-5 / atol 1e-6 (powf against torch.pow, another
    summation order); bfloat16: within one bfloat16 ulp (both round the
    same float32 math once)."""
    x = torch.from_numpy(_x(shape, 5)).to(cuda_device).to(dtype)
    before = kernels.launches()["lrn_fwd"]
    got = lrn_ops.lrn(x, n, ALPHA, BETA, KNORM)
    torch.cuda.synchronize()
    assert kernels.launches()["lrn_fwd"] == before + 1
    ref = lrn_ops.lrn_reference(x, n, ALPHA, BETA, KNORM)
    assert got.dtype == dtype and got.shape == x.shape
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(g - r) <= np.abs(r) * 2.0 ** -7 + 1e-30)


def test_lrn_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros(2, 8, 4, 4, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        lrn_ops.lrn(x.transpose(2, 3), 3, ALPHA, BETA, KNORM)
    with pytest.raises(ValueError, match="dtype"):
        lrn_ops.lrn(x.half(), 3, ALPHA, BETA, KNORM)
    with pytest.raises(ValueError, match="NCHW"):
        lrn_ops.lrn(x[0], 3, ALPHA, BETA, KNORM)
    # K1-bwd's wrapper refuses the same, a CPU tensor, and a g that
    # does not match x
    g = torch.ones_like(x)
    with pytest.raises(ValueError, match="dtype"):
        lrn_ops.lrn_backward(x.half(), g.half(), 3, ALPHA, BETA, KNORM)
    with pytest.raises(ValueError, match="NCHW"):
        lrn_ops.lrn_backward(x[0], g[0], 3, ALPHA, BETA, KNORM)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lrn_ops.lrn_backward(x.cpu(), g.cpu(), 3, ALPHA, BETA, KNORM)
    with pytest.raises(ValueError, match="must match x"):
        lrn_ops.lrn_backward(x, g.bfloat16(), 3, ALPHA, BETA, KNORM)


def _bwd_close(got, x, g, n):
    """K1-bwd against lrn_bwd_reference. The gradient is the difference
    of two terms, so the bar scales with their magnitude:
    float32 rtol 1e-5 of the result + 1e-6 x (|t1| + |t2|);
    bfloat16 one bfloat16 ulp (2^-7) of the result + the same float32
    term bar (both round float32 math once, and the float32 values may
    sit on either side of a rounding boundary)."""
    ref = lrn_ops.lrn_bwd_reference(x, g, n, ALPHA, BETA, KNORM).float()
    t1, t2 = lrn_ops.lrn_bwd_terms(x, g, n, ALPHA, BETA, KNORM)
    rtol = 1e-5 if x.dtype == torch.float32 else 2.0 ** -7
    bar = rtol * ref.abs() + 1e-6 * (t1.abs() + t2.abs())
    return bool(torch.all((got.float() - ref).abs() <= bar))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((256, 96, 27, 27), 5),
                                     ((256, 256, 13, 13), 5),
                                     ((3, 13, 5, 7), 2), ((2, 3, 1, 1), 7),
                                     ((3, 13, 1, 1), 4), ((1, 9, 3, 3), 1),
                                     ((2, 40, 3, 3), 19)])
def test_lrn_bwd_kernel_matches_reference(cuda_device, shape, n, dtype):
    """K1-bwd at the AlexNet b256 shapes and ragged ones (n = 19 takes
    the wide-window loop), one launch per call; autograd through lrn
    launches it once and gives the same gradient."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(_x(shape, 5)).to(cuda_device).to(dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        cuda_device).to(dtype)
    before = kernels.launches()["lrn_bwd"]
    got = lrn_ops.lrn_backward(x, g, n, ALPHA, BETA, KNORM)
    torch.cuda.synchronize()
    assert kernels.launches()["lrn_bwd"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _bwd_close(got, x, g, n)
    xg = x.clone().requires_grad_(True)
    (gin,) = torch.autograd.grad(lrn_ops.lrn(xg, n, ALPHA, BETA, KNORM), xg,
                                 g)
    assert kernels.launches()["lrn_bwd"] == before + 2
    assert torch.equal(gin, got)


def test_narrow_alexnet_card_matches_cpu_and_serves(cuda_device):
    """Same seed, same weights: the card (float32, TF32 off) and the CPU
    agree to rtol 1e-4 / atol 1e-6 on the softmax rows (summation order
    only); the Server on the card launches the LRN kernel twice per
    dispatched batch (two lrn layers)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = NetTrainer(cfg=NARROW_ALEXNET, device="cuda:0")
    gpu.init_model()
    cpu = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    cpu.init_model()
    data = (np.random.RandomState(0).randn(8, 3, 35, 35) * 3).astype(
        np.float32)
    b = DataBatch(data=data, label=np.zeros((8, 1), np.float32))
    np.testing.assert_allclose(gpu.predict_dist(b), cpu.predict_dist(b),
                               rtol=1e-4, atol=1e-6)
    with Server(gpu, max_batch=8, max_wait_ms=0.0) as srv:
        srv.warmup()
        kernels.reset_launches()
        got = srv.submit(data[:5]).result(timeout=120)
        stats = srv.stats()
    assert kernels.launches()["lrn_fwd"] == 2 * stats["batches"]
    np.testing.assert_allclose(got, cpu.predict_dist(DataBatch(
        data=data[:5], label=np.zeros((5, 1), np.float32))),
        rtol=1e-4, atol=1e-6)


def test_narrow_alexnet_training_step_card_matches_cpu(cuda_device):
    """One SGD step of NARROW_ALEXNET (float32, TF32 off) on the card and
    on the CPU from the same weights, batch and injected dropout masks:
    every updated param within rtol 1e-4 / atol 1e-5 (summation order;
    no max-pool window of this input is near-tied), the loss within
    rtol 1e-5. Each step launches K1-fwd and K1-bwd twice (two lrn
    layers)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = NARROW_ALEXNET + "eta = 0.05\nmomentum = 0.9\nwd = 0.0005\n"
    gpu = NetTrainer(cfg=conf, device="cuda:0")
    gpu.init_model()
    cpu = NetTrainer(cfg=conf, device="cpu")
    cpu.init_model()
    rng = np.random.RandomState(0)
    data = (rng.randn(8, 3, 35, 35) * 3).astype(np.float32)
    label = rng.randint(0, 10, size=(8, 1)).astype(np.float32)
    keep = numpy_keep(cpu, seed=1)
    kernels.reset_launches()
    lg = gpu.update(DataBatch(data=data, label=label), keep=keep)
    torch.cuda.synchronize()
    assert kernels.launches() == {"lrn_fwd": 2, "lrn_bwd": 2, "attn_fwd": 0,
                                  "attn_dq": 0, "attn_dkv": 0,
                                  "int8_mm": 0}
    lc = cpu.update(DataBatch(data=data, label=label), keep=keep)
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    shapes = cpu.net.param_shapes()
    pg = convert.params_to_numpy(gpu.state["params"], shapes)
    pc = convert.params_to_numpy(cpu.state["params"], shapes)
    for lk in pc:
        for pn in pc[lk]:
            np.testing.assert_allclose(pg[lk][pn], pc[lk][pn], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{lk}/{pn}")


# ---------------------------------------------------------------------------
# flash attention: K2-fwd, K2-dq, K2-dkv
# ---------------------------------------------------------------------------

def _attn_close(got, ref, grad=False):
    """A kernel's output against its plain version on the same inputs.
    float32: rtol 1e-5 / atol 1e-5 (rtol 1e-4 / atol 1e-5 for gradients,
    tests/test_pallas_attention.py:65) - summation order only. bfloat16:
    |got - ref| <= 1e-2 |ref| + 1e-2 max|ref| + 1e-5, inside the JAX
    test's 5e-2 (:77); the 1e-5 is float32 cancellation noise where the
    true value is 0 (one visible key). Both round p, ds and the result
    to bfloat16 at the same points, so they differ where a float32 value sits on either side of
    a rounding boundary (one bfloat16 ulp, 2^-8 relative), or where the
    online softmax rounds p against a running max."""
    g, r = got.float(), ref.float()
    if ref.dtype == torch.float32:
        rtol = 1e-4 if grad else 1e-5
        return bool(torch.allclose(g, r, rtol=rtol, atol=1e-5))
    bar = 1e-2 * r.abs() + 1e-2 * r.abs().max() + 1e-5
    return bool(torch.all((g - r).abs() <= bar))


ATTN_CASES = [
    # (B, H, S, D, causal, scale)
    (100, 4, 28, 7, False, None),   # seq_mnist.conf's attention
    (2, 3, 1, 7, True, None),
    (2, 1, 12, 8, False, None),
    (2, 3, 28, 16, True, None),
    (1, 3, 33, 64, True, None),
    (2, 1, 100, 96, False, 0.2),
    (1, 3, 257, 128, True, None),
    (1, 1, 257, 128, False, None),
    (1, 1, 33, 256, True, 0.05),
    (2, 3, 100, 7, True, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,scale", ATTN_CASES)
def test_attention_kernels_match_reference(cuda_device, b, h, s, d, causal,
                                           scale, dtype):
    """K2-fwd (o, lse), K2-dq and K2-dkv against flash_fwd_reference /
    flash_bwd_reference on the same inputs, one launch per call."""
    g = torch.Generator(device=cuda_device).manual_seed(s * 31 + d)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=cuda_device)
                   .to(dtype) for _ in range(4))
    before = kernels.launches()
    o, lse = FA.attn_fwd(q, k, v, causal, scale)
    delta = FA.flash_delta(o, do)
    dq = FA.attn_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = FA.attn_dkv(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert [after[n] - before[n] for n in ("attn_fwd", "attn_dq",
                                           "attn_dkv")] == [1, 1, 1]
    ro, rlse = FA.flash_fwd_reference(q, k, v, causal, scale)
    rdq, rdk, rdv = FA.flash_bwd_reference(q, k, v, o, lse, do, causal,
                                           scale)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (b, h, s)
    assert _attn_close(o, ro)
    assert torch.allclose(lse, rlse, rtol=1e-5, atol=1e-5)
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert got.dtype == dtype, name
        assert _attn_close(got, ref, grad=True), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_gives_the_kernels_bits(cuda_device, dtype):
    """flash_attention's forward and backward are the kernels called
    directly: the same bits, one launch of each per step; a
    non-contiguous upstream gradient is made contiguous first."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(3, 4, 28, 7, generator=g, device=cuda_device)
               .to(dtype) for _ in range(3))
    do = torch.randn(3, 28, 4, 7, generator=g, device=cuda_device).to(
        dtype).transpose(1, 2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels.reset_launches()
    out = FA.flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert (counts["attn_fwd"], counts["attn_dq"], counts["attn_dkv"]) == (
        1, 1, 1)
    o, lse = FA.attn_fwd(q, k, v, True)
    dc = do.contiguous()
    delta = FA.flash_delta(o, dc)
    assert torch.equal(out, o)
    assert torch.equal(leaves[0].grad, FA.attn_dq(q, k, v, dc, lse, delta,
                                                  True))
    dk, dv = FA.attn_dkv(q, k, v, dc, lse, delta, True)
    assert torch.equal(leaves[1].grad, dk)
    assert torch.equal(leaves[2].grad, dv)


# the bfloat16 backward on the tensor cores: every DP bucket (16 .. 256),
# head_dim 7 and 12 (the element load path: rows not a whole number of
# 16-byte pieces), Sq != Sk under both masks, and contiguous views whose
# storage offset breaks 16-byte alignment
TC_CASES = [
    # (B, H, Sq, Sk, D, causal, misaligned)
    (2, 2, 130, 130, 16, False, False),
    (2, 2, 130, 130, 32, True, False),
    (1, 3, 100, 100, 64, False, False),
    (1, 2, 257, 257, 128, True, False),
    (1, 2, 200, 200, 256, False, False),
    (1, 1, 70, 70, 200, True, False),
    (2, 2, 65, 65, 7, True, False),
    (2, 2, 65, 65, 12, False, False),
    (1, 2, 100, 257, 64, False, False),
    (1, 2, 100, 257, 64, True, False),
    (1, 2, 257, 100, 32, True, False),
    (1, 2, 96, 96, 64, False, True),
    (1, 2, 96, 96, 128, True, True),
]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that is a view one element into its
    storage: 2-byte aligned in bfloat16."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("b,h,sq,sk,d,causal,misaligned", TC_CASES)
def test_bf16_backward_kernels_on_the_tensor_cores(cuda_device, b, h, sq,
                                                   sk, d, causal,
                                                   misaligned):
    """K2-dq and K2-dkv in bfloat16 (the tensor-core instances) against
    flash_dq_reference / flash_dkv_reference on the same inputs: one
    launch per call, and a second launch gives the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(sq * 7 + sk + d)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=cuda_device)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=g, device=cuda_device)
            .bfloat16() for _ in range(2))
    if misaligned:
        q, k, v, do = (_misaligned(t) for t in (q, k, v, do))
    o, lse = FA.attn_fwd(q, k, v, causal)
    delta = FA.flash_delta(o, do)
    before = kernels.launches()
    dq = FA.attn_dq(q, k, v, do, lse, delta, causal)
    dk, dv = FA.attn_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert [after[n] - before[n] for n in ("attn_dq", "attn_dkv")] == [1, 1]
    rdq = FA.flash_dq_reference(q, k, v, do, lse, delta, causal)
    rdk, rdv = FA.flash_dkv_reference(q, k, v, do, lse, delta, causal)
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        assert _attn_close(got, ref, grad=True), name
    assert torch.equal(FA.attn_dq(q, k, v, do, lse, delta, causal), dq)
    dk2, dv2 = FA.attn_dkv(q, k, v, do, lse, delta, causal)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_bf16_backward_tile_plans(cuda_device):
    """The tensor-core instances' plans: DP is d rounded up to a power of
    two of at least 64 (one 128-byte swizzle row), 2 warpgroups a block,
    shared memory within a block's 232,448 bytes, and head_dim 257
    refused."""
    for d, dp in ((7, 64), (12, 64), (32, 64), (64, 64), (96, 128),
                  (128, 128), (200, 256), (256, 256)):
        for name in ("attn_dq", "attn_dkv"):
            plan = FA.tc_plan(name, d)
            assert plan["dp"] == dp, (name, d)
            assert plan["threads"] == 256
            assert 0 < plan["smem_bytes"] <= 232448
    with pytest.raises(ValueError, match="head_dim 257"):
        FA.tc_plan("attn_dq", 257)


def test_attention_kernels_refuse_what_they_cannot_take(cuda_device):
    x = torch.zeros(1, 2, 8, 16, device=cuda_device)
    wide = torch.zeros(1, 2, 8, 257, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 257 exceeds"):
        FA.attn_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="head_dim 257 exceeds"):
        FA.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="dtype"):
        FA.attn_fwd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="dtypes differ"):
        FA.attn_fwd(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="do not fit"):
        FA.attn_fwd(x, x[:, :1], x[:, :1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.attn_fwd(x.cpu(), x, x)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="lse must be"):
        FA.attn_dq(x, x, x, x, lse[:, :, :4], lse)
    with pytest.raises(ValueError, match="do must be"):
        FA.attn_dkv(x, x, x, x.bfloat16(), lse, lse)


def test_seq_net_training_step_card_matches_cpu(cuda_device):
    """One step of seq_mnist.conf's net (float32, TF32 off, batch 8) on
    the card and on the CPU from the same weights, batch and dropout
    masks: params within rtol 1e-4 / atol 1e-5, the loss within rtol
    1e-5; the step launches each K2 kernel once, and inference one
    K2-fwd."""
    import os
    torch.backends.cuda.matmul.allow_tf32 = False
    conf_path = os.path.join(os.path.dirname(__file__), "..", "examples",
                             "LongSeq", "seq_mnist.conf")
    with open(conf_path) as f:
        net = "netconfig=start" + f.read().split("netconfig=start", 1)[1]
    conf = (net.replace("batch_size = 100", "batch_size = 8")
            .replace("dtype = bfloat16", "dtype = float32")
            + "\nsilent = 1\nseed = 3\n")
    gpu = NetTrainer(cfg=conf, device="cuda:0")
    gpu.init_model()
    cpu = NetTrainer(cfg=conf, device="cpu")
    cpu.init_model()
    rng = np.random.RandomState(0)
    data = rng.rand(8, 1, 28, 28).astype(np.float32)
    label = rng.randint(0, 10, size=(8, 1)).astype(np.float32)
    keep = numpy_keep(cpu, seed=1)
    kernels.reset_launches()
    lg = gpu.update(DataBatch(data=data, label=label), keep=keep)
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert (counts["attn_fwd"], counts["attn_dq"], counts["attn_dkv"]) == (
        1, 1, 1)
    lc = cpu.update(DataBatch(data=data, label=label), keep=keep)
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    shapes = cpu.net.param_shapes()
    pg = convert.params_to_numpy(gpu.state["params"], shapes)
    pc = convert.params_to_numpy(cpu.state["params"], shapes)
    for lk in pc:
        for pn in pc[lk]:
            np.testing.assert_allclose(pg[lk][pn], pc[lk][pn], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{lk}/{pn}")
    kernels.reset_launches()
    b = DataBatch(data=data, label=label)
    np.testing.assert_allclose(gpu.predict_dist(b), cpu.predict_dist(b),
                               rtol=1e-4, atol=1e-6)
    assert kernels.launches()["attn_fwd"] == 1


# ---------------------------------------------------------------------------
# the int8 dot: K3
# ---------------------------------------------------------------------------

# AlexNet's fullc layers at 64 rows, bench.py's int8 MLP at 16, ragged
# shapes (odd k: rows not 4-byte aligned), a conv im2col GEMM
K3_CASES = [(64, 9216, 4096), (64, 4096, 1000), (16, 512, 2048),
            (16, 2048, 10), (1, 3, 1), (17, 363, 1000), (100, 1201, 1),
            (1936, 363, 96), (33, 1200, 128), (65, 64, 65)]


@pytest.mark.parametrize("m,k,n", K3_CASES)
def test_int8_kernel_matches_reference(cuda_device, m, k, n):
    """Integer sums are exact: K3 equals its plain version bitwise,
    extreme values (all +-127) included, and counts one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(m * 7 + n)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                      device=cuda_device, generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                      device=cuda_device, generator=gen)
    x[0] = 127
    w[0] = -127
    before = kernels.launches()["int8_mm"]
    got = int8_ops.int8_matmul(x, w)
    torch.cuda.synchronize()
    assert kernels.launches()["int8_mm"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int8_ops.int8_matmul_reference(x, w))
    assert int(got[0, 0]) == -127 * 127 * k


def test_int8_conv_route_matches_reference(cuda_device):
    """The im2col route on the card (one K3 launch per group) against the
    same route with the plain GEMM, and against the CPU."""
    gen = np.random.RandomState(3)
    x = torch.from_numpy(gen.randint(-127, 128, (2, 8, 13, 13)).astype(
        np.int8))
    w = torch.from_numpy(gen.randint(-127, 128, (16, 4, 5, 5)).astype(
        np.int8))
    before = kernels.launches()["int8_mm"]
    got = int8_ops.int8_conv2d(x.to(cuda_device), w.to(cuda_device), 1, 2,
                               2, 2)
    torch.cuda.synchronize()
    assert kernels.launches()["int8_mm"] == before + 2
    assert torch.equal(got.cpu(), int8_ops.int8_conv2d(x, w, 1, 2, 2, 2))
    assert torch.equal(got, int8_ops.int8_conv2d_reference(
        x.to(cuda_device), w.to(cuda_device), 1, 2, 2, 2))


def test_int8_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros(4, 32, dtype=torch.int8, device=cuda_device)
    w = torch.zeros(8, 32, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        int8_ops.int8_mm(x.float(), w)
    with pytest.raises(ValueError, match="contiguous"):
        int8_ops.int8_mm(x.t(), w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_ops.int8_mm(x.cpu(), w.cpu())
    with pytest.raises(ValueError, match="share k"):
        int8_ops.int8_mm(x, w[:, :16].contiguous())


def test_int8_kernel_build_failure_raises(cuda_device, monkeypatch,
                                          tmp_path):
    """A K3 that does not build raises; the CUDA path never falls back
    to the plain version."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "int8_mm.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    x = torch.zeros(4, 32, dtype=torch.int8, device=cuda_device)
    before = kernels.launches()["int8_mm"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        int8_ops.int8_matmul(x, x)
    assert kernels.launches()["int8_mm"] == before


def test_narrow_alexnet_int8_card_matches_cpu_and_serves(cuda_device):
    """NARROW_ALEXNET under the int8 passes, float32 (TF32 off), one set
    of calibration statistics on both devices: the card and the CPU
    agree to rtol 1e-3 / atol 1e-6 (an ulp of a float32 layer between
    two int8 products can move one activation across a rounding
    boundary); each inference batch launches K3 3 + 8 times (three
    fullc, eight conv groups), and the Server's rows equal predict's."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = NARROW_ALEXNET + (
        "graph_passes = dead_layer_elim,elim_reshape,fuse_activation,"
        "quantize_int8\n")
    gpu = NetTrainer(cfg=conf, device="cuda:0")
    gpu.init_model()
    cpu = NetTrainer(cfg=conf, device="cpu")
    cpu.init_model()
    data = (np.random.RandomState(0).randn(8, 3, 35, 35) * 3).astype(
        np.float32)
    b = DataBatch(data=data, label=np.zeros((8, 1), np.float32))
    cpu.calibrate_graph_passes(b)
    gpu.set_calibration(*cpu.calibration())
    kernels.reset_launches()
    got = gpu.predict_dist(b)
    torch.cuda.synchronize()
    assert kernels.launches()["int8_mm"] == 11
    np.testing.assert_allclose(got, cpu.predict_dist(b), rtol=1e-3,
                               atol=1e-6)
    with Server(gpu, max_batch=8, max_wait_ms=0.0) as srv:
        rows = srv.submit(data[:5]).result(timeout=120)
    np.testing.assert_array_equal(rows, got[:5])
