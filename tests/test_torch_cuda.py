"""The port on the card: the CUDA kernels (K1-fwd, K1-bwd, the
flash-attention K2-fwd, K2-dq, K2-dkv, and the int8 dot K3) against
their plain versions, and the serving and training paths through them
(AlexNet-shaped, seq_mnist, GoogLeNet.conf and stack_moe.conf steps
against the CPU), and the native image decoder (nvJPEG and its kernel
YccToRgb) against PIL and its plain versions, and sparse CSR batches
against their dense batches. Every test here needs an
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
from cxxnet_tpu_torch.ops.routing import Routing
from cxxnet_tpu_torch.serve import Server
from torch_port_util import NARROW_ALEXNET, cuda_device  # noqa: F401
from torch_port_util import numpy_keep

ALPHA, BETA, KNORM = 0.001, 0.75, 1.0

pytestmark = pytest.mark.cuda


def _x(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 4.0).astype(
        np.float32)


# the slab cases of both kernels: GoogLeNet's even H*W (56 x 56; row by
# row segments where a row and its halo do not fit), C below the halo,
# C not a multiple of the chunk, batch 1, windows wider than the chunk
# (generic instance) and H*W cut into many segments
SLAB_CASES = [((32, 64, 56, 56), 5), ((32, 192, 56, 56), 5),
              ((3, 2, 4, 4), 7), ((2, 40, 3, 3), 5), ((1, 96, 27, 27), 5),
              ((2, 40, 3, 3), 41), ((2, 70, 5, 5), 9),
              ((1, 16, 300, 300), 3)]
# windows over so many channels that no slab fits shared memory: the
# direct instances (the plan's seg 0), forward and backward
NO_SLAB_FWD = ((1, 8000, 4, 4), 7501)
NO_SLAB_BWD = ((1, 8000, 4, 4), 2501)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((64, 96, 27, 27), 5),
                                     ((64, 256, 13, 13), 5),
                                     ((3, 13, 5, 7), 2), ((2, 3, 1, 1), 7),
                                     ((3, 13, 1, 1), 4), ((1, 9, 3, 3), 1)]
                         + SLAB_CASES + [NO_SLAB_FWD])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 5, 19])
def test_lrn_kernels_on_a_view_off_16_byte_alignment(cuda_device, n, dtype):
    """x[1:] of a (2, 13, 5, 7) tensor: a contiguous view whose base is
    2 (bfloat16) or 4 (float32) bytes past a 16-byte boundary. Both
    kernels copy its slab in 16-byte pieces from the aligned address
    below and write a fresh (aligned) output: the same bars as above."""
    base = torch.from_numpy(_x((2, 13, 5, 7), 7)).to(cuda_device).to(dtype)
    x = base[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = lrn_ops.lrn(x, n, ALPHA, BETA, KNORM)
    torch.cuda.synchronize()
    ref = lrn_ops.lrn_reference(x, n, ALPHA, BETA, KNORM)
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(g - r) <= np.abs(r) * 2.0 ** -7 + 1e-30)
    gbase = torch.from_numpy(_x((2, 13, 5, 7), 8) / 4).to(cuda_device).to(
        dtype)
    up = gbase[1:]
    gin = lrn_ops.lrn_backward(x, up, n, ALPHA, BETA, KNORM)
    torch.cuda.synchronize()
    assert _bwd_close(gin, x, up, n)


@pytest.mark.parametrize("name", ["lrn_fwd", "lrn_bwd"])
def test_lrn_plan_matches_the_c_entries(cuda_device, name):
    """lrn_plan's shared memory is what the C entry computes for the
    same plan, and the C entry refuses a plan given less."""
    lib = kernels.load(name)
    smem = getattr(lib, f"{name}_smem")
    backward = name == "lrn_bwd"
    for shape, n in [((256, 96, 27, 27), 5), ((64, 256, 13, 13), 5),
                     ((32, 192, 56, 56), 5), ((2, 40, 3, 3), 41),
                     ((3, 2, 4, 4), 7), ((1, 16, 300, 300), 3)]:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            p = lrn_ops.lrn_plan(shape, n, dtype, backward)
            hw = shape[2] * shape[3]
            assert smem(code, shape[1], hw, n, p["chunk"],
                        p["seg"]) == p["smem_bytes"], (shape, n, dtype)
    x = torch.zeros(2, 8, 4, 4, device=cuda_device)
    p = lrn_ops.lrn_plan(tuple(x.shape), 3, x.dtype, backward)
    stream = torch.cuda.current_stream().cuda_stream
    args = (2, 8, 16, 3, 1e-3, -0.75)
    plan = (p["chunk"], p["seg"], p["threads"], p["smem_bytes"] - 16)
    if backward:
        rc = lib.lrn_bwd(x.data_ptr(), x.data_ptr(), x.data_ptr(), 0,
                         *args, 1e-3, 1.0, *plan, stream)
    else:
        rc = lib.lrn_fwd(x.data_ptr(), x.data_ptr(), 0, *args, 1.0, *plan,
                         stream)
    assert rc != 0


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
                                     ((2, 40, 3, 3), 19)] + SLAB_CASES
                         + [NO_SLAB_BWD])
def test_lrn_bwd_kernel_matches_reference(cuda_device, shape, n, dtype):
    """K1-bwd at the AlexNet b256 shapes and ragged ones (every n but 5
    takes the generic instance; NO_SLAB_BWD the direct one), one launch
    per call; autograd through lrn launches it once and gives the same
    gradient."""
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


# GoogLeNet.conf's two LRN inputs at its batch of 256 (n1 after pool1,
# n2 after conv2): the main path's shapes
GOOGLENET_LRN = [(256, 64, 56, 56), (256, 192, 56, 56)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GOOGLENET_LRN)
def test_lrn_kernels_at_googlenet_shapes(cuda_device, shape, dtype):
    """K1-fwd and K1-bwd at GoogLeNet's b256 LRN shapes (local_size 5,
    alpha 1e-4 as the conf has it) against their plain versions: the
    forward within test_lrn_kernel_matches_reference's bar, the
    backward within _bwd_close's."""
    alpha = 0.0001
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_x(shape, 8)).to(cuda_device).to(dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        cuda_device).to(dtype)
    before = kernels.launches()
    got = lrn_ops.lrn(x, 5, alpha, BETA, KNORM)
    gin = lrn_ops.lrn_backward(x, g, 5, alpha, BETA, KNORM)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert (after["lrn_fwd"] - before["lrn_fwd"],
            after["lrn_bwd"] - before["lrn_bwd"]) == (1, 1)
    ref = lrn_ops.lrn_reference(x, 5, alpha, BETA, KNORM).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert bool(torch.all((got.float() - ref).abs()
                              <= ref.abs() * 2.0 ** -7 + 1e-30))
    t1, t2 = lrn_ops.lrn_bwd_terms(x, g, 5, alpha, BETA, KNORM)
    gref = lrn_ops.lrn_bwd_reference(x, g, 5, alpha, BETA, KNORM).float()
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    bar = rtol * gref.abs() + 1e-6 * (t1.abs() + t2.abs())
    assert bool(torch.all((gin.float() - gref).abs() <= bar))


def _conf_on(path_parts, batch, extra=""):
    """A shipped conf's netconfig on (no iterator blocks) at `batch`,
    float32."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", *path_parts)
    with open(path) as f:
        net = "netconfig=start" + f.read().split("netconfig=start", 1)[1]
    net = net.replace("dtype = bfloat16", "dtype = float32")
    for k in ("batch_size",):
        net = "\n".join(ln for ln in net.splitlines()
                        if not ln.startswith(k))
    return net + f"\nbatch_size = {batch}\nsilent = 1\nseed = 3\n" + extra


def _rel_update_diff(before, a, b):
    """||(a - before) - (b - before)|| / ||b - before|| per tensor."""
    out = {}
    for lk in before:
        for pn in before[lk]:
            da = a[lk][pn] - before[lk][pn]
            db = b[lk][pn] - before[lk][pn]
            den = float(np.linalg.norm(db))
            out[f"{lk}/{pn}"] = (float(np.linalg.norm(da - db)) / den
                                 if den else float(np.linalg.norm(da)))
    return out


def test_googlenet_training_step_card_matches_cpu(cuda_device):
    """One SGD step of GoogLeNet.conf (float32, TF32 off, batch 16) on the
    card and on the CPU from the same weights, batch and dropout mask.
    The softmax rows before the step within rtol 1e-4 / atol 1e-6, the
    loss within rtol 1e-4 (57 convolutions summed in other orders). The
    CPU leg replays the card's discrete decisions (Routing: max-pool tie
    sets, relu gates): a value within float32 rounding of a decision
    boundary falls on either side by summation order, and one such
    decision moves an early tensor's update by ~1e-3. With them shared,
    every updated param within rtol 1e-3 / atol 1e-5 and each tensor's
    update within 2e-3 of the CPU's in relative norm (chip_smoke.py's
    UPDATE_BAR; rounding alone moves them by <= 4e-4 between two CPU
    legs at 8 and 1 threads).
    The step launches K1-fwd and K1-bwd twice (two lrn layers)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = _conf_on(("examples", "ImageNet", "GoogLeNet.conf"), 16)
    gpu = NetTrainer(cfg=conf, device="cuda:0")
    gpu.init_model()
    cpu = NetTrainer(cfg=conf, device="cpu")
    cpu.init_model()
    shapes = cpu.net.param_shapes()
    before = convert.params_to_numpy(cpu.state["params"], shapes)
    rng = np.random.RandomState(0)
    data = rng.randn(16, 3, 224, 224).astype(np.float32)
    label = rng.randint(0, 1000, size=(16, 1)).astype(np.float32)
    b = DataBatch(data=data, label=label)
    np.testing.assert_allclose(gpu.predict_dist(b), cpu.predict_dist(b),
                               rtol=1e-4, atol=1e-6)
    keep = numpy_keep(cpu, seed=1)
    kernels.reset_launches()
    with Routing() as card_routing:
        lg = gpu.update(b, keep=keep)
        torch.cuda.synchronize()
    counts = kernels.launches()
    assert (counts["lrn_fwd"], counts["lrn_bwd"]) == (2, 2)
    with Routing(replay=card_routing):
        lc = cpu.update(b, keep=keep)
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    pg = convert.params_to_numpy(gpu.state["params"], shapes)
    pc = convert.params_to_numpy(cpu.state["params"], shapes)
    for lk in pc:
        for pn in pc[lk]:
            np.testing.assert_allclose(pg[lk][pn], pc[lk][pn], rtol=1e-3,
                                       atol=1e-5, err_msg=f"{lk}/{pn}")
    diff = _rel_update_diff(before, pg, pc)
    assert max(diff.values()) <= 2e-3, sorted(diff.items(),
                                              key=lambda kv: -kv[1])[:5]


def test_stack_moe_training_step_card_matches_cpu(cuda_device):
    """One step of stack_moe.conf (float32, TF32 off, batch 8) on the card
    and on the CPU from the same weights, batch and dropout mask: the
    loss with the moe aux term within rtol 1e-5, params within rtol
    1e-4 / atol 1e-5. No routing decision is left to rounding: every
    token's top-2 margins at the moe input (2nd - 3rd and 1st - 2nd
    router probability) exceed ten times the largest difference between
    the card's and the CPU's router probabilities. The step launches
    each K2 kernel 4 times (4 stacked blocks), inference 4 K2-fwd."""
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = _conf_on(("examples", "LongSeq", "stack_moe.conf"), 8)
    gpu = NetTrainer(cfg=conf, device="cuda:0")
    gpu.init_model()
    cpu = NetTrainer(cfg=conf, device="cpu")
    cpu.init_model()
    rng = np.random.RandomState(0)
    data = rng.rand(8, 1, 28, 28).astype(np.float32)
    label = rng.randint(0, 10, size=(8, 1)).astype(np.float32)
    moe = [i for i, info in enumerate(cpu.net_cfg.layers)
           if info.type_name == "moe"][0]
    probs = []
    for tr in (cpu, gpu):
        with torch.no_grad():
            values, _ = tr.net(tr.compute_params(),
                               torch.from_numpy(data).to(tr.device))
        xin = values[tr.net_cfg.layers[moe].nindex_in[0]]
        probs.append(torch.softmax(
            xin.reshape(8, 28, 28)
            @ tr.state["params"]["moe1"]["gate"].t(), -1).cpu())
    apart = float((probs[0] - probs[1]).abs().max())
    top = torch.sort(probs[0], -1, descending=True).values
    assert float((top[..., 1] - top[..., 2]).min()) > 10 * apart
    assert float((top[..., 0] - top[..., 1]).min()) > 10 * apart
    keep = numpy_keep(cpu, seed=1)
    kernels.reset_launches()
    lg = gpu.update(DataBatch(data=data, label=label), keep=keep)
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert (counts["attn_fwd"], counts["attn_dq"], counts["attn_dkv"]) == (
        4, 4, 4)
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
    assert kernels.launches()["attn_fwd"] == 4


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
                                  "int8_mm": 0, "nvjpeg_decode": 0}
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


# the chunked route (K2-dq past head_dim 256, K2-fwd and K2-dkv past
# 512): d rounded up to whole 128-column chunks, one warpgroup a block, a
# 2-stage ring of two 64 x 128 bf16 chunks and 1 KB of alignment slack
# (K2-dkv: and 64 x 64 float32 for p^T)
WIDE_PLAN = {"threads": 128, "smem_bytes": 2 * 2 * 64 * 128 * 2 + 1024,
             "chunk": 128}
WIDE_DKV_SMEM = WIDE_PLAN["smem_bytes"] + 64 * 64 * 4
# the whole-head route of K2-fwd (257-512, one DP 512 instance): q
# resident (64 x 512), two k and two v tiles of 32 keys, two 64 x 64 p
# tiles, 3 x 64 float32 row values and 1 KB of slack; a score warpgroup
# and two warpgroups of 256 output columns
HEAD_FWD_PLAN = {"dp": 512, "threads": 384, "rows": 64, "chunk": 512,
                 "smem_bytes": (64 * 512 + 4 * 32 * 512 + 2 * 64 * 64) * 2
                 + 3 * 64 * 4 + 1024}
# ... and of K2-dkv (DP 512): a cluster of two blocks of 3 warpgroups,
# each with its 256 columns of k and v resident (64 rows), a 3-stage ring
# of 32 x 256 q and do tiles with their lse and delta, the 64 x 64 p^T /
# ds^T tile, two buffers of the 2 x 64 x 32 float32 score shares and 1
# KB of slack
HEAD_DKV_PLAN = {"dp": 512, "threads": 384, "chunk": 256, "cluster": 2,
                 "smem_bytes": (2 * 64 * 256 + 3 * 2 * 32 * 256 + 64 * 64)
                 * 2 + (3 * 2 * 32 + 2 * 2 * 64 * 32) * 4 + 1024}
SMEM_LIMIT = 232448  # a block's dynamic shared memory on the H100


def test_bf16_backward_tile_plans(cuda_device):
    """The tensor-core instances' plans: DP is d rounded up to a power of
    two of at least 64 (one 128-byte swizzle row), 2 warpgroups a block,
    shared memory within a block's 232,448 bytes; past head_dim 256
    K2-dq's chunked plan (WIDE_PLAN) and K2-dkv's whole-head plan up to
    512 (HEAD_DKV_PLAN), its chunked plan past it."""
    for d, dp in ((7, 64), (12, 64), (32, 64), (64, 64), (96, 128),
                  (128, 128), (200, 256), (256, 256)):
        for name in ("attn_dq", "attn_dkv"):
            plan = FA.tc_plan(name, d)
            assert plan["dp"] == dp, (name, d)
            assert plan["threads"] == 256 and plan["chunk"] == dp
            assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
            assert plan.get("cluster", 1) == 1
    for d, dp in ((257, 384), (320, 384), (384, 384), (512, 512),
                  (576, 640), (640, 640), (1024, 1024), (2048, 2048)):
        assert FA.tc_plan("attn_dq", d) == dict(WIDE_PLAN, dp=dp), d
        dkv = FA.tc_plan("attn_dkv", d)
        if d <= 512:
            assert dkv == HEAD_DKV_PLAN, d
        else:
            assert dkv == dict(WIDE_PLAN, dp=dp, smem_bytes=WIDE_DKV_SMEM,
                               cluster=1), d
        assert dkv["smem_bytes"] <= SMEM_LIMIT, d


# the K2-fwd tensor-core instance's edges: head_dim 7, 12, 64, 128, 200
# and 256 (every DP bucket, both load paths), Sq != Sk under both masks,
# sequences of at most 64 queries (the one-warpgroup plan) and views 2
# bytes off alignment
FWD_TC_CASES = [
    # (B, H, Sq, Sk, D, causal, misaligned)
    (100, 4, 28, 28, 7, False, False),
    (2, 3, 33, 33, 7, True, True),
    (2, 2, 65, 65, 12, True, False),
    (1, 3, 130, 130, 64, False, False),
    (1, 2, 64, 64, 64, True, False),
    (1, 2, 257, 257, 128, True, False),
    (2, 2, 1, 1, 128, False, False),
    (1, 1, 70, 70, 200, True, False),
    (1, 2, 200, 200, 256, False, False),
    (2, 1, 12, 12, 256, True, True),
    (1, 2, 100, 257, 64, False, False),
    (1, 2, 100, 257, 64, True, False),
    (1, 2, 257, 100, 128, True, False),
    (1, 2, 40, 300, 128, True, False),
    (1, 2, 96, 96, 128, False, True),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,misaligned", FWD_TC_CASES)
def test_bf16_forward_kernel_on_the_tensor_cores(cuda_device, b, h, sq, sk,
                                                 d, causal, misaligned):
    """K2-fwd in bfloat16 (the tensor-core instance) against
    flash_fwd_reference on the same inputs: o within the bf16 bar, lse
    within rtol 1e-5; one launch per call, and a second launch gives the
    same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(sq * 5 + sk + d)
    q = torch.randn(b, h, sq, d, generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn(b, h, sk, d, generator=g, device=cuda_device)
            .bfloat16() for _ in range(2))
    if misaligned:
        q, k, v = (_misaligned(t) for t in (q, k, v))
    before = kernels.launches()["attn_fwd"]
    o, lse = FA.attn_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert kernels.launches()["attn_fwd"] == before + 1
    ro, rlse = FA.flash_fwd_reference(q, k, v, causal)
    assert o.dtype == torch.bfloat16 and o.shape == ro.shape
    assert _attn_close(o, ro)
    assert torch.allclose(lse, rlse, rtol=1e-5, atol=1e-5)
    o2, lse2 = FA.attn_fwd(q, k, v, causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_bf16_forward_tile_plans(cuda_device):
    """K2-fwd's plans: DP as for the backward kernels; 2 warpgroups and
    128 query rows a block (64 at DP 256, where they split the output
    columns), one warpgroup and 64 rows for a sequence of at most 64 up
    to DP 128; shared memory within a block's 232,448 bytes."""
    for d, dp in ((7, 64), (12, 64), (64, 64), (96, 128), (128, 128),
                  (200, 256), (256, 256)):
        long = FA.tc_plan("attn_fwd", d)
        assert long["dp"] == dp and long["threads"] == 256, d
        assert long["rows"] == (64 if dp == 256 else 128), d
        short = FA.tc_plan("attn_fwd", d, 28)
        assert short["dp"] == dp, d
        assert (short["threads"], short["rows"]) == (
            (256, 64) if dp == 256 else (128, 64)), d
        for plan in (long, short):
            assert 0 < plan["smem_bytes"] <= 232448
    assert FA.tc_plan("attn_fwd", 128, 65)["rows"] == 128
    assert FA.tc_plan("attn_fwd", 128, 64)["rows"] == 64
    # the wide route: 64 query rows a block at any length; the whole-head
    # plan up to 512, the chunked one past it
    for d, dp in ((257, 512), (384, 512), (385, 512), (512, 512),
                  (576, 640), (2048, 2048)):
        for sq in (None, 28):
            plan = FA.tc_plan("attn_fwd", d, sq)
            if d <= 512:
                assert plan == HEAD_FWD_PLAN, (d, sq)
            else:
                assert plan == dict(WIDE_PLAN, dp=dp, rows=64), (d, sq)
            assert plan["smem_bytes"] <= SMEM_LIMIT, (d, sq)


# the wide route (head_dim > 256) in both dtypes: head_dim 257 (element
# loads, a last chunk of one column), 320 and 576 (a last chunk of 64),
# 384 and 512 (the whole-head route), 640, 1024 and 2048
# (the chunked route); ragged lengths, Sq != Sk under both masks (the
# blocks the ring hands K2), one query row, and views 2 bytes off
# alignment
WIDE_CASES = [
    # (B, H, Sq, Sk, D, causal, misaligned)
    (1, 2, 100, 100, 257, True, False),
    (2, 1, 70, 70, 320, False, False),
    (1, 2, 130, 130, 512, True, False),
    (1, 1, 65, 65, 576, False, False),
    (1, 1, 33, 33, 1024, True, False),
    (1, 2, 100, 257, 320, False, False),
    (1, 2, 100, 257, 512, True, False),
    (1, 2, 257, 100, 576, True, False),
    (1, 1, 1, 1, 1024, False, False),
    (1, 2, 96, 96, 512, False, True),
    (2, 1, 33, 33, 257, True, True),
    (2, 1, 97, 97, 384, False, False),
    (1, 2, 100, 257, 384, True, False),
    (1, 1, 130, 65, 640, True, False),
    (1, 1, 40, 70, 2048, True, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,misaligned", WIDE_CASES)
def test_wide_head_kernels_match_reference(cuda_device, b, h, sq, sk, d,
                                           causal, misaligned, dtype):
    """K2-fwd, K2-dq and K2-dkv past head_dim 256 (the wide route)
    against flash_fwd_reference / flash_dq_reference /
    flash_dkv_reference on the same inputs, at _attn_close's bars and lse
    within rtol 1e-5: one launch per call, and a second launch gives the
    same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(sq * 3 + sk + d)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=cuda_device)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    if misaligned:
        q, k, v, do = (_misaligned(t) for t in (q, k, v, do))
    before = kernels.launches()
    o, lse = FA.attn_fwd(q, k, v, causal)
    delta = FA.flash_delta(o, do)
    dq = FA.attn_dq(q, k, v, do, lse, delta, causal)
    dk, dv = FA.attn_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert [after[n] - before[n] for n in ("attn_fwd", "attn_dq",
                                           "attn_dkv")] == [1, 1, 1]
    ro, rlse = FA.flash_fwd_reference(q, k, v, causal)
    rdq = FA.flash_dq_reference(q, k, v, do, lse, delta, causal)
    rdk, rdv = FA.flash_dkv_reference(q, k, v, do, lse, delta, causal)
    assert o.dtype == dtype and o.shape == ro.shape
    assert _attn_close(o, ro)
    assert torch.allclose(lse, rlse, rtol=1e-5, atol=1e-5)
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert got.dtype == dtype and got.shape == ref.shape, name
        assert _attn_close(got, ref, grad=True), name
    o2, lse2 = FA.attn_fwd(q, k, v, causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(FA.attn_dq(q, k, v, do, lse, delta, causal), dq)
    dk2, dv2 = FA.attn_dkv(q, k, v, do, lse, delta, causal)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.parametrize("name", ["attn_fwd", "int8_mm"])
def test_refused_launch_raises_and_counts_nothing(cuda_device, name):
    """A launch the C entry refuses (an unknown dtype for K2-fwd, an
    unknown tile width for K3) comes back as an error code, and
    kernels.check raises on it without counting a launch."""
    lib = kernels.load(name)
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros(1, 1, 64, device=cuda_device)
    if name == "attn_fwd":
        rc = lib.attn_fwd(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                          x.data_ptr(), lse.data_ptr(), 7, 1, 64, 64, 64, 0,
                          0.125, stream)
    else:
        rc = lib.int8_mm(x.data_ptr(), x.data_ptr(), lse.data_ptr(), 8, 8,
                         64, 64, 1, 1, stream)
    assert rc != 0
    before = kernels.launches()[name]
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernels.check(name, rc)
    assert kernels.launches()[name] == before


def test_attn_fwd_build_failure_raises(cuda_device, monkeypatch, tmp_path):
    """A K2-fwd that does not build raises; the CUDA path never falls
    back to the plain version."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "attn_fwd.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    q = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16, device=cuda_device)
    before = kernels.launches()["attn_fwd"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        FA.flash_attention(q, q, q)
    assert kernels.launches()["attn_fwd"] == before


def test_attention_kernels_refuse_what_they_cannot_take(cuda_device):
    """What the kernels cannot take raises; head_dim 257, which they
    refused before the wide route, launches K2-fwd and computes."""
    x = torch.zeros(1, 2, 8, 16, device=cuda_device)
    wide = torch.ones(1, 2, 8, 257, device=cuda_device)
    before = kernels.launches()["attn_fwd"]
    o, _ = FA.attn_fwd(wide, wide, wide)
    out = FA.flash_attention(wide, wide, wide)
    torch.cuda.synchronize()
    assert kernels.launches()["attn_fwd"] == before + 2
    assert torch.equal(o, wide) and torch.equal(out, wide)
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


# K3's tensor-core edges: m in {1, 64, 193600}, k in {3, 363, 4096,
# 9216}, odd n, split-k (m = 64) and views one byte off alignment (the
# element-load path)
K3_TC_CASES = [
    # (m, k, n, misaligned)
    (1, 3, 7, False), (1, 9216, 1001, True), (64, 4096, 4097, False),
    (64, 9216, 4096, True), (64, 363, 1001, False), (64, 4096, 1000, True),
    (193600, 3, 5, False), (193600, 363, 96, True), (257, 4096, 255, False),
    (130, 9216, 129, True),
]


@pytest.mark.parametrize("m,k,n,misaligned", K3_TC_CASES)
def test_int8_tensor_core_kernel_edges(cuda_device, m, k, n, misaligned):
    """K3 on the int8 tensor cores equals its plain version bitwise at
    the edges of its tiles, split-k and load paths."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + 3 * k + n)

    def operand(rows):
        t = torch.randint(-127, 128, (rows, k), dtype=torch.int8,
                          device=cuda_device, generator=gen)
        if not misaligned:
            return t
        buf = torch.empty(rows * k + 1, dtype=torch.int8,
                          device=cuda_device)
        view = buf[1:].view(rows, k)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    x, w = operand(m), operand(n)
    before = kernels.launches()["int8_mm"]
    got = int8_ops.int8_mm(x, w)
    torch.cuda.synchronize()
    assert kernels.launches()["int8_mm"] == before + 1
    assert torch.equal(got, int8_ops.int8_matmul_reference(x, w))


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


# ---------------------------------------------------------------------------
# the image pipeline's staging and device augment on the card
# ---------------------------------------------------------------------------

def _raw_batches(n, rows, shape, dtype, seed):
    rng = np.random.RandomState(seed)
    return [DataBatch(
        data=(rng.randint(0, 256, (rows,) + shape).astype(np.uint8)
              if dtype == np.uint8 else
              (rng.randn(rows, *shape) * 3).astype(np.float32)),
        label=rng.randint(0, 10, (rows, 1)).astype(np.float32))
        for _ in range(n)]


class _ListIter:
    def __init__(self, items):
        self.items = items

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < len(self.items)

    def value(self):
        return self.items[self.i]


@pytest.mark.parametrize("extra,dtype", [
    ("dtype = bfloat16\n", np.float32),
    ("dtype = bfloat16\nstage_dtype = float32\n", np.float32),
    ("dtype = float32\n", np.float32),
    ("device_augment = 1\ninput_shape = 3,31,31\n", np.uint8)])
def test_pinned_ring_staging_equals_streamed(cuda_device, extra, dtype):
    """The prefetcher's pinned ring and side stream hand update() the
    bits a streamed stage_batch gives; a ring of depth + 1 slots is
    reused across more batches than it has slots."""
    tr = NetTrainer(cfg=NARROW_ALEXNET.replace("dev = cpu", "dev = gpu")
                    + extra)
    tr.init_model()
    items = _raw_batches(5, 8, (3, 35, 35), dtype, 3)
    pf = tr.prefetch(_ListIter(items), depth=1)
    pf.before_first()
    n = 0
    while pf.next():
        got = pf.value()
        assert got.ready is not None
        tr._await(got)
        want = tr.stage_batch(items[n])
        assert want.ready is None and got.data.dtype == want.data.dtype
        assert torch.equal(got.data, want.data)
        assert torch.equal(got.mask, want.mask)
        for k in want.labels:
            assert torch.equal(got.labels[k], want.labels[k])
        n += 1
    assert n == 5 and len(pf._ring._slots) == 2
    assert all(b.is_pinned() for s in pf._ring._slots
               for b in s.bufs.values())


def test_record_stream_keeps_a_staged_tensor_alive(cuda_device):
    """A staged batch dropped right after its step is enqueued: the
    allocator must not hand its memory to the side stream before the
    (delayed) step has read it, also across torch.cuda.empty_cache()."""
    from cxxnet_tpu_torch.io.prefetch import PinnedRing
    tr = NetTrainer(cfg=NARROW_ALEXNET.replace("dev = cpu", "dev = gpu"))
    tr.init_model()
    ring = PinnedRing(2, cuda_device)
    batch = _raw_batches(1, 8, (3, 35, 35), np.float32, 4)[0]
    want = torch.from_numpy(batch.data).sum()
    staged = tr.stage_batch(batch, ring)
    tr._await(staged)
    torch.cuda._sleep(200_000_000)  # hold the current stream back
    total = staged.data.double().sum()
    del staged
    torch.cuda.empty_cache()
    with torch.cuda.stream(ring.stream):
        junk = [torch.full((8, 3, 35, 35), 7.0, device=cuda_device)
                for _ in range(4)]
    torch.cuda.synchronize()
    assert torch.isclose(total.cpu(), want.double(), rtol=1e-6)
    del junk


def test_device_augment_on_the_card_equals_cpu(cuda_device):
    """ops/augment.py on the card gives its CPU result bit for bit,
    given the same (injected) draws, in the train and eval paths."""
    from cxxnet_tpu_torch.ops.augment import make_device_augment
    rng = np.random.RandomState(5)
    raw = torch.from_numpy(rng.randint(0, 256, (16, 3, 40, 37)).astype(
        np.uint8))
    mean = rng.uniform(0, 200, (3, 40, 37)).astype(np.float32)
    draws = {"yy": torch.from_numpy(rng.randint(0, 9, 16)),
             "xx": torch.from_numpy(rng.randint(0, 6, 16)),
             "mirror": torch.from_numpy(rng.rand(16) < 0.5),
             "contrast": torch.from_numpy(rng.rand(16)),
             "illumination": torch.from_numpy(rng.rand(16))}
    fn = make_device_augment((3, 32, 32), mean_loader=lambda: mean,
                             scale=1 / 256, rand_crop=1, rand_mirror=1,
                             max_random_contrast=0.3,
                             max_random_illumination=8.0)
    for train in (True, False):
        cpu = fn(raw, train, draws=draws)
        gpu = fn(raw.to(cuda_device), train,
                 draws={k: v.to(cuda_device) for k, v in draws.items()})
        assert torch.equal(gpu.cpu(), cpu), train


def _card_trainer(seed):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = NetTrainer(cfg=NARROW_ALEXNET.replace("seed = 3", f"seed = {seed}"),
                    device="cuda:0")
    tr.init_model()
    return tr


def test_serving_front_on_the_card(cuda_device, tmp_path):
    """The front on cuda:0 with 2 replicas: a ragged stream's rows equal
    predict_dist's (rtol 1e-4 / atol 1e-6: another bucket, another
    summation order), K1-fwd launches twice a dispatched batch, /predict
    answers, and a swap under load drops nothing and leaves the old
    slot's tensors bitwise unchanged."""
    import json
    import urllib.request
    gpu = _card_trainer(3)
    new = _card_trainer(11)
    ck = str(tmp_path / "new.model")
    with open(ck, "wb") as fo:
        new.save_model(fo)
    rng = np.random.RandomState(1)
    sizes = [1, 3, 8, 2, 5, 7, 4, 6] * 3
    reqs = [(rng.randn(n, 3, 35, 35) * 3).astype(np.float32) for n in sizes]
    srv = Server(gpu, max_batch=8, max_wait_ms=1.0, replicas=2,
                 http_port=0, metrics_host="127.0.0.1")
    srv.warmup()
    old_slot = srv._slot
    old_bits = {lk: {pn: t.clone() for pn, t in d.items()}
                for lk, d in old_slot.cparams.items()}
    with srv:
        kernels.reset_launches()
        futs = [srv.submit(r) for r in reqs]
        outs = [f.result(timeout=120) for f in futs]
        batches = srv.stats()["batches"]
        assert kernels.launches()["lrn_fwd"] == 2 * batches
        for r, o in zip(reqs, outs):
            want = gpu.predict_dist(DataBatch(
                data=r, label=np.zeros((r.shape[0], 1), np.float32)))
            np.testing.assert_allclose(o, want, rtol=1e-4, atol=1e-6)
        body = json.dumps({"data": reqs[1].reshape(3, -1).tolist(),
                           "raw": True}).encode()
        resp = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{srv.metrics_server.port}/predict",
            data=body), timeout=60)
        got = json.loads(resp.read())
        np.testing.assert_allclose(np.asarray(got["outputs"]), outs[1],
                                   rtol=1e-5, atol=1e-6)
        futs = [srv.submit(r) for r in reqs]
        assert srv.swap_to(ck) is True
        for f in futs:
            f.result(timeout=120)
        after = srv.submit(reqs[0]).result(timeout=60)
        stats = srv.stats()
    assert stats["errors"] == 0 and stats["swaps"] == 1
    np.testing.assert_allclose(after, new.predict_dist(DataBatch(
        data=reqs[0], label=np.zeros((1, 1), np.float32))),
        rtol=1e-4, atol=1e-6)
    for lk, d in old_slot.cparams.items():
        for pn, t in d.items():
            assert torch.equal(t, old_bits[lk][pn]), (lk, pn)


def test_replica_lanes_streams_and_readback_events(cuda_device):
    """Each replica works on its own stream (never the default one) and
    stages from one pinned buffer of its own, reused batch after batch;
    its readback event is waited on before rows are handed on: a batch
    read right after a different one through the same pinned output
    buffer gives its own rows (rtol 1e-4 / atol 1e-6 against
    predict_dist), and the rows handed out before are left as they
    were."""
    gpu = _card_trainer(3)
    srv = Server(gpu, max_batch=8, max_wait_ms=1.0, replicas=2)
    lanes = srv._lanes
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    handles = {lane.stream.cuda_stream for lane in lanes}
    assert len(handles) == 2 and default not in handles
    srv.warmup()

    def buffers():
        return [(ln._out.data_ptr(), [t.data_ptr() for t in ln._in.values()])
                for ln in lanes]
    for lane in lanes:
        assert lane._in and all(t.is_pinned() for t in lane._in.values())
        assert lane._out is not None and lane._out.is_pinned()
    ptrs = buffers()
    rng = np.random.RandomState(2)
    xs = [(rng.randn(8, 3, 35, 35) * 3).astype(np.float32)
          for _ in range(2)]
    wants = [gpu.predict_dist(DataBatch(
        data=x, label=np.zeros((8, 1), np.float32))) for x in xs]
    with torch.inference_mode():
        first = lanes[0].run(srv._graph, srv._slot.cparams, xs[0])
        kept = first.copy()
        second = lanes[0].run(srv._graph, srv._slot.cparams, xs[1])
    np.testing.assert_allclose(first, wants[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(second, wants[1], rtol=1e-4, atol=1e-6)
    assert np.array_equal(first, kept)
    with srv:
        for i in range(6):
            got = srv.submit(xs[i % 2]).result(timeout=60)
            np.testing.assert_allclose(got, wants[i % 2], rtol=1e-4,
                                       atol=1e-6)
    assert buffers() == ptrs


# ---------------------------------------------------------------------------
# the reference's own surface on the card: extra inputs, reference-binary
# checkpoints, extract, the numpy wrapper and the C ABI
# ---------------------------------------------------------------------------
def test_extra_inputs_on_the_card(cuda_device):
    """The extra-input net (tests/test_trainer.py:505) on the card
    against the CPU from the same weights (float32, TF32 off): params
    after 5 steps at rtol 1e-4 / atol 1e-5, rows at rtol 1e-4 / atol
    1e-6; the prefetcher's pinned ring carries the extras bitwise as
    streamed staging; a Server with 2 lanes (a pinned buffer for each
    extra input) serves them as predict_dist (rtol 1e-4 / atol 1e-6)."""
    from torch_port_util import EXTRA_NET, extra_batches
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = NetTrainer(cfg=EXTRA_NET, device="cuda:0")
    gpu.init_model()
    cpu = NetTrainer(cfg=EXTRA_NET, device="cpu")
    cpu.init_model()
    cpu._set_params({k: {n: t.cpu() for n, t in d.items()}
                     for k, d in gpu.state["params"].items()})
    data = extra_batches(5, 6)
    for x, e, y in data:
        for tr in (gpu, cpu):
            tr.update(DataBatch(data=x, label=y, extra_data=[e]))
    for lk, d in cpu.state["params"].items():
        for pn, t in d.items():
            np.testing.assert_allclose(gpu.state["params"][lk][pn].cpu(),
                                       t, rtol=1e-4, atol=1e-5)
    x, e, y = extra_batches(1, 7)[0]
    b = DataBatch(data=x, label=y, extra_data=[e])
    np.testing.assert_allclose(gpu.predict_dist(b), cpu.predict_dist(b),
                               rtol=1e-4, atol=1e-6)

    class Items:
        def __init__(self, items):
            self.items = items

        def before_first(self):
            self.i = -1

        def next(self):
            self.i += 1
            return self.i < len(self.items)

        def value(self):
            return self.items[self.i]
    batches = [DataBatch(data=x, label=y, extra_data=[e])
               for x, e, y in data[:3]]
    pf = gpu.prefetch(Items(batches), 1)
    try:
        pf.before_first()
        for want_b in batches:
            assert pf.next()
            got, want = pf.value(), gpu.stage_batch(want_b)
            gpu._await(got)
            assert got.ready is not None and len(got.extras) == 1
            assert torch.equal(got.extras[0], want.extras[0])
            assert torch.equal(got.data, want.data)
    finally:
        pf.close()
    srv = Server(gpu, max_batch=8, max_wait_ms=1.0, replicas=2)
    for lane in srv._lanes:
        assert len(lane._in_extra) == 1 and lane._in_extra[0].is_pinned()
    srv.warmup()
    reqs = [extra_batches(1, 20 + i, rows=n)[0]
            for i, n in enumerate((1, 3, 8, 5))]
    with srv:
        futs = [srv.submit(x, [e]) for x, e, _ in reqs]
        for (x, e, y), f in zip(reqs, futs):
            np.testing.assert_allclose(
                f.result(timeout=60),
                gpu.predict_dist(DataBatch(data=x, label=y,
                                           extra_data=[e])),
                rtol=1e-4, atol=1e-6)
        with pytest.raises(ValueError, match="extra inputs"):
            srv.submit(reqs[0][0])


def _seq_conf(batch):
    import os
    conf_path = os.path.join(os.path.dirname(__file__), "..", "examples",
                             "LongSeq", "seq_mnist.conf")
    with open(conf_path) as f:
        net = "netconfig=start" + f.read().split("netconfig=start", 1)[1]
    return (net.replace("batch_size = 100", f"batch_size = {batch}")
            + "\nsilent = 1\nseed = 3\n")


@pytest.mark.parametrize("net", ["extra_net", "seq_mnist"])
def test_csr_batch_trains_as_its_dense_batch_on_the_card(cuda_device, net):
    """A sparse CSR batch on cuda:0 (densified on the host, staged as
    any batch) trains bit for bit as its dense batch: EXTRA_NET
    (float32, with its extra input) and seq_mnist.conf's net (bfloat16
    as shipped, batch 8, about 81% zero pixels; a step launches each K2
    kernel once), 3 steps from the same weights; predict_dist on the
    CSR view equals the dense batch's bitwise."""
    from torch_port_util import EXTRA_NET, csr_of, extra_batches
    if net == "extra_net":
        conf = EXTRA_NET
        steps = [(x, y, [e]) for x, e, y in extra_batches(3, 9)]
    else:
        conf = _seq_conf(8)
        rng = np.random.RandomState(5)
        steps = []
        for _ in range(3):
            x = rng.rand(8, 1, 28, 28).astype(np.float32)
            x[rng.rand(*x.shape) < 0.81] = 0.0
            steps.append((x, rng.randint(0, 10, size=(8, 1)).astype(
                np.float32), []))
    trainers = []
    for _ in range(2):
        tr = NetTrainer(cfg=conf, device="cuda:0")
        tr.init_model()
        trainers.append(tr)
    dense, csr = trainers
    csr._set_params({k: {n: t.clone() for n, t in d.items()}
                     for k, d in dense.state["params"].items()})

    def view(x, y, extras):
        return csr_of(x, DataBatch, label=y, extra_data=extras)
    counts = []
    for tr, make in ((dense, lambda x, y, e: DataBatch(
            data=x, label=y, extra_data=e)), (csr, view)):
        kernels.reset_launches()
        for x, y, e in steps:
            tr.update(make(x, y, e))
        torch.cuda.synchronize()
        counts.append(kernels.launches())
    assert counts[0] == counts[1]
    if net == "seq_mnist":
        assert [counts[1][n] for n in ("attn_fwd", "attn_dq",
                                       "attn_dkv")] == [3, 3, 3]
    for lk, d in dense.state["params"].items():
        for pn, t in d.items():
            assert torch.equal(t, csr.state["params"][lk][pn]), (lk, pn)
    x, y, e = steps[0]
    assert np.array_equal(csr.predict_dist(view(x, y, e)),
                          dense.predict_dist(DataBatch(data=x, label=y,
                                                       extra_data=e)))


def test_legacy_checkpoint_and_extract_on_the_card(cuda_device):
    """model_format = cxxnet on the card: the file a card trainer writes
    loads back on the card with predict_dist bitwise equal, and the CPU
    writes the same bytes from the loaded weights; extract_feature of
    node 20 (= top[-2]) launches K1-fwd twice a batch and matches the
    CPU (float32, TF32 off) at rtol 1e-4 / atol 1e-6."""
    import io
    gpu = _card_trainer(5)
    gpu.set_param("model_format", "cxxnet")
    x = _x((8, 3, 35, 35), 1)
    gpu.update(DataBatch(data=x, label=np.arange(8, dtype=np.float32)
                         .reshape(8, 1)))
    buf = io.BytesIO()
    gpu.save_model(buf)
    raw = buf.getvalue()
    assert raw[:5] != b"CXTPU"
    again = _card_trainer(6)
    again.load_model(io.BytesIO(raw))
    b = DataBatch(data=x, label=np.zeros((8, 1), np.float32))
    assert np.array_equal(gpu.predict_dist(b), again.predict_dist(b))
    cpu = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    cpu.load_model(io.BytesIO(raw))
    cpu.set_param("model_format", "cxxnet")
    out = io.BytesIO()
    cpu.save_model(out)
    assert out.getvalue() == raw
    kernels.reset_launches()
    feat = gpu.extract_feature(b, "20")
    assert kernels.launches()["lrn_fwd"] == 2
    assert feat.shape == (8, 1, 1, 32)
    np.testing.assert_array_equal(feat, gpu.extract_feature(b, "top[-2]"))
    np.testing.assert_allclose(feat, cpu.extract_feature(b, "20"),
                               rtol=1e-4, atol=1e-6)


def test_wrapper_on_the_card(cuda_device, monkeypatch):
    """wrapper.Net on `gpu` (the card) trains through K1-fwd / K1-bwd,
    and train()'s staged path equals its prefetched one (the pinned
    ring) bit for bit."""
    import cxxnet_tpu_torch.wrapper as W
    rng = np.random.RandomState(3)
    x = (rng.randn(32, 3, 35, 35) * 3).astype(np.float32)
    y = rng.randint(0, 10, size=32).astype(np.float32)
    net = W.Net(dev="gpu", cfg=NARROW_ALEXNET)
    assert net._net.device.type == "cuda"
    net.init_model()
    kernels.reset_launches()
    net.update(x[:8], y[:8])
    assert kernels.launches()["lrn_bwd"] == 2
    assert net.predict(x[:8]).shape == (8,)
    param = {"eta": 0.05, "seed": 4}
    staged = W.train(NARROW_ALEXNET, x, y, num_round=2, param=param,
                     batch_size=8, dev="gpu")
    monkeypatch.setattr(W, "_STAGE_BYTES_LIMIT", 0)
    streamed = W.train(NARROW_ALEXNET, x, y, num_round=2, param=param,
                       batch_size=8, dev="gpu")
    for lk, d in staged._net.state["params"].items():
        for pn, t in d.items():
            assert torch.equal(t, streamed._net.state["params"][lk][pn])


def test_c_abi_driver_on_the_card(cuda_device, tmp_path):
    """The C driver with device gpu on the narrow AlexNet: every check
    passes, and the shim's launch log shows K1-fwd / K1-bwd twice an
    update and K1-fwd twice in each of the 5 forwards after them."""
    import json
    import os
    import subprocess
    from cxxnet_tpu_torch import capi_build
    exe = capi_build.build_driver()
    conf = tmp_path / "net.conf"
    conf.write_text(NARROW_ALEXNET)
    log = tmp_path / "launches.json"
    out = subprocess.run(
        [exe, "gpu", str(conf), "rand:8,3,35,35,10", str(tmp_path / "m"),
         "fc8", "3", str(tmp_path)],
        env=capi_build.driver_env(dict(os.environ,
                                       CXXNET_LAUNCH_LOG=str(log))),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout, out.stderr)
    counts = json.loads(log.read_text())
    assert counts["lrn_fwd"] == 2 * 3 + 10 and counts["lrn_bwd"] == 6


# ---------------------------------------------------------------------------
# the native image decoder (io/native.py, csrc/nvjpeg_io.cu)
# ---------------------------------------------------------------------------

def _jpeg_bin(path, n, size, seed, subsampling, extra=()):
    """n size x size quality-90 JPEGs (noise and a bright square) packed
    into one .bin, then the `extra` blobs; returns the path."""
    import io
    from PIL import Image
    from cxxnet_tpu_torch.utils.binary_page import BinaryPageWriter
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        w = BinaryPageWriter(f)
        for i in range(n):
            img = rng.randint(0, 150, (size, size, 3)).astype(np.uint8)
            img[i % 4::4, :size // 3, i % 3] = 250
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90,
                                      subsampling=subsampling)
            w.push(buf.getvalue())
        for blob in extra:
            w.push(blob)
        w.close()
    return str(path)


def _records(reader, passes=1):
    out = []
    for _ in range(passes):
        reader.before_first()
        while True:
            rec = reader.next()
            if rec is None:
                break
            out.append(rec)
    reader.close()
    return out


@pytest.mark.parametrize("kind", ["4:4:4", "4:2:2", "4:2:0", "4:4:0",
                                  "4:1:1", "gray", "rgb"])
def test_nvjpeg_reader_against_pil_at_the_bars(cuda_device, tmp_path, kind):
    """The decoder's records against PIL's decode of the same blobs
    (PlainBinReader), at io/native.py's PIL_BAR, for each JPEG kind it
    takes (io/native.py's JPEG_KINDS); every record decoded on the card,
    none handed back."""
    from cxxnet_tpu_torch.io.native import (PIL_BAR, NativeBinReader,
                                            PlainBinReader, encode_jpeg,
                                            pil_agreement, within_bar)
    rng = np.random.RandomState(3)
    blobs = []
    for i in range(64):
        img = rng.randint(0, 150, (256, 256, 3)).astype(np.uint8)
        img[i % 4::4, :256 // 3, i % 3] = 250
        blobs.append(encode_jpeg(img, kind))
    path = _jpeg_bin(tmp_path / "s.bin", 0, 256, 3, 0, blobs)
    kernels.reset_launches()
    got = _records(NativeBinReader([path], out_mode=2))
    assert (kernels.launches()["nvjpeg_decode"],
            kernels.raw_handbacks()) == (64, 0)
    want = _records(PlainBinReader([path], out_mode=2))
    stats = pil_agreement(got, want)
    assert within_bar(stats, PIL_BAR), stats


def test_ycc_to_rgb_kernel_is_its_plain_version(cuda_device):
    """YccToRgb against its plain version, bitwise, at the main path's
    256 x 256 planes in each subsampling and coding taken and at odd and
    narrow sizes; each call one launch."""
    from cxxnet_tpu_torch.io.native import (FACTORS, GRAY, RGB, YCC,
                                            ycc_to_rgb, ycc_to_rgb_plain)
    gen = torch.Generator().manual_seed(5)
    for h, w in ((256, 256), (37, 53), (1, 9), (17, 2), (3, 4)):
        cases = [(hf, vf, coding) for hf, vf in FACTORS.values()
                 for coding in (YCC, RGB)] + [(1, 1, GRAY)]
        for hf, vf, coding in cases:
            planes = [torch.randint(0, 256, shape, generator=gen,
                                    dtype=torch.uint8)
                      for shape in ((h, w), (-(-h // vf), -(-w // hf)),
                                    (-(-h // vf), -(-w // hf)))]
            if coding == GRAY:
                planes[1:] = [None, None]
            before = kernels.launches()["nvjpeg_decode"]
            got = ycc_to_rgb(*(p if p is None else p.to(cuda_device)
                               for p in planes), hf, vf, coding)
            torch.cuda.synchronize()
            assert kernels.launches()["nvjpeg_decode"] == before + 1
            assert torch.equal(got.cpu(), ycc_to_rgb_plain(
                *planes, hf, vf, coding))


@pytest.mark.parametrize("workers,inflight", [(4, 5), (16, 3)])
def test_nvjpeg_stream_order_and_counters(cuda_device, tmp_path, workers,
                                          inflight):
    """Records come back in stream order (40 sizes) on 4 workers and on
    16 (more than the machine's cores) through a window of 3, pass after
    pass and over two bins; out_mode 1 is out_mode 2 as float32; each
    decoded record counts once; a missing file raises IOError."""
    import io
    from PIL import Image
    from cxxnet_tpu_torch.io.native import NativeBinReader
    from cxxnet_tpu_torch.utils.binary_page import BinaryPageWriter
    rng = np.random.RandomState(8)
    path = str(tmp_path / "order.bin")
    with open(path, "wb") as f:
        w = BinaryPageWriter(f)
        for i in range(40):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (16 + i, 48 - i, 3)).astype(
                np.uint8)).save(buf, format="JPEG", quality=90)
            w.push(buf.getvalue())
        w.close()
    shapes = [(3, 16 + i, 48 - i) for i in range(40)]
    kernels.reset_launches()
    r = NativeBinReader([path], n_threads=workers, max_inflight=inflight,
                        out_mode=2)
    recs = []
    for _ in range(3):
        r.before_first()
        while True:
            rec = r.next()
            if rec is None:
                break
            recs.append(rec)
    r.close()
    assert [x.shape for x in recs] == shapes * 3
    assert kernels.launches()["nvjpeg_decode"] == 120
    assert kernels.raw_handbacks() == 0
    two = _records(NativeBinReader([path, path], out_mode=2))
    assert [x.shape for x in two] == shapes * 2
    f32 = _records(NativeBinReader([path], out_mode=1))
    for a, b in zip(f32, recs[:40]):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    r = NativeBinReader([str(tmp_path / "nope.bin")])
    r.before_first()
    with pytest.raises(IOError, match="cannot open"):
        r.next()
    r.close()


def test_nvjpeg_hands_back_png_ppm_and_a_truncated_jpeg(cuda_device,
                                                        tmp_path):
    """PNG and PPM come back raw and decode on the host bitwise, counted
    apart, and so does a CMYK JPEG (libjpeg has no RGB decode of it
    either: the JAX library hands it back too); a JPEG cut in its headers
    comes back raw and PIL's error surfaces."""
    import io
    from PIL import Image
    from cxxnet_tpu_torch.io.iter_img import decode_image
    from cxxnet_tpu_torch.io.native import NativeBinReader
    arr = np.random.RandomState(9).randint(0, 255, (24, 24, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    jpg = io.BytesIO()
    Image.fromarray(arr).save(jpg, format="JPEG", quality=90)
    cmyk = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(cmyk, format="JPEG",
                                              quality=90)
    path = _jpeg_bin(tmp_path / "raw.bin", 1, 24, 4, 0, (
        buf.getvalue(), b"P6\n24 24\n255\n" + arr.tobytes(),
        cmyk.getvalue(), jpg.getvalue()[:300]))
    kernels.reset_launches()
    r = NativeBinReader([path], out_mode=2)
    r.before_first()
    assert r.next().shape == (3, 24, 24)
    for _ in range(2):
        assert np.array_equal(r.next(), arr.transpose(2, 0, 1))
    assert np.array_equal(r.next(), decode_image(cmyk.getvalue()))
    with pytest.raises(OSError, match="Truncated File Read"):
        r.next()
    assert r.next() is None
    r.close()
    # the library counts in its workers, which decode ahead of next():
    # the counts are read once the stream has ended
    assert (kernels.launches()["nvjpeg_decode"],
            kernels.raw_handbacks()) == (1, 4)


def test_nvjpeg_device_failure_raises_and_never_falls_back(cuda_device,
                                                           tmp_path):
    """A CUDA error in the workers (a device ordinal past the last card)
    raises naming use_native = 0; nothing is decoded on the host."""
    from cxxnet_tpu_torch.io.native import NativeBinReader
    path = _jpeg_bin(tmp_path / "s.bin", 4, 32, 5, 0)
    kernels.reset_launches()
    r = NativeBinReader([path], device=f"cuda:{torch.cuda.device_count()}")
    r.before_first()
    with pytest.raises(RuntimeError, match="use_native = 0"):
        r.next()
    r.close()
    assert kernels.launches()["nvjpeg_decode"] == 0
    assert kernels.raw_handbacks() == 0


def test_imgbin_on_the_card_takes_nvjpeg(cuda_device, tmp_path):
    """create_iterator on the card: -1 and 1 take nvJPEG, and its shuffled
    labels equal PlainBinReader's (use_native = 1 on cpu) bitwise, the
    batches at the 4:4:4 bar."""
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.io.native import (NativeBinReader, pil_agreement,
                                            within_bar)
    path = _jpeg_bin(tmp_path / "s.bin", 40, 32, 6, 0)
    lst = tmp_path / "s.lst"
    lst.write_text("".join(f"{i}\t{i % 7}\tim{i}.jpg\n" for i in range(40)))

    def batches(use_native, device):
        it = create_iterator([
            ("iter", "imgbin"), ("image_list", str(lst)),
            ("image_bin", path), ("use_native", str(use_native)),
            ("shuffle", "1"), ("shuffle_buffer", "9"), ("silent", "1"),
            ("input_shape", "3,32,32"), ("batch_size", "8"),
            ("iter", "end")], device=device)
        it.init()
        out = [(b.data.copy(), b.label.copy()) for b in it]
        base = it.inner.base.base
        return out, base
    card, base = batches(-1, "cuda:0")
    assert isinstance(base._native, NativeBinReader)
    assert isinstance(batches(1, "cuda:0")[1]._native, NativeBinReader)
    plain, _ = batches(1, "cpu")
    assert len(card) == len(plain) == 5
    for (cd, cl), (pd, pl) in zip(card, plain):
        assert np.array_equal(cl, pl)
    stats = pil_agreement([d for d, _ in card], [d for d, _ in plain])
    assert within_bar(stats), stats


# ---------------------------------------------------------------------------
# fused dispatch (steps_per_dispatch), remat and the profiler's trace
# ---------------------------------------------------------------------------

def _dispatch_batches(n, rows=8, bad=None):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        data = (rng.randn(rows, 3, 35, 35) * 3).astype(np.float32)
        if i == bad:
            data[:] = np.nan
        out.append(DataBatch(data=data, label=rng.randint(
            0, 10, size=(rows, 1)).astype(np.float32)))
    return out


def _param_bits(tr):
    p = tr.state["params"]
    return [p[k][n].detach().cpu().numpy().view(np.uint32)
            for k in sorted(p) for n in sorted(p[k])]


@pytest.mark.parametrize("extra", [
    "", "check_nan = 1\nupdate_period = 2\ndtype = bfloat16\n"])
def test_dispatch_chunk_equals_streamed_on_the_card(cuda_device, extra):
    """NARROW_ALEXNET on the card: 8 updates as two chunks of 4 equal 8
    update() calls bit for bit (the NaN microstep dropped in both under
    check_nan), with the same K1 launches, and the guard reads one
    finite vector a chunk."""
    conf = NARROW_ALEXNET + "eta = 0.05\nmomentum = 0.9\n" + extra
    bad = 5 if "check_nan" in extra else None
    batches = _dispatch_batches(8, bad=bad)
    runs = []
    for k in (1, 4):
        tr = NetTrainer(cfg=conf, device="cuda:0")
        tr.init_model()
        kernels.reset_launches()
        if k == 1:
            for b in batches:
                tr.update(b)
        else:
            for i in range(0, 8, k):
                tr.update_chunk(batches[i:i + k])
        torch.cuda.synchronize()
        runs.append((tr, kernels.launches()))
    (ta, la), (tb, lb) = runs
    for a, b in zip(_param_bits(ta), _param_bits(tb)):
        assert np.array_equal(a, b)
    assert la == lb and la["lrn_fwd"] == la["lrn_bwd"] == 16
    if bad is not None:
        assert ta.bad_rounds == tb.bad_rounds == 1
        assert (ta.guard_readbacks, tb.guard_readbacks) == (8, 2)
        assert ta.epoch == tb.epoch == 3


def test_dispatch_rollback_keeps_param_storage(cuda_device):
    """A NaN microstep inside a chunk is rolled back by a select in
    place: every param and updater-state tensor keeps its storage, and
    the params are those of a run without the NaN batch's update."""
    conf = NARROW_ALEXNET + "eta = 0.05\nmomentum = 0.9\ncheck_nan = 1\n"
    tr = NetTrainer(cfg=conf, device="cuda:0")
    tr.init_model()
    leaves = [t for d in (tr.state["params"], tr.state["ustate"])
              for t in _leaves(d)]
    ptrs = [t.data_ptr() for t in leaves]
    tr.update_chunk(_dispatch_batches(4, bad=2))
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in _leaves(tr.state["params"])
            + _leaves(tr.state["ustate"])] == ptrs
    assert tr.bad_rounds == 1 and tr.epoch == 3
    assert all(torch.isfinite(t).all() for t in _leaves(tr.state["params"]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def test_dispatch_remat_values_and_peak_memory(cuda_device):
    """AlexNet.conf's net at b64 bfloat16: remat = 1 trains to the same
    params as remat = 0 over 2 updates - bitwise, or no further apart
    than two remat = 0 runs are - and its peak device memory is lower.
    Its forward runs twice, so K1-fwd launches 4 times a step, not 2."""
    import os
    conf_path = os.path.join(os.path.dirname(__file__), "..", "examples",
                             "ImageNet", "AlexNet.conf")
    with open(conf_path) as f:
        net = "netconfig=start" + f.read().split("netconfig=start", 1)[1]
    conf = net.replace("batch_size = 256", "batch_size = 64") + \
        "\nsilent = 1\nseed = 3\n"
    rng = np.random.RandomState(0)
    batches = [DataBatch(data=rng.rand(64, 3, 227, 227).astype(np.float32),
                         label=rng.randint(0, 1000, (64, 1)).astype(
                             np.float32)) for _ in range(2)]
    out = {}
    for tag, remat in (("a", 0), ("b", 0), ("r", 1)):
        tr = NetTrainer(cfg=conf + f"remat = {remat}\n", device="cuda:0")
        tr.init_model()
        staged = [tr.stage_batch(b) for b in batches]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        for s in staged:
            tr.update(s)
        torch.cuda.synchronize()
        out[tag] = (_param_bits(tr), torch.cuda.max_memory_allocated(),
                    kernels.launches()["lrn_fwd"])
        del tr, staged
        torch.cuda.empty_cache()

    def diff(x, y):
        return max(float(np.abs(a.view(np.float32) - b.view(np.float32)).max())
                   for a, b in zip(out[x][0], out[y][0]))
    assert diff("r", "a") <= diff("a", "b")
    assert out["r"][1] < out["a"][1]
    assert (out["a"][2], out["r"][2]) == (4, 8)


def test_dispatch_profiler_trace_holds_kernel_events(cuda_device, tmp_path):
    """profile_dir with trace_round = 2 over 3 rounds of NARROW_ALEXNET
    (in a fresh process: a long-lived one can lose the card's events):
    one trace, holding K1's kernels."""
    import json
    import os
    import subprocess
    import sys
    code = f"""
import numpy as np, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from torch_port_util import NARROW_ALEXNET
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
conf = NARROW_ALEXNET.replace("dev = cpu", "") + "eta = 0.05\\n"
tr = NetTrainer(cfg=conf + "profile_dir = {tmp_path}/prof\\ntrace_round = 2\\n",
                device="cuda:0")
tr.init_model()
rng = np.random.RandomState(0)
b = DataBatch(data=rng.randn(8, 3, 35, 35).astype(np.float32),
              label=rng.randint(0, 10, (8, 1)).astype(np.float32))
for r in range(3):
    tr.start_round(r + 1)
    for _ in range(2):
        tr.update(b)
    tr.finish_round_profile()
print(tr.profile_summary())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "profile: 2 steps" in r.stdout and r.stderr.count("profile:") == 2
    files = os.listdir(tmp_path / "prof")
    assert files == ["trace_round2.json"]
    with open(tmp_path / "prof" / files[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert any("lrn_fwd" in n for n in names), sorted(set(names))[:20]
    assert any("lrn_bwd" in n for n in names)


# ---------------------------------------------------------------------------
# the analysis tier on the card (analysis/graph_audit.py, lock_audit.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def routing_checks():
    """The graph audit's kernel-routing targets, run once on the card."""
    from cxxnet_tpu_torch.analysis import graph_audit as GA
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    checks = []
    counts = GA._kernel_routing(torch.device("cuda:0"), checks)
    return checks, counts


@pytest.mark.parametrize("target", [
    "alexnet serve[b=64] bf16", "alexnet train_step[b=64] bf16",
    "alexnet int8 serve[b=64]", "seq_mnist train_step[b=100]"])
def test_graph_audit_kernel_routing(cuda_device, routing_checks, target):
    """Each main path launches its hand-written kernels (K1-fwd 2 a
    bucket; K1-fwd 2 and K1-bwd 2 a step; K3 11 an int8 bucket; K2-fwd,
    dq, dkv 1 each a seq_mnist step), no plain version, no SDPA and no
    _int_mm."""
    checks, _ = routing_checks
    hits = [c for c in checks
            if c["target"] == target and c["check"] == "kernel-routing"]
    assert len(hits) == 1 and hits[0]["ok"], hits


def test_graph_audit_int8_vacuity_guard(cuda_device, routing_checks):
    checks, counts = routing_checks
    guard = [c for c in checks if c["check"] == "float-trace-vacuity-guard"]
    assert guard and guard[0]["ok"], guard
    assert counts["alexnet_int8"]["int8_mm"] == 11


def test_graph_audit_one_readback_a_chunk_under_sync_debug(cuda_device):
    """The train targets on the card under torch.cuda.set_sync_debug_mode:
    no sync at all in a step or a chunk under check_nan = 0 ("error"),
    exactly one (the guard's) in a K = 4 chunk under check_nan = 1."""
    from cxxnet_tpu_torch.analysis import graph_audit as GA
    checks = []
    GA._train_targets(torch.device("cuda:0"), checks)
    bad = [c for c in checks if not c["ok"]]
    assert bad == []
    one = [c for c in checks if c["target"] == "train_chunk[K=4,check_nan=1]"
           and c["check"] == "no-host-sync"]
    assert one and "1 sync warning" in one[0]["detail"]


def test_lock_audit_serve_storm_on_the_card(cuda_device):
    from cxxnet_tpu_torch.analysis.lock_audit import run_lock_audit
    rep = run_lock_audit(scenarios=("serve-storm",), device="cuda:0")
    assert rep["failed"] == 0, [c for c in rep["checks"] if not c["ok"]]
    assert rep["cycle"] is None and not rep["boundary_violations"]


# ---------------------------------------------------------------------------
# data parallelism: two ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

DP_WORKER = r"""
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
sys.path.insert(0, os.path.join(os.environ["CXN_TEST_REPO"], "tests"))
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops.routing import Routing
from torch_port_util import NARROW_ALEXNET, numpy_keep
work = os.environ["CXN_TEST_WORK"]
torch.backends.cudnn.allow_tf32 = False
cfg = NARROW_ALEXNET.replace("dev = cpu", "dev = gpu:0")
t = NetTrainer(device="cuda:0", cfg=cfg + '''
dtype = float32
param_server = dist
update_on_server = 1
''')
t.init_model()
lb, lo = t._local_batch, t._local_row_start
z = np.load(os.path.join(work, "batch.npz"))
kernels.reset_launches()
for i in range(2):
    rec = Routing()
    rec.decisions = {k: v[lo:lo + lb] for k, v in torch.load(
        os.path.join(work, f"dec{i}.pt")).items()}
    keep = {j: m[lo:lo + lb] for j, m in numpy_keep(t, 30 + i).items()}
    with Routing(replay=rec):
        t.update(DataBatch(data=z["x"][lo:lo + lb], label=z["y"][lo:lo + lb]),
                 keep=keep)
out = {f"{k}/{n}": v.cpu().numpy() for k, d in t.state["params"].items()
       for n, v in d.items()}
np.savez(os.path.join(work, f"rank{t.mesh.rank}.npz"), **out)
print(json.dumps({"rows": lb, "launches": kernels.launches(),
                  "bad": t.check_weights()}), flush=True)
"""


def test_data_parallel_two_ranks_on_the_card(cuda_device, tmp_path):
    """NARROW_ALEXNET float32 as two ranks sharing the card over gloo
    (4 rows a rank, update_on_server = 1), 2 steps, against one process
    at batch 8 on the card with its discrete decisions replayed: each
    param's update within 2e-3 of its norm (chip_smoke's UPDATE_BAR),
    K1-fwd / K1-bwd 2 / 2 a step on each rank, and the ranks' weights
    equal (check_weights)."""
    import json
    import os
    import subprocess
    import sys
    torch.backends.cudnn.allow_tf32 = False
    cfg = NARROW_ALEXNET.replace("dev = cpu", "dev = gpu:0")
    rng = np.random.RandomState(9)
    x = rng.randn(8, 3, 35, 35).astype(np.float32)
    y = rng.randint(0, 10, size=(8, 1)).astype(np.float32)
    np.savez(tmp_path / "batch.npz", x=x, y=y)
    t = NetTrainer(device="cuda:0", cfg=cfg + "dtype = float32\n")
    t.init_model()
    before = {f"{k}/{n}": v.cpu().numpy().copy()
              for k, d in t.state["params"].items() for n, v in d.items()}
    for i in range(2):
        rec = Routing()
        with rec:
            t.update(DataBatch(data=x, label=y), keep=numpy_keep(t, 30 + i))
        torch.save(rec.decisions, tmp_path / f"dec{i}.pt")
    ref = {f"{k}/{n}": v.cpu().numpy()
           for k, d in t.state["params"].items() for n, v in d.items()}
    del t
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "dp_worker.py"
    script.write_text(DP_WORKER)
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=repo, CXN_TEST_REPO=repo,
                   CXN_TEST_WORK=str(tmp_path),
                   CXN_COORDINATOR=f"127.0.0.1:{port}", CXN_NUM_WORKER="2",
                   CXN_WORKER_RANK=str(r), CXN_LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        rep = json.loads(out.strip().splitlines()[-1])
        assert rep["rows"] == 4 and rep["bad"] == []
        assert rep["launches"]["lrn_fwd"] == 4
        assert rep["launches"]["lrn_bwd"] == 4
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for key, b in before.items():
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        d_ref, d_dp = ref[key] - b, ranks[0][key] - b
        den = float(np.linalg.norm(d_ref))
        rel = float(np.linalg.norm(d_dp - d_ref)) / den if den else 0.0
        assert rel <= 2e-3, (key, rel)


COLLECTIVE_WORKER = r"""
import json, os, sys
import torch
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
from cxxnet_tpu_torch.parallel import distributed, tensor
from cxxnet_tpu_torch.parallel.mesh import Mesh
distributed.init_distributed(device=torch.device("cuda:0"), spec="gpu:0",
                             deadline=60)
r = distributed.process_index()
out = {"backend": distributed.backend()}
x = (torch.arange(24, dtype=torch.float32) * (r + 1) - 7.5) / 3.0
staged = distributed.host_staged[0]
rs_card = distributed.reduce_scatter(x.to("cuda:0"))
out["rs_staged"] = distributed.host_staged[0] - staged
out["rs_device"] = str(rs_card.device)
out["rs_equal"] = bool(torch.equal(rs_card.cpu(),
                                   distributed.reduce_scatter(x)))
mesh = Mesh((("data", 1), ("model", 2)), 0, None, r, None)


def block(dev):
    # a column-parallel product: enter, this rank's weight columns, gather
    g = torch.Generator().manual_seed(5)
    xs = torch.randn(4, 6, generator=g).to(dev).requires_grad_(True)
    w = torch.randn(8, 6, generator=g)[r * 4:(r + 1) * 4].to(dev)
    w.requires_grad_(True)
    y = tensor.gather(tensor.enter(xs, mesh) @ w.t(), 1, mesh)
    (y * torch.arange(32, dtype=torch.float32, device=dev).view(4, 8)
     ).sum().backward()
    return [t.detach().cpu() for t in (y, xs.grad, w.grad)]


card, cpu = block("cuda:0"), block("cpu")
out["tp_equal"] = [bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6))
                   for a, b in zip(card, cpu)]
out["tp_calls"] = dict(tensor.calls)
print(json.dumps(out), flush=True)
"""


@pytest.mark.parametrize("what", ["reduce_scatter", "enter_gather"])
def test_collectives_two_ranks_on_the_card(cuda_device, tmp_path, what):
    """Two ranks sharing the card over gloo: the reduce-scatter of a CUDA
    tensor stages through pinned host memory (counted once) and lands
    back on the card equal to the host tensors' result; the model
    axis's enter / gather pair on CUDA tensors gives the CPU result in
    the forward and in both gradients."""
    import json
    import os
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "coll_worker.py"
    script.write_text(COLLECTIVE_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=repo, CXN_TEST_REPO=repo,
                 CXN_COORDINATOR=f"127.0.0.1:{port}", CXN_NUM_WORKER="2",
                 CXN_WORKER_RANK=str(r), CXN_LOCAL_RANK=str(r)))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        rep = json.loads(out.strip().splitlines()[-1])
        assert rep["backend"] == "gloo"
        if what == "reduce_scatter":
            assert rep["rs_staged"] == 1 and rep["rs_device"] == "cuda:0"
            assert rep["rs_equal"], rep
        else:
            assert rep["tp_equal"] == [True, True, True], rep
            assert rep["tp_calls"] == {"enter": 2, "gather": 2, "reduce": 0}


SEQ_WORKER = r"""
import json, os, sys
import torch
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.parallel import distributed, ring
from cxxnet_tpu_torch.parallel.mesh import MeshSpec, build_mesh
distributed.init_distributed(device=torch.device("cuda:0"), spec="gpu:0",
                             deadline=60)
r = distributed.process_index()
mesh = build_mesh(MeshSpec(axes=[("seq", 2)]), 1, 2, r)
out = {"backend": distributed.backend(), "cases": []}


def close(got, ref, grad=False):
    # _attn_close's bars (the card against the plain version)
    g, f = got.float(), ref.float()
    if ref.dtype == torch.float32:
        return bool(torch.allclose(g, f, rtol=1e-4 if grad else 1e-5,
                                   atol=1e-5))
    bar = 1e-2 * f.abs() + 1e-2 * f.abs().max() + 1e-5
    return bool(torch.all((g - f).abs() <= bar))


for dtype in (torch.float32, torch.bfloat16):
    for scheme in ("ring", "ulysses"):
        for causal in (False, True):
            g = torch.Generator().manual_seed(11)
            # (2, 4, 512, 64): this rank's block of 256 positions
            q, k, v, do = (torch.randn(2, 4, 512, 64, generator=g)
                           [:, :, r * 256:(r + 1) * 256].to(dtype)
                           for _ in range(4))

            def run(dev):
                leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
                o = ring.seq_parallel_attention(*leaves, mesh, scheme,
                                                causal=causal)
                o.backward(do.to(dev))
                return [t.detach().cpu() for t in
                        [o] + [x.grad for x in leaves]]

            k0 = kernels.launches()
            card = run("cuda:0")
            k1 = kernels.launches()
            cpu = run("cpu")
            out["cases"].append({
                "dtype": str(dtype), "scheme": scheme, "causal": causal,
                "launches": {n: k1[n] - k0[n] for n in
                             ("attn_fwd", "attn_dq", "attn_dkv")},
                "close": [close(a, b, grad=i > 0)
                          for i, (a, b) in enumerate(zip(card, cpu))]})
out["staged"] = distributed.host_staged[0]
print(json.dumps(out), flush=True)
"""


def test_seq_parallel_two_ranks_on_the_card(cuda_device, tmp_path):
    """Two ranks sharing the card over gloo at mesh = seq:2: ring and
    Ulysses attention on CUDA tensors (K2-fwd / K2-dq / K2-dkv per
    block, the exchanges staged through pinned host memory) against the
    same ranks' plain versions on the CPU, on the same inputs, float32
    and bfloat16, causal and not (the _attn_close bars); the ring
    launches K2-fwd twice a call (once on seq rank 0 under causal),
    Ulysses once."""
    import json
    import os
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "seq_worker.py"
    script.write_text(SEQ_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=repo, CXN_TEST_REPO=repo,
                 CXN_COORDINATOR=f"127.0.0.1:{port}", CXN_NUM_WORKER="2",
                 CXN_WORKER_RANK=str(r), CXN_LOCAL_RANK=str(r)))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        rep = json.loads(out.strip().splitlines()[-1])
        assert rep["backend"] == "gloo" and rep["staged"] > 0
        assert len(rep["cases"]) == 8
        for case in rep["cases"]:
            assert case["close"] == [True] * 4, case
            n = (1 if case["scheme"] == "ulysses"
                 else 1 if (case["causal"] and r == 0) else 2)
            assert case["launches"] == {"attn_fwd": n, "attn_dq": n,
                                        "attn_dkv": n}, case["launches"]


PX_WORKER = r"""
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.parallel import distributed
work = os.environ["CXN_TEST_WORK"]
with open(os.path.join(work, "spec.json")) as f:
    spec = json.load(f)
t = NetTrainer(device="cuda:0", cfg=spec["cfg"] + '''
param_server = dist
mesh = ''' + spec["mesh"] + "\n")
with open(os.path.join(work, "init.model"), "rb") as f:
    t.load_model(f)
lb, lo = t._local_batch, t._local_row_start
z = np.load(os.path.join(work, "batch.npz"))
kernels.reset_launches()
for i in range(2):
    t.update(DataBatch(data=z["x"][i, lo:lo + lb],
                       label=z["y"][i, lo:lo + lb]))
launches = kernels.launches()
out = {f"{k}/{n}": v.cpu().numpy() for k, d in t._whole_params().items()
       for n, v in d.items()}
np.savez(os.path.join(work, f"rank{distributed.process_index()}.npz"), **out)
print(json.dumps({
    "launches": launches, "bad": t.check_weights(),
    "backend": distributed.backend(),
    "exchanges": dict(distributed.pipe_exchanges),
    "shapes": {f"{k}/{n}": list(v.shape)
               for k, d in t.state["params"].items()
               for n, v in d.items()}}), flush=True)
"""

PX_STACK = """
netconfig=start
layer[0->1] = pos_embed:pe
layer[1->2] = transformer_stack:ts1
  nlayer = {nlayer}
  nhead = 4
  nhidden = 112
layer[2->3] = layernorm:lnf
layer[3->4] = moe:moe1
  nexpert = 4
  nhidden = 56
  moe_top_k = 2
layer[4->5] = flatten
layer[5->6] = fullc:head
  nhidden = 10
  init_sigma = 0.01
layer[6->6] = softmax
netconfig=end
input_shape = 1,28,28
random_type = xavier
batch_size = 16
dtype = float32
eta = 0.05
momentum = 0.9
dev = gpu:0
silent = 1
"""


def _two_ranks_against_one(tmp_path, cfg: str, mesh: str):
    """(one process's params before and after 2 steps of 16 rows on the
    card, each of two ranks' report and whole params after the same
    steps at `mesh`, sharing the card over gloo)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(21)
    x = rng.randn(2, 16, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, size=(2, 16, 1)).astype(np.float32)
    np.savez(tmp_path / "batch.npz", x=x, y=y)
    with open(tmp_path / "spec.json", "w") as f:
        json.dump({"cfg": cfg, "mesh": mesh}, f)
    t = NetTrainer(device="cuda:0", cfg=cfg)
    t.init_model()
    with open(tmp_path / "init.model", "wb") as f:
        t.save_model(f)
    before = {f"{k}/{n}": v.cpu().numpy().copy()
              for k, d in t.state["params"].items() for n, v in d.items()}
    for i in range(2):
        t.update(DataBatch(data=x[i], label=y[i]))
    ref = {f"{k}/{n}": v.cpu().numpy()
           for k, d in t.state["params"].items() for n, v in d.items()}
    del t
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "px_worker.py"
    script.write_text(PX_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=repo, CXN_TEST_REPO=repo,
                 CXN_TEST_WORK=str(tmp_path),
                 CXN_COORDINATOR=f"127.0.0.1:{port}", CXN_NUM_WORKER="2",
                 CXN_WORKER_RANK=str(r), CXN_LOCAL_RANK=str(r)))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    reps = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        reps.append(json.loads(out.strip().splitlines()[-1]))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for key, b in before.items():
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        d_ref, d_px = ref[key] - b, ranks[0][key] - b
        den = float(np.linalg.norm(d_ref))
        rel = float(np.linalg.norm(d_px - d_ref)) / den if den else 0.0
        assert rel <= 2e-3, (key, rel)
    return reps


def test_pipe_parallel_two_ranks_on_the_card(cuda_device, tmp_path):
    """A stack_moe-like net (2 blocks, float32) at mesh = pipe:2 as two
    ranks sharing the card over gloo, 2 steps of 16 rows, against one
    process on the card: each param's update within 2e-3 of its norm,
    the ranks' weights equal; each stage holds 1 of the 2 blocks and
    launches K2-fwd / K2-dq / K2-dkv once per microbatch (M = 2) a step;
    the stage hops and broadcasts staged through pinned host memory."""
    reps = _two_ranks_against_one(tmp_path, PX_STACK.format(nlayer=2),
                                  "pipe:2")
    for r, rep in enumerate(reps):
        assert rep["backend"] == "gloo" and rep["bad"] == [], rep
        assert rep["shapes"]["ts1/wqkv"] == [1, 84, 28]
        assert {n: rep["launches"][n] for n in
                ("attn_fwd", "attn_dq", "attn_dkv")} == {
                    "attn_fwd": 4, "attn_dq": 4, "attn_dkv": 4}, rep
        assert rep["exchanges"] == {"send": 4, "recv": 4,
                                    "broadcast": 4}, rep


def test_expert_parallel_two_ranks_on_the_card(cuda_device, tmp_path):
    """The same net with 1 block at mesh = expert:2: each rank runs 2 of
    the 4 experts on every row, the gate whole; updates within 2e-3 of
    one process's, weights equal; K2 once a step on each rank."""
    reps = _two_ranks_against_one(tmp_path, PX_STACK.format(nlayer=1),
                                  "expert:2")
    for rep in reps:
        assert rep["backend"] == "gloo" and rep["bad"] == [], rep
        assert rep["shapes"]["moe1/w1"] == [2, 56, 28]
        assert rep["shapes"]["moe1/gate"] == [4, 28]
        assert {n: rep["launches"][n] for n in
                ("attn_fwd", "attn_dq", "attn_dkv")} == {
                    "attn_fwd": 2, "attn_dq": 2, "attn_dkv": 2}, rep


def test_elastic_pod_two_members_on_the_card(cuda_device, tmp_path):
    """tools/elastic_smoke.py on the card: examples/LongSeq/seq_mnist.conf
    as shipped (b100, bfloat16, dropout) as a 2-member pod on cuda:0 over
    gloo, the leader killed at its 3rd dispatched step (round 2's
    first): a 2 -> 1 reshape with member 1 the new leader, one publisher
    a round, the final sha256 equal to an uninterrupted 1-member run's
    from the same rollback checkpoint, and K2-fwd / K2-dq / K2-dkv
    launched by every member in every generation, K2-dq once a trained
    step (no plain version on a CUDA tensor)."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("CXN_MEMBER_ID", "CXN_WORKER_RANK", "CXXNET_FAULT",
                        "CXN_NUM_WORKER", "CXN_COORDINATOR")}
    env["PYTHONPATH"] = repo
    p = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.elastic_smoke",
         "--dev", "gpu:0", "--out", str(tmp_path / "out"), "--conf",
         os.path.join(repo, "examples", "LongSeq", "seq_mnist.conf"),
         "--nproc", "2", "--rounds", "2", "--kill-hit", "3", "--train",
         "200", "--test", "100", "--json", str(tmp_path / "s.json")],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    s = json.load(open(tmp_path / "s.json"))
    assert s["generations"] == {"0": [0, 1], "1": [1]}
    assert s["rollback_round"] == 1
    assert s["sha256"]["interrupted"] == s["sha256"]["uninterrupted"]
    recs = dict(s["launches_a"], **{f"b.{k}": v
                                    for k, v in s["launches_b"].items()})
    assert sorted(s["launches_a"]) == ["m0.g0", "m1.g0", "m1.g1"]
    for tag, rec in recs.items():
        n = rec["launches"]
        assert n["attn_fwd"] > 0 and n["attn_dkv"] == n["attn_dq"], (tag,
                                                                      rec)
        assert n["attn_dq"] == rec["steps"] > 0, (tag, rec)


def test_serve_on_a_mesh_on_the_card(cuda_device):
    """The narrow AlexNet-shaped net served on the card by a one-process
    trainer at mesh = data:2: buckets the multiples of 2 of the default
    set, rows equal to the same Server's without a mesh (one process,
    one function), K1-fwd launched on every batch."""
    cfg = NARROW_ALEXNET.replace("dev = cpu", "dev = gpu")
    plain = NetTrainer(device="cuda:0", cfg=cfg)
    plain.init_model()
    meshed = NetTrainer(device="cuda:0", cfg=cfg + "mesh = data:2\n",
                        one_process=True)
    meshed.init_model()
    meshed._set_params(plain.state["params"])
    reqs = [_x((n, 3, 35, 35), 40 + n) for n in (1, 3, 2, 5, 8)]
    outs = {}
    for tag, tr in (("plain", plain), ("mesh", meshed)):
        with Server(tr, device="cuda:0") as srv:
            before = kernels.launches()["lrn_fwd"]
            outs[tag] = [srv.submit(r).result(timeout=120) for r in reqs]
            outs[tag + "_launches"] = kernels.launches()["lrn_fwd"] - before
            outs[tag + "_buckets"] = srv.buckets
    assert outs["plain_buckets"] == (1, 2, 4, 8)
    assert outs["mesh_buckets"] == (2, 4, 8)
    assert outs["mesh_launches"] > 0 and outs["plain_launches"] > 0
    for g, w in zip(outs["mesh"], outs["plain"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
