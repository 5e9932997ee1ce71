"""The port on the card: the CUDA kernels (K1-fwd, K1-bwd, the
flash-attention K2-fwd, K2-dq, K2-dkv, and the int8 dot K3) against
their plain versions, and the serving and training paths through them
(AlexNet-shaped, seq_mnist, GoogLeNet.conf and stack_moe.conf steps
against the CPU). Every test here needs an
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
    with pytest.raises(ValueError, match="head_dim 257"):
        FA.tc_plan("attn_fwd", 257)


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
