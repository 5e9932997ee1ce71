"""The port on the card: the CUDA kernels against their plain versions,
and the serving and training paths through them. Every test here needs
an NVIDIA card and skips without one (marker `cuda`). This file imports no jax, so it
runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import convert, kernels
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
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
    assert kernels.launches() == {"lrn_fwd": 2, "lrn_bwd": 2}
    lc = cpu.update(DataBatch(data=data, label=label), keep=keep)
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    shapes = cpu.net.param_shapes()
    pg = convert.params_to_numpy(gpu.state["params"], shapes)
    pc = convert.params_to_numpy(cpu.state["params"], shapes)
    for lk in pc:
        for pn in pc[lk]:
            np.testing.assert_allclose(pg[lk][pn], pc[lk][pn], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{lk}/{pn}")
