"""The port's int8 vocabulary (cxxnet_tpu_torch/ops/int8.py) against the
JAX package's (cxxnet_tpu/ops/int8.py) on the CPU, from numpy-seeded
inputs: the scale arithmetic, K3's plain version against the Pallas
kernel (interpret mode) and the lax route, the im2col int8 convolution
against lax.conv, and the int8 branch of the fullc and conv layers.

Everything here is integer arithmetic or one float32 rounding taken in
the same order in both packages, so the bar is bitwise equality, except
the layer forwards of the last tests (rtol 1e-6 - see there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.ops import int8 as J
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.layers import create_layer as port_layer
from cxxnet_tpu_torch.ops import int8 as P


def _bf16(a):
    """float32 -> bfloat16-rounded float32 (round to nearest even)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()


def _weights(shape, seed):
    w = (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)
    w[1] = 0.0  # an all-zero channel: scale floored, weights quantize to 0
    # a channel whose absmax is 127: scale exactly 1.0, so the .5 values
    # sit on the rounding boundary (half to even)
    w[2] = np.resize(np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5],
                              np.float32), w[2].shape)
    return w


@pytest.mark.parametrize("shape", [(6, 36), (8, 3, 5, 5), (4, 2, 3, 3)])
def test_per_channel_scale_bitwise(shape):
    w = _weights(shape, 1)
    got = P.per_channel_scale(torch.from_numpy(w))
    want = J.per_channel_scale(w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[2] == np.float32(1.0)
    assert got[1] == np.float32(np.float32(1e-8) / np.float32(127.0))


@pytest.mark.parametrize("shape", [(6, 36), (8, 3, 5, 5)])
@pytest.mark.parametrize("bf16_scale", [False, True])
def test_quantize_weight_bitwise(shape, bf16_scale):
    w = _weights(shape, 2)
    s = J.per_channel_scale(w)
    if bf16_scale:
        s = _bf16(s).numpy()
    want = np.asarray(J.quantize_weight(jnp.asarray(w), s))
    got = P.quantize_weight(torch.from_numpy(w), s)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if not bf16_scale:  # half to even on the boundary channel
        np.testing.assert_array_equal(
            got.numpy()[2].reshape(-1)[:7], [127, 2, -4, 0, 0, 2, 126])


@pytest.mark.parametrize("scale", [0.5, 2.3 / 127.0, 1e-9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_act_bitwise(scale, dtype):
    x = (np.random.RandomState(3).randn(4, 3, 9, 9) * 1.2).astype(np.float32)
    x.reshape(-1)[:6] = [1.25, -1.25, 0.75, 0.25, 63.75, -200.0]
    xt = torch.from_numpy(x).to(dtype)
    s32 = np.float32(scale)
    s_bf = _bf16(s32).numpy()  # the scale as _cast rounds it
    for s in (s32, s_bf):
        want = np.asarray(J.quantize_act(
            jnp.asarray(xt.float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
            jnp.asarray(s)))
        got = P.quantize_act(xt, s)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    if scale == 0.5 and dtype == torch.float32:
        # x / s = 2.5, -2.5, 1.5, 0.5, 127.5, -400: half to even, clip
        np.testing.assert_array_equal(
            P.quantize_act(xt, s32).numpy().reshape(-1)[:6],
            [2, -2, 2, 0, 127, -127])


def test_act_scale_is_float64_and_weight_scale_float32():
    """The activation scale is Python float64 arithmetic (rounded to
    float32 only when staged); the weight scale is float32 arithmetic.
    Both as the JAX package computes them. For a float32 absmax the two
    agree once the float64 quotient is rounded to float32 (a quotient
    rounded through float64 rounds like the direct float32 one, since
    53 >= 2 * 24 + 2): the staged values are the same, the unstaged
    float64 value is not a float32."""
    for amax in (0.0, 1e-9, 0.3, 2.135, 1234.5):
        assert P.act_scale(amax) == float(max(amax, 1e-8)) / 127.0
    wide = 0
    for amax in np.random.RandomState(0).rand(2000).astype(np.float32):
        a = P.act_scale(float(amax))
        w = P.per_channel_scale(np.array([[amax]], np.float32))[0]
        assert np.float32(a) == w
        wide += int(float(np.float32(a)) != a)
    assert wide > 1900


@pytest.mark.parametrize("bf16", [False, True])
def test_dequantize_bitwise(bf16):
    r = np.random.RandomState(4)
    ws = J.per_channel_scale(r.randn(5, 7).astype(np.float32))
    a = np.float32(P.act_scale(3.7))
    if bf16:
        ws, a = _bf16(ws).numpy(), _bf16(a).numpy()
    for shape in ((9, 5), (2, 5, 3, 4)):
        acc = r.randint(-2 ** 30, 2 ** 30, shape).astype(np.int32)
        want = np.asarray(J.dequantize(jnp.asarray(acc), jnp.asarray(a),
                                       jnp.asarray(ws)))
        got = P.dequantize(torch.from_numpy(acc), a, ws)
        np.testing.assert_array_equal(got.numpy(), want)


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(
        np.int8)


@pytest.mark.parametrize("m,k,n", [(32, 128, 128), (64, 256, 128),
                                   (32, 384, 256)])
def test_k3_plain_version_equals_pallas_kernel(m, k, n):
    """Tile-clean shapes: the Pallas kernel itself (interpret mode, as
    tests/test_quantize.py runs it) against the port's plain version."""
    xq, wq = _ints((m, k), 5), _ints((n, k), 6)
    assert J._pallas_blocks(m, k, n) is not None
    old = J._FORCE_INTERPRET
    J._FORCE_INTERPRET = True
    try:
        want = np.asarray(J._matmul_pallas(xq, wq))
    finally:
        J._FORCE_INTERPRET = old
    got = P.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(1, 3, 1), (17, 363, 1000), (100, 1201, 1),
                                   (16, 512, 2048), (64, 9216, 40),
                                   (5, 4096, 1000)])
def test_k3_plain_version_equals_lax_route(m, k, n):
    """Ragged shapes (the lax preferred-element-type route) and the
    path's shapes, extreme values included: all +-127."""
    xq, wq = _ints((m, k), 7), _ints((n, k), 8)
    xq[0] = 127
    wq[0] = -127
    want = np.asarray(J.int8_matmul(jnp.asarray(xq), jnp.asarray(wq)))
    got = P.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == -127 * 127 * k


# AlexNet's conv geometries at narrow channels: conv1 (k11 s4), conv2
# (k5 pad 2, 2 groups), conv3-5 (k3 pad 1, 2 groups and 1)
CONV_CASES = [((2, 3, 35, 35), (8, 3, 11, 11), 4, 0, 1),
              ((2, 8, 13, 13), (16, 4, 5, 5), 1, 2, 2),
              ((2, 16, 7, 7), (12, 8, 3, 3), 1, 1, 2),
              ((1, 6, 7, 9), (5, 6, 3, 3), 1, 1, 1)]


@pytest.mark.parametrize("xs,ws,stride,pad,group", CONV_CASES)
def test_int8_conv2d_bitwise(xs, ws, stride, pad, group):
    xq, wq = _ints(xs, 9), _ints(ws, 10)
    want = np.asarray(J.int8_conv2d(jnp.asarray(xq), jnp.asarray(wq),
                                    stride, pad, pad, group))
    got = P.int8_conv2d(torch.from_numpy(xq), torch.from_numpy(wq), stride,
                        pad, pad, group)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        P.int8_conv2d_reference(torch.from_numpy(xq), torch.from_numpy(wq),
                                stride, pad, pad, group).numpy(), want)


def _int8_params(w, b, amax):
    ws = J.per_channel_scale(w)
    return {"wmat_q": np.asarray(J.quantize_weight(jnp.asarray(w), ws)),
            "wscale": ws, "ascale": np.float32(P.act_scale(amax)),
            "bias": b}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer,pairs,in_shape,w_shape", [
    ("fullc", [("nhidden", "12"), ("fused_act", "relu")], (5, 1, 1, 40),
     (12, 40)),
    ("fullc", [("nhidden", "7"), ("flatten_input", "1")], (3, 2, 4, 4),
     (7, 32)),
    ("conv", [("nchannel", "8"), ("kernel_size", "3"), ("pad", "1"),
              ("ngroup", "2"), ("fused_act", "relu")], (2, 4, 9, 9),
     (8, 2, 3, 3)),
])
def test_layer_int8_branch_matches_jax(layer, pairs, in_shape, w_shape,
                                       dtype):
    """The fullc / conv int8 branch: quantize, int32 contraction,
    dequantize, bias and fused relu in float32, back to the input's
    dtype. float32: rtol 1e-6 (XLA may fuse the dequantize multiply
    and the bias add into one multiply-add, one rounding fewer);
    bfloat16: within one bfloat16 ulp (the same float32 value rounded
    once)."""
    r = np.random.RandomState(11)
    x = r.randn(*in_shape).astype(np.float32)
    w = (r.randn(*w_shape) * 0.2).astype(np.float32)
    b = (r.randn(w_shape[0]) * 0.1).astype(np.float32)
    params = _int8_params(w, b, float(np.abs(x).max()) * 0.8)
    jl, pl_ = jax_layer(layer, "l"), port_layer(layer, "l")
    for k, v in pairs:
        jl.set_param(k, v)
        pl_.set_param(k, v)
    assert jl.infer_shapes([in_shape]) == pl_.infer_shapes([in_shape])
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                    [jnp.asarray(x).astype(jd)], train=False)[0]
    with torch.inference_mode():
        got = pl_({k: torch.as_tensor(np.array(v))
                   for k, v in params.items()},
                  [torch.from_numpy(x).to(td)])[0]
    assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -8
                      + 1e-30)


def test_k3_splits_fill_the_card():
    """Split-k only where the output has too few 128 x 256 tiles: fc6 /
    fc7 / fc8 at 64 rows, not the im2col GEMMs of the convolutions."""
    assert P.k3_splits(64, 4096, 9216) == 8
    assert P.k3_splits(64, 4096, 4096) == 8
    assert P.k3_splits(64, 1000, 4096) == 16
    assert P.k3_splits(193600, 96, 363) == 1
    assert P.k3_splits(4096, 4096, 4096) == 1
    assert P.k3_splits(1, 1, 3) == 1  # fewer than 4 stages: no split


def test_cpu_path_takes_the_plain_version_and_k3_refuses_cpu():
    xq = torch.from_numpy(_ints((3, 20), 12))
    wq = torch.from_numpy(_ints((4, 20), 13))
    before = kernels.launches()["int8_mm"]
    np.testing.assert_array_equal(P.int8_matmul(xq, wq).numpy(),
                                  P.int8_matmul_reference(xq, wq).numpy())
    assert kernels.launches()["int8_mm"] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        P.int8_mm(xq, wq)
    assert "int8_mm" in kernels.SOURCES and "int8_mm" in kernels.LAUNCHES
