"""Each layer of the serving slice against the JAX package: the same
config pairs build a JAX layer and a port layer, the JAX params cross
through convert.py, and the same numpy input goes through
`layer.apply(params, [x], train=False)` and the port layer.

Tolerance (float32 throughout): rtol 1e-5 / atol 1e-6 - the same sums
taken in another order (XLA:CPU against torch's CPU kernels), a few ulp
at these sizes."""

import numpy as np
import pytest
import torch

import jax

from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.layers import create_layer as port_layer

TOL = dict(rtol=1e-5, atol=1e-6)


def run_both(type_name, pairs, in_shape, seed=0, scale=1.0):
    """(jax output, port output, jax shapes, port shapes)."""
    jl, pl_ = jax_layer(type_name, "l"), port_layer(type_name, "l")
    for k, v in pairs:
        jl.set_param(k, v)
        pl_.set_param(k, v)
    jshapes = jl.infer_shapes([in_shape])
    pshapes = pl_.infer_shapes([in_shape])
    jparams = jax.device_get(jl.init_params(jax.random.PRNGKey(seed),
                                            [in_shape]))
    pparams = convert.params_from_numpy(
        {"l": jparams}, {"l": pl_.param_shapes([in_shape])})["l"] \
        if jparams else {}
    x = (np.random.RandomState(seed + 1).randn(*in_shape)
         * scale).astype(np.float32)
    jout = jl.apply(jparams, [jax.numpy.asarray(x)], train=False)
    with torch.inference_mode():
        pout = pl_(pparams, [torch.from_numpy(x)])
    return (np.asarray(jout[0]), pout[0].numpy(), jshapes, pshapes)


def check(type_name, pairs, in_shape, **kw):
    jout, pout, jshapes, pshapes = run_both(type_name, pairs, in_shape, **kw)
    assert [tuple(s) for s in jshapes] == [tuple(s) for s in pshapes]
    assert pout.shape == jout.shape == tuple(jshapes[0])
    np.testing.assert_allclose(pout, jout, **TOL)


@pytest.mark.parametrize("pairs,in_shape", [
    ([("nchannel", "6"), ("kernel_size", "3")], (2, 4, 9, 9)),
    ([("nchannel", "6"), ("kernel_size", "3"), ("ngroup", "2"),
      ("pad", "1"), ("stride", "2")], (2, 4, 9, 9)),
    ([("nchannel", "8"), ("kernel_size", "5"), ("ngroup", "2"),
      ("pad", "2")], (2, 6, 7, 7)),
    # AlexNet's conv1 geometry (11x11 / 4, the JAX package's
    # space-to-depth candidate, inert in the port)
    ([("nchannel", "4"), ("kernel_size", "11"), ("stride", "4"),
      ("init_bias", "0.5")], (1, 3, 27, 27)),
    ([("nchannel", "4"), ("kernel_height", "3"), ("kernel_width", "5"),
      ("pad_y", "1"), ("pad_x", "2"), ("no_bias", "1"),
      ("random_type", "kaiming")], (2, 3, 6, 8)),
])
def test_conv(pairs, in_shape):
    check("conv", pairs, in_shape)


@pytest.mark.parametrize("pairs,in_shape", [
    ([("nhidden", "7")], (3, 1, 1, 12)),
    ([("nhidden", "5"), ("init_bias", "0.3"), ("random_type", "xavier")],
     (2, 1, 1, 30)),
    ([("nhidden", "4"), ("no_bias", "1")], (2, 1, 1, 9)),
])
def test_fullc(pairs, in_shape):
    check("fullc", pairs, in_shape)


@pytest.mark.parametrize("type_name", ["relu", "sigmoid", "tanh",
                                       "softplus", "flatten"])
def test_elementwise_and_flatten(type_name):
    check(type_name, [], (2, 3, 4, 5), scale=3.0)


@pytest.mark.parametrize("type_name", ["softmax", "l2_loss",
                                       "multi_logistic"])
def test_loss_forward_transform(type_name):
    check(type_name, [], (4, 1, 1, 10), scale=3.0)


@pytest.mark.parametrize("mode", ["max_pooling", "sum_pooling",
                                  "avg_pooling", "relu_max_pooling"])
@pytest.mark.parametrize("in_hw,k,s,pad,out_hw", [
    (6, 3, 2, 0, 3),     # the ceil formula pads high: a truncated window
    (55, 3, 2, 0, 27),   # AlexNet pool1
    (13, 3, 2, 0, 6),    # AlexNet pool3
    (7, 3, 2, 1, 4),     # symmetric pad
    (5, 3, 1, 2, 7),     # pad > k/2: legal in the reference, not in torch
])
def test_pooling(mode, in_hw, k, s, pad, out_hw):
    pairs = [("kernel_size", str(k)), ("stride", str(s)), ("pad", str(pad))]
    jout, pout, _, pshapes = run_both(mode, pairs, (2, 3, in_hw, in_hw),
                                      scale=2.0)
    assert pshapes[0][2:] == (out_hw, out_hw)
    np.testing.assert_allclose(pout, jout, **TOL)


@pytest.mark.parametrize("pairs", [
    [("local_size", "5"), ("alpha", "0.001"), ("beta", "0.75"),
     ("knorm", "1")],
    [("local_size", "2"), ("alpha", "0.01"), ("beta", "0.5"),
     ("knorm", "2")],
])
def test_lrn(pairs):
    check("lrn", pairs, (2, 13, 4, 5), scale=4.0)


def test_dropout_is_identity_at_inference():
    jout, pout, _, _ = run_both("dropout", [("threshold", "0.5")],
                                (2, 1, 1, 16))
    np.testing.assert_array_equal(pout, jout)


def test_space_to_depth_is_inert():
    a = run_both("conv", [("nchannel", "4"), ("kernel_size", "11"),
                          ("stride", "4"), ("space_to_depth", "1")],
                 (1, 3, 27, 27))
    np.testing.assert_allclose(a[1], a[0], **TOL)


@pytest.mark.parametrize("type_name,key,val", [
    ("conv", "fused_act", "sigmoid"),
    ("fullc", "flatten_input", "yes"),
    ("fullc", "layer_dtype", "float16"),
    ("conv", "layer_quant", "int4"),
])
def test_graph_pass_stamps_raise(type_name, key, val):
    """The graph passes' stamps and pins are ported; a value neither
    package accepts raises in both."""
    for layer in (port_layer(type_name), jax_layer(type_name)):
        with pytest.raises(ValueError):
            layer.set_param(key, val)


@pytest.mark.parametrize("type_name", ["xelu", "insanity",
                                       "transformer_stack", "moe", "prelu"])
def test_layer_types_not_yet_ported_raise(type_name):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_layer(type_name)
