"""The last CNN-side layer types of the port against the JAX package on
the CPU: concat / ch_concat, gelu, xelu, insanity, prelu,
insanity_max_pooling, fixconn, conv_im2col, `pairtest-A-B` and the
`torch` module type; then whole nets - a net of the random layers
trained for 3 steps with the JAX package's own draws injected, the
one-block inception net of tests/test_example_configs.py (with an lrn)
taking an SGD step, and GoogLeNet.conf's inferred shapes.

The same seeded numpy inputs and the JAX layer's params (carried by
convert.py) go through both layers; the gradients are the vector-Jacobian
products with one seeded numpy cotangent. A layer that draws in training
gets the JAX layer's uniform draw - jax.random.uniform(rng, x.shape) of
the rng handed to the JAX layer - injected through `keep`.

Bars (float32): single layers rtol 1e-5 / atol 1e-6 on outputs, input
gradients and param gradients; whole nets rtol 1e-4 / atol 1e-5 on
params and updater state after each step, the scaled loss rtol 1e-5."""

import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cxxnet_tpu.plugin.torch_adapter  # noqa: F401  (registers "torch")
from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.layers.base import LAYER_REGISTRY as JAX_REGISTRY
from cxxnet_tpu.layers.base import active_step as jax_active_step
from cxxnet_tpu.layers.pairtest import run_pairtest as jax_run_pairtest
from cxxnet_tpu.nnet.net_config import NetConfig as JaxNetConfig
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import parse_config_file
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers import create_layer as port_layer
from cxxnet_tpu_torch.layers import known_layer_types
from cxxnet_tpu_torch.layers.base import active_step
from cxxnet_tpu_torch.layers.pairtest import run_pairtest
from cxxnet_tpu_torch.nnet.net_config import NetConfig
from cxxnet_tpu_torch.nnet.network import Network
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from test_example_configs import _TINY_INCEPTION
from test_torch_train import assert_states_match, jax_loss

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# single layers: forward, input gradients, param gradients
# ---------------------------------------------------------------------------

def uniform_draw(rng, shape):
    """What the JAX layers draw in training (insanity, prelu's noise,
    insanity_max_pooling's flags), in float32."""
    return np.asarray(jax.random.uniform(rng, tuple(shape), jnp.float32))


def both_with_grads(type_name, pairs, in_shapes, *, train=False,
                    draws=False, step=None, seed=0, scale=1.0):
    """Run the JAX layer and the port layer on the same inputs and
    params; return {"out": [(jax, port)], "gx": [...], "gp": {...}}."""
    jl, pl_ = jax_layer(type_name, "l"), port_layer(type_name, "l")
    for k, v in pairs:
        jl.set_param(k, v)
        pl_.set_param(k, v)
    jshapes = jl.infer_shapes(list(in_shapes))
    pshapes = pl_.infer_shapes(list(in_shapes))
    assert [tuple(s) for s in pshapes] == [tuple(s) for s in jshapes]
    jparams = jax.device_get(jl.init_params(jax.random.PRNGKey(seed),
                                            list(in_shapes)))
    pparams = (convert.params_from_numpy(
        {"l": jparams}, {"l": pl_.param_shapes(list(in_shapes))})["l"]
        if jparams else {})
    rs = np.random.RandomState(seed + 1)
    xs = [(rs.randn(*s) * scale).astype(np.float32) for s in in_shapes]
    gs = [rs.randn(*s).astype(np.float32) for s in jshapes]
    rng = jax.random.PRNGKey(seed + 2)

    def jf(p, x):
        with jax_active_step(None if step is None else jnp.int32(step)):
            return jl.apply(p, x, train=train, rng=rng)
    jout, vjp = jax.vjp(jf, jparams, [jnp.asarray(x) for x in xs])
    jgp, jgx = vjp([jnp.asarray(g) for g in gs])

    keep = (torch.from_numpy(uniform_draw(rng, in_shapes[0]))
            if draws else None)
    px = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    pp = {k: v.clone().requires_grad_(True) for k, v in pparams.items()}
    with active_step(step):
        pout = pl_(pp, px, train=train, keep=keep)
    total = sum((o * torch.from_numpy(g)).sum() for o, g in zip(pout, gs))
    grads = torch.autograd.grad(total, px + list(pp.values()),
                                allow_unused=True)
    gx = [torch.zeros_like(t) if g is None else g
          for t, g in zip(px, grads[:len(px)])]
    gp = dict(zip(pp, grads[len(px):]))
    return {
        "out": [(np.asarray(j), p.detach().numpy())
                for j, p in zip(jout, pout)],
        "gx": [(np.asarray(j), p.numpy()) for j, p in zip(jgx, gx)],
        "gp": {k: (np.asarray(jgp[k]), (torch.zeros_like(pp[k])
                                        if gp[k] is None else gp[k]).numpy())
               for k in jgp},
    }


def check_all(res, tol=TOL):
    for name in ("out", "gx"):
        for i, (j, p) in enumerate(res[name]):
            assert p.shape == j.shape
            np.testing.assert_allclose(p, j, **tol, err_msg=f"{name}[{i}]")
    for k, (j, p) in res["gp"].items():
        np.testing.assert_allclose(p, j, **tol, err_msg=f"grad {k}")


@pytest.mark.parametrize("type_name,in_shapes", [
    ("concat", [(2, 1, 1, 3), (2, 1, 1, 5)]),
    ("concat", [(2, 1, 1, 3), (2, 1, 1, 5), (2, 1, 1, 2), (2, 1, 1, 1)]),
    ("ch_concat", [(2, 3, 4, 5), (2, 2, 4, 5)]),
    ("ch_concat", [(2, 3, 4, 5), (2, 1, 4, 5), (2, 4, 4, 5)]),
])
def test_concat(type_name, in_shapes):
    """Forward and each input's gradient; bar rtol 1e-5 / atol 1e-6."""
    check_all(both_with_grads(type_name, [], in_shapes))


@pytest.mark.parametrize("type_name,in_shapes", [
    ("concat", [(2, 1, 1, 3)]),
    ("ch_concat", [(2, 3, 4, 5)] * 5),
    ("ch_concat", [(2, 3, 4, 5), (2, 3, 4, 6)]),
    ("concat", [(2, 1, 1, 3), (3, 1, 1, 3)]),
])
def test_concat_refuses_what_jax_refuses(type_name, in_shapes):
    msgs = []
    for make in (jax_layer, port_layer):
        with pytest.raises(ValueError) as err:
            make(type_name).infer_shapes(list(in_shapes))
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_ch_concat_promotes_mixed_dtypes_as_jax():
    """Branches that end in different dtypes join in the promoted dtype
    (jnp.concatenate's rule)."""
    a = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    out = port_layer("ch_concat")(
        {}, [torch.from_numpy(a).bfloat16(), torch.from_numpy(a)])[0]
    want = jax_layer("ch_concat").apply(
        {}, [jnp.asarray(a, jnp.bfloat16), jnp.asarray(a)], train=False)[0]
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_gelu():
    """gelu (tanh approximation). Bars: the forward rtol 1e-5 / atol
    1e-6 against the JAX layer; the input gradient atol 2e-6 against
    it, and atol 1e-6 against the float64 gradient of the same formula.
    XLA:CPU's tanh rounds differently near saturation: at x = -3.43
    (scale-3 inputs) the JAX gradient is 1.7e-6 from the float64 value,
    the port's 1.2e-7."""
    res = both_with_grads("gelu", [], [(2, 3, 4, 5)], scale=3.0)
    (jo, po), = res["out"]
    np.testing.assert_allclose(po, jo, **TOL)
    (jg, pg), = res["gx"]
    np.testing.assert_allclose(pg, jg, rtol=1e-5, atol=2e-6)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 3, 4, 5) * 3.0).requires_grad_(True)
    g = torch.from_numpy(rs.randn(2, 3, 4, 5))
    from cxxnet_tpu_torch.ops import nn as nn_ops
    (g64,) = torch.autograd.grad((nn_ops.gelu(x) * g).sum(), x)
    np.testing.assert_allclose(pg, g64.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("type_name,pairs", [
    ("xelu", []),
    ("xelu", [("b", "3")]),
    ("insanity", []),
    ("insanity", [("lb", "2"), ("ub", "4")]),
])
def test_activation_eval(type_name, pairs):
    """Eval forward and input gradient; bar rtol 1e-5 / atol 1e-6."""
    check_all(both_with_grads(type_name, pairs, [(2, 3, 4, 5)], scale=3.0))


@pytest.mark.parametrize("pairs,step", [
    ([], 0),
    ([("lb", "3"), ("ub", "8")], 5),
    # the anneal: the range narrows toward its midpoint step by step
    # and stops at calm_end
    ([("calm_start", "-4"), ("calm_end", "6")], 0),
    ([("calm_start", "-4"), ("calm_end", "6")], 3),
    ([("calm_start", "-4"), ("calm_end", "6")], 40),
    # the reference's freeze: calm_start >= 0 never anneals
    ([("calm_start", "2"), ("calm_end", "9")], 7),
])
def test_insanity_train_with_jax_draws(pairs, step):
    """Training forward with the JAX layer's uniform draw injected, at a
    bound update counter; bar rtol 1e-5 / atol 1e-6."""
    check_all(both_with_grads("insanity", pairs, [(2, 3, 4, 5)],
                              train=True, draws=True, step=step, scale=3.0))


@pytest.mark.parametrize("pairs,shape,train", [
    ([], (2, 3, 4, 5), False),
    ([], (3, 1, 1, 6), False),
    ([("init_slope", "0.4")], (2, 3, 4, 5), True),
    ([("random", "0.3")], (2, 3, 4, 5), True),
    ([("random", "0.5"), ("init_slope", "0.9")], (3, 1, 1, 6), True),
    # a slope past 1 is clipped: no gradient reaches it
    ([("init_slope", "1.5")], (2, 3, 4, 5), False),
])
def test_prelu(pairs, shape, train):
    """Forward, input gradient and the slope's gradient, with the JAX
    layer's noise draw injected where `random > 0`; bar rtol 1e-5 /
    atol 1e-6."""
    check_all(both_with_grads("prelu", pairs, [shape], train=train,
                              draws=True, scale=2.0))


def test_prelu_init_and_tag():
    """`random_slope = 1` draws the slope uniform in [0, init_slope) -
    same distribution, another generator - and the slope is visited
    under the `bias` tag in both packages."""
    lay = port_layer("prelu")
    for k, v in (("random_slope", "1"), ("init_slope", "0.5")):
        lay.set_param(k, v)
    slope = lay.init_params(torch.Generator().manual_seed(0),
                            [(2, 64, 3, 3)])["slope"]
    assert slope.shape == (64,)
    assert float(slope.min()) >= 0.0 and float(slope.max()) < 0.5
    assert float(slope.std()) > 0.05
    assert lay.param_tags() == jax_layer("prelu").param_tags() == {
        "slope": "bias"}


@pytest.mark.parametrize("pairs,shape,train", [
    ([("kernel_size", "3"), ("stride", "2")], (2, 3, 7, 7), False),
    ([("kernel_size", "3"), ("stride", "2"), ("keep", "0.6")],
     (2, 3, 7, 7), True),
    ([("kernel_size", "2"), ("stride", "1"), ("keep", "0.2")],
     (2, 2, 5, 6), True),
    ([("kernel_size", "3"), ("stride", "3"), ("keep", "1")],
     (1, 2, 6, 6), True),
])
def test_insanity_max_pooling(pairs, shape, train):
    """Displaced reads from the JAX layer's flags, the backward crediting
    window slots (ties duplicated); bar rtol 1e-5 / atol 1e-6."""
    check_all(both_with_grads("insanity_max_pooling", pairs, [shape],
                              train=train, draws=True, scale=2.0))


@pytest.mark.parametrize("pairs,match", [
    ([("kernel_size", "3"), ("pad", "1")], "does not support pad"),
    ([("kernel_size", "3"), ("pool_grad", "winner")], "no single-winner"),
])
def test_insanity_max_pooling_refusals(pairs, match):
    for make in (jax_layer, port_layer):
        lay = make("insanity_max_pooling")
        with pytest.raises(ValueError, match=match):
            for k, v in pairs:
                lay.set_param(k, v)
            lay.infer_shapes([(1, 2, 6, 6)])


def _fixconn_file(tmp_path, nrow, ncol, seed=0):
    rs = np.random.RandomState(seed)
    trip = [(int(rs.randint(nrow)), int(rs.randint(ncol)),
             float(np.float32(rs.randn()))) for _ in range(7)]
    path = tmp_path / "w.txt"
    path.write_text(f"{nrow} {ncol} {len(trip)}\n" + "".join(
        f"{r} {c} {v!r}\n" for r, c, v in trip))
    return str(path)


def test_fixconn(tmp_path):
    """The frozen sparse weight: forward and input gradient; no params,
    no param gradient; bar rtol 1e-5 / atol 1e-6."""
    path = _fixconn_file(tmp_path, 4, 6)
    res = both_with_grads("fixconn", [("nhidden", "4"),
                                      ("fixconn_weight", path)],
                          [(3, 1, 1, 6)])
    assert res["gp"] == {}
    check_all(res)
    lay = port_layer("fixconn")
    assert lay.param_shapes([(3, 1, 1, 6)]) == {}


@pytest.mark.parametrize("nhidden,shape,with_file", [
    ("5", (3, 1, 1, 6), True),    # the file's shape is 4 x 6
    ("4", (3, 2, 1, 6), True),    # not a matrix node
    ("4", (3, 1, 1, 6), False),   # no fixconn_weight
])
def test_fixconn_refuses_what_jax_refuses(tmp_path, nhidden, shape,
                                          with_file):
    pairs = [("nhidden", nhidden)]
    if with_file:
        pairs.append(("fixconn_weight", _fixconn_file(tmp_path, 4, 6)))
    msgs = []
    for make in (jax_layer, port_layer):
        lay = make("fixconn")
        for k, v in pairs:
            lay.set_param(k, v)
        with pytest.raises(ValueError) as err:
            lay.infer_shapes([shape])
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


CONV_CASES = [
    [("nchannel", "6"), ("kernel_size", "3")],
    [("nchannel", "6"), ("kernel_size", "3"), ("ngroup", "2"),
     ("pad", "1"), ("stride", "2")],
    [("nchannel", "4"), ("kernel_height", "3"), ("kernel_width", "5"),
     ("pad_y", "1"), ("pad_x", "2"), ("no_bias", "1")],
]


@pytest.mark.parametrize("pairs", CONV_CASES)
def test_conv_im2col(pairs):
    """im2col + GEMM against the JAX conv_im2col: forward, input and
    weight gradients; bar rtol 1e-5 / atol 1e-6 (relative to values of
    order 1)."""
    check_all(both_with_grads("conv_im2col", pairs, [(2, 4, 9, 9)]),
              tol=dict(rtol=1e-5, atol=2e-6))


@pytest.mark.parametrize("pairs", CONV_CASES)
def test_pairtest_conv_vs_im2col(pairs):
    """pairtest-conv-conv_im2col forwards conv's output (against the JAX
    pairtest) and run_pairtest finds master and slave within 1e-5, as
    the JAX harness does."""
    check_all(both_with_grads("pairtest-conv-conv_im2col", pairs,
                              [(2, 4, 9, 9)]),
              tol=dict(rtol=1e-5, atol=2e-6))
    lay = port_layer("pairtest-conv-conv_im2col", "pt")
    for k, v in pairs:
        lay.set_param(k, v)
    rep = run_pairtest(lay, [(2, 4, 9, 9)])
    jl = jax_layer("pairtest-conv-conv_im2col", "pt")
    for k, v in pairs:
        jl.set_param(k, v)
    want = jax_run_pairtest(jl, [(2, 4, 9, 9)])
    assert sorted(rep) == sorted(want)
    assert max(rep.values()) < 1e-5, rep


def test_pairtest_routing_print_and_syntax(capsys):
    """master: / slave: keys reach one side; pairtest_print reports
    every output past pairtest_tol; a malformed type raises the JAX
    message."""
    lay = port_layer("pairtest-xelu-xelu", "pt")
    lay.set_param("master:b", "2")
    lay.set_param("slave:b", "4")
    lay.set_param("pairtest_print", "1")
    assert (lay.master.b, lay.slave.b) == (2.0, 4.0)
    x = torch.from_numpy(np.full((1, 1, 1, 4), -8.0, np.float32))
    out = lay({}, [x])[0]
    np.testing.assert_array_equal(out.numpy(), np.full((1, 1, 1, 4), -4.0))
    # |-4 - -2| / |-2|
    assert lay.last_errors == [pytest.approx(1.0, rel=1e-5)]
    assert "PairTest[pt] out[0] max rel err 0.99" in capsys.readouterr().out
    lay.set_param("pairtest_tol", "1.5")
    lay({}, [x])
    assert capsys.readouterr().out == ""
    for bad in ("pairtest-conv", "pairtest--conv"):
        msgs = []
        for make in (jax_layer, port_layer):
            with pytest.raises(ValueError) as err:
                make(bad)
            msgs.append(str(err.value))
        assert msgs[1] == msgs[0]


@pytest.mark.parametrize("expr,shape", [
    ("nn.Conv2d(3, 4, 3, padding=1)", (2, 3, 5, 5)),
    ("nn.Sequential(nn.Conv2d(2, 3, 1), nn.Tanh(), nn.Conv2d(3, 2, 3))",
     (2, 2, 6, 6)),
])
def test_torch_module_layer(expr, shape):
    """A torch module in the graph against the JAX package's host-callback
    adapter: the same params (the JAX side's module init, carried), the
    forward, the input gradient and each param's gradient; bar rtol
    1e-5 / atol 1e-6."""
    pairs = [("torch_module", expr)]
    res = both_with_grads("torch", pairs, [shape])
    check_all(res)
    jl, pl_ = jax_layer("torch"), port_layer("torch")
    jl.set_param(*pairs[0])
    pl_.set_param(*pairs[0])
    assert pl_.param_tags() == jl.param_tags()
    pl_.infer_shapes([shape])
    assert set(pl_.param_shapes([shape])) == set(res["gp"])
    # the module's parameters stay out of the network's own
    assert list(pl_.parameters()) == []


def test_torch_module_layer_needs_an_expression():
    for make in (jax_layer, port_layer):
        with pytest.raises(ValueError, match="must set torch_module"):
            make("torch").infer_shapes([(1, 3, 4, 4)])


def test_layer_registry_equals_jax():
    """Every JAX layer type is a port layer type (the `torch` plugin
    included); the pairtest-A-B form is built by both factories."""
    assert known_layer_types() == sorted(JAX_REGISTRY)
    assert port_layer("pairtest-relu-tanh").master.type_name == "relu"
    from cxxnet_tpu_torch.layers.base import _NOT_PORTED
    assert sorted(_NOT_PORTED) == []


# ---------------------------------------------------------------------------
# whole nets
# ---------------------------------------------------------------------------

RANDOM_NET = """
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 4
layer[1->2] = insanity_max_pooling
  kernel_size = 3
  stride = 2
  keep = 0.5
layer[2->3] = prelu:pr
  random = 0.3
layer[3->4] = flatten
layer[4->5] = fullc:f1
  nhidden = 12
layer[5->6] = insanity
  calm_start = -2
  calm_end = 5
layer[6->7] = fullc:f2
  nhidden = 5
layer[7->7] = softmax
netconfig=end
input_shape = 2,9,9
batch_size = 6
random_type = xavier
eta = 0.1
momentum = 0.9
wd = 0.0005
silent = 1
seed = 5
dev = cpu
"""


def jax_draws(pt, seed, step):
    """The JAX trainer's uniform draws at `step` for every layer that
    draws (the port's injected `keep`)."""
    out = {}
    rng = jax.random.fold_in(jax.random.PRNGKey(seed + 100), step)
    for idx, info in enumerate(pt.net_cfg.layers):
        if info.type_name in ("insanity", "insanity_max_pooling", "prelu"):
            shape = pt.net.node_shapes[info.nindex_in[0]]
            out[idx] = uniform_draw(jax.random.fold_in(rng, idx), shape)
    return out


def trainer_pair(conf):
    jt = JaxTrainer(cfg=conf)
    jt.init_model()
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    convert.train_state_from_numpy(pt, {
        "params": jax.device_get(jt.state["params"]),
        "ustate": jax.device_get(jt.state["ustate"]),
        "epoch": jt.epoch})
    return jt, pt


def jax_loss_at_step(jt, batch):
    """jax_loss with the update counter bound as the JAX train step binds
    it (epoch * update_period + accumulated steps)."""
    step = jt.epoch * jt.update_period + int(jt.state["count"])
    with jax_active_step(jnp.int32(step)):
        return jax_loss(jt, batch)


def test_random_layers_train_with_jax_draws():
    """insanity_max_pooling, prelu's noise and insanity's anneal in a
    net, 3 SGD steps with the JAX trainer's own draws injected (the
    anneal reads the update counter each trainer binds); bar rtol 1e-4 /
    atol 1e-5 on params and updater state, rtol 1e-5 on the loss."""
    jt, pt = trainer_pair(RANDOM_NET)
    rs = np.random.RandomState(0)
    for step in range(3):
        data = (rs.randn(6, 2, 9, 9) * 2).astype(np.float32)
        label = rs.randint(0, 5, (6, 1)).astype(np.float32)
        want = jax_loss_at_step(jt, JaxBatch(data=data, label=label))
        jt.update(JaxBatch(data=data, label=label))
        got = pt.update(DataBatch(data=data, label=label),
                        keep=jax_draws(pt, jt.seed, step))
        assert float(got) == pytest.approx(want, rel=1e-5)
        assert_states_match(jt, pt)


def inception_conf():
    """_TINY_INCEPTION with an lrn after c1r, float32 on the CPU."""
    conf = _TINY_INCEPTION.replace(
        "layer[c1->c1r] = relu\n",
        "layer[c1->c1q] = relu\nlayer[c1q->c1r] = lrn\n"
        "  local_size = 5\n  alpha = 0.001\n  beta = 0.75\n  knorm = 1\n")
    assert "= lrn" in conf
    return conf + "silent = 1\nmomentum = 0.9\n"


def test_tiny_inception_sgd_steps_match_jax():
    """Three branches and a stride-1 padded pool into a ch_concat, an
    lrn, an SGD step at a time for 2 steps; bar rtol 1e-4 / atol 1e-5 on
    params and updater state, rtol 1e-5 on the loss."""
    jt, pt = trainer_pair(inception_conf())
    rs = np.random.RandomState(1)
    for _ in range(2):
        data = rs.randn(8, 3, 8, 8).astype(np.float32)
        label = rs.randint(0, 5, (8, 1)).astype(np.float32)
        want = jax_loss(jt, JaxBatch(data=data, label=label))
        jt.update(JaxBatch(data=data, label=label))
        got = pt.update(DataBatch(data=data, label=label))
        assert float(got) == pytest.approx(want, rel=1e-5)
        assert_states_match(jt, pt)


def test_tiny_inception_autocast_plan_casts_every_branch():
    """Under dtype = bfloat16 the autocast plan stamps the ch_concat and
    casts each branch's output to its dtype; the bf16 step is finite and
    the prediction matches the JAX package's to bf16's rounding."""
    conf = inception_conf() + "dtype = bfloat16\ngraph_passes = autocast\n"
    jt, pt = trainer_pair(conf)
    cat = [i for i, info in enumerate(pt.net_cfg.layers)
           if info.type_name == "ch_concat"][0]
    assert pt.net.dtype_plan[cat] == torch.bfloat16
    data = np.random.RandomState(2).randn(8, 3, 8, 8).astype(np.float32)
    label = np.zeros((8, 1), np.float32)
    assert np.isfinite(float(pt.update(DataBatch(data=data, label=label))))
    jt.update(JaxBatch(data=data, label=label))
    got = pt.predict_dist(DataBatch(data=data, label=label))
    want = np.asarray(jt.predict_dist(JaxBatch(data=data, label=label)))
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)


def test_tiny_inception_checkpoint_from_jax_predicts_the_same():
    """A JAX-written checkpoint of the inception net loads in the port
    and gives the same softmax rows; bar rtol 1e-5 / atol 1e-6."""
    jt = JaxTrainer(cfg=inception_conf())
    jt.init_model()
    buf = io.BytesIO()
    jt.save_model(buf)
    pt = NetTrainer(cfg=inception_conf(), device="cpu")
    pt.load_model(io.BytesIO(buf.getvalue()))
    data = np.random.RandomState(3).randn(8, 3, 8, 8).astype(np.float32)
    label = np.zeros((8, 1), np.float32)
    np.testing.assert_allclose(
        pt.predict_dist(DataBatch(data=data, label=label)),
        np.asarray(jt.predict_dist(JaxBatch(data=data, label=label))),
        **TOL)


def test_googlenet_conf_shapes():
    """The port infers GoogLeNet.conf's shapes to the JAX package's
    checks (tests/test_example_configs.py:15-34) and to every node of
    the JAX network."""
    from cxxnet_tpu.nnet.network import Network as JaxNetwork
    conf = os.path.join(REPO, "examples", "ImageNet", "GoogLeNet.conf")
    cfg = NetConfig()
    cfg.configure(parse_config_file(conf))
    net = Network(cfg, 4)
    assert net.node_shapes[cfg.num_nodes - 1] == (4, 1, 1, 1000)
    for name, (c, hw) in {"i3a": (256, 28), "i4e": (832, 14),
                          "i5b": (1024, 7), "gap": (1024, 1)}.items():
        assert net.node_shapes[cfg.node_name_map[name]] == (4, c, hw, hw)
    jcfg = JaxNetConfig()
    jcfg.configure(parse_config_file(conf))
    jnet = JaxNetwork(jcfg, 4)
    assert [tuple(s) for s in net.node_shapes] == \
        [tuple(s) for s in jnet.node_shapes]
    assert net.param_shapes() == _jax_param_shapes(jnet)
    assert sum(t == "ch_concat" for t in
               (info.type_name for info in cfg.layers)) == 9


def _jax_param_shapes(jnet):
    shapes = jax.eval_shape(lambda: jnet.init_params(jax.random.PRNGKey(0)))
    return {k: {n: tuple(s.shape) for n, s in v.items()}
            for k, v in shapes.items()}
