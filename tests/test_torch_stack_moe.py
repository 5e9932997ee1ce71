"""transformer_stack and moe of the port on the CPU, against the JAX
package: each layer alone (forward, input gradients, param gradients;
moe dense and under moe_capacity, with its auxiliary loss and a padded
row mask), then examples/LongSeq/stack_moe.conf as a whole in float32 at
batch 4 - the loss including the aux term and SGD steps, dense and with
moe_capacity = 1.25, on a padded short batch - a JAX-written checkpoint
predicting the same rows in the port, and the Server on it.

Routing near ties: top-k over router probabilities that lie within
rounding of each other could pick different experts in the two
packages. Each test asserts first that the JAX and port top-k index
tensors are equal (single layers) or that every token's top-k margin -
the gap between the k-th and (k+1)-th probability and between the first
two - exceeds 1e-4 at the moe input of the JAX forward (whole nets).

Bars (float32; XLA:CPU and torch sum in other orders):
- single layers: outputs, aux, input and param gradients rtol 1e-5 /
  atol 1e-6, except transformer_stack, which takes
  tests/test_torch_seq.py's attention bars (outputs rtol 1e-5 / atol
  1e-5, gradients rtol 1e-4 / atol 1e-5: the JAX package's blockwise
  core and the port's flash core accumulate the softmax in other
  orders, and four blocks compound it);
- whole nets: the scaled loss (with aux) rtol 1e-5, params and updater
  state rtol 1e-4 / atol 1e-5 after each step, predicted rows rtol
  1e-5 / atol 1e-6."""

import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers import create_layer as port_layer
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Server
from test_torch_train import assert_states_match, jax_keep, jax_loss

TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_OUT_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACK_CONF = os.path.join(REPO, "examples", "LongSeq", "stack_moe.conf")


def pair(type_name, settings, in_shape, seed=1, jitter=0.0):
    """JAX and port layers configured alike, the JAX params (plus seeded
    jitter on the constant ones) as numpy."""
    jl, pl_ = jax_layer(type_name, "l"), port_layer(type_name, "l")
    for k, v in settings:
        jl.set_param(k, v)
        pl_.set_param(k, v)
    assert pl_.infer_shapes([in_shape]) == jl.infer_shapes([in_shape])
    jp = {n: np.asarray(a) for n, a in
          jl.init_params(jax.random.PRNGKey(seed), [in_shape]).items()}
    assert {n: a.shape for n, a in jp.items()} == {
        n: tuple(s) for n, s in pl_.param_shapes([in_shape]).items()}
    assert pl_.param_tags() == jl.param_tags()
    rng = np.random.RandomState(seed + 10)
    jp = {n: (a + jitter * rng.randn(*a.shape)).astype(np.float32)
          for n, a in jp.items()}
    return jl, pl_, jp


# ---------------------------------------------------------------------------
# transformer_stack
# ---------------------------------------------------------------------------

STACK_CASES = {
    "two_blocks": ([("nlayer", "2"), ("nhead", "2"), ("nhidden", "12"),
                    ("random_type", "xavier")], (2, 1, 6, 8)),
    "causal": ([("nlayer", "3"), ("nhead", "4"), ("nhidden", "8"),
                ("causal", "1"), ("eps", "1e-3")], (3, 1, 5, 8)),
    # stack_moe.conf's block: 28 steps, embed 28, 4 heads of 7
    "stack_moe_block": ([("nlayer", "4"), ("nhead", "4"),
                         ("nhidden", "112"), ("random_type", "xavier")],
                        (2, 1, 28, 28)),
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_transformer_stack_matches_jax(case):
    """The stacked blocks against the JAX layer's sequential route:
    outputs, and the vector-Jacobian product of a seeded cotangent with
    respect to the input and every stacked param (the norms' constant
    init jittered so their gradients are not trivial)."""
    settings, shape = STACK_CASES[case]
    jl, pl_, jp = pair("transformer_stack", settings, shape, jitter=0.1)
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, x: jl.apply(p, [x], train=True)[0],
                        {n: jnp.asarray(a) for n, a in jp.items()},
                        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in jp.items()}
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


@pytest.mark.parametrize("settings,shape,match", [
    ([("nhidden", "8")], (2, 3, 4, 8), "sequence node"),
    ([("nhidden", "8"), ("nlayer", "0")], (2, 1, 4, 8), "nlayer >= 1"),
    ([], (2, 1, 4, 8), "nhidden"),
    ([("nhidden", "8"), ("nhead", "3")], (2, 1, 4, 8), "not divisible"),
])
def test_transformer_stack_refuses_what_jax_refuses(settings, shape, match):
    msgs = []
    for make in (jax_layer, port_layer):
        lay = make("transformer_stack")
        for k, v in settings:
            lay.set_param(k, v)
        with pytest.raises(ValueError, match=match) as err:
            lay.infer_shapes([shape])
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

MOE_CASES = {
    "dense_top2": [("nexpert", "4"), ("nhidden", "6"), ("moe_top_k", "2"),
                   ("random_type", "xavier")],
    "dense_top1_nobias": [("nexpert", "3"), ("nhidden", "5"),
                          ("no_bias", "1"), ("moe_aux", "0.1")],
    "capacity_top2": [("nexpert", "4"), ("nhidden", "6"),
                      ("moe_top_k", "2"), ("moe_capacity", "1.25")],
    # a tight capacity drops tokens
    "capacity_tight": [("nexpert", "4"), ("nhidden", "6"),
                       ("moe_capacity", "0.5")],
    "aux_off": [("nexpert", "2"), ("nhidden", "4"), ("moe_aux", "0")],
}


@pytest.mark.filterwarnings("ignore:moe.*drops over-capacity")
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_jax(case, masked):
    """forward_with_aux against the JAX layer's apply_with_aux: the
    routed top-k (equal first), outputs, the aux term, and the gradient
    of sum(out * g) + aux with respect to the input and every param;
    `masked` marks the last row as padding."""
    shape = (3, 1, 5, 8)
    jl, pl_, jp = pair("moe", MOE_CASES[case], shape, jitter=0.05)
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    mask = np.array([1, 1, 0] if masked else [1, 1, 1], np.float32)

    # the routing decisions agree before anything is compared
    xs = x.reshape(3, 5, 8)
    probs = jax.nn.softmax(jnp.einsum("bse,ge->bsg", xs, jp["gate"]), -1)
    _, _, _, jtopi = jl._route(probs, jnp.asarray(mask))
    _, _, _, ptopi = pl_.route(torch.softmax(
        torch.from_numpy(xs) @ torch.from_numpy(jp["gate"]).t(), -1),
        torch.from_numpy(mask))
    np.testing.assert_array_equal(ptopi.numpy(), np.asarray(jtopi))

    def jf(p, x):
        outs, aux = jl.apply_with_aux(p, [x], train=True,
                                      mask=jnp.asarray(mask))
        return outs[0], aux
    (jout, jaux), vjp = jax.vjp(
        jf, {n: jnp.asarray(a) for n, a in jp.items()}, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(g), jnp.ones((), jnp.float32)))
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    outs, aux = pl_.forward_with_aux(tp, [tx], train=True,
                                     mask=torch.from_numpy(mask))
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(jout),
                               **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert aux.dtype == torch.float32
    ((outs[0] * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL,
                               err_msg="dx")
    for n in jp:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jgp[n]),
                                   **TOL, err_msg=f"d{n}")
    # the plain forward (the inference path: no mask) gives the same
    # rows as the unmasked forward_with_aux
    if not masked:
        with torch.no_grad():
            plain = pl_(tp, [tx])[0]
        np.testing.assert_array_equal(plain.numpy(),
                                      outs[0].detach().numpy())


def test_moe_capacity_warns_and_refusals_match_jax():
    lay = port_layer("moe", "m")
    for k, v in (("nexpert", "2"), ("nhidden", "4"),
                 ("moe_capacity", "1.25")):
        lay.set_param(k, v)
    with pytest.warns(UserWarning, match="residual"):
        lay.infer_shapes([(2, 1, 3, 4)])
    for settings, shape in (
            ([("nexpert", "2"), ("nhidden", "4")], (2, 2, 3, 4)),
            ([("nexpert", "1"), ("nhidden", "4")], (2, 1, 3, 4)),
            ([("nexpert", "2")], (2, 1, 3, 4)),
            ([("nexpert", "2"), ("nhidden", "4"), ("moe_top_k", "0")],
             (2, 1, 3, 4))):
        msgs = []
        for make in (jax_layer, port_layer):
            m = make("moe")
            for k, v in settings:
                m.set_param(k, v)
            with pytest.raises(ValueError) as err:
                m.infer_shapes([shape])
            msgs.append(str(err.value))
        assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# stack_moe.conf as a whole
# ---------------------------------------------------------------------------

def stack_conf(extra=""):
    """stack_moe.conf from its netconfig on (no iterator blocks) at batch
    4, float32, on the CPU."""
    with open(STACK_CONF) as f:
        text = f.read()
    net = "netconfig=start" + text.split("netconfig=start", 1)[1]
    for old, new in (("batch_size = 100", "batch_size = 4"),
                     ("dtype = bfloat16", "dtype = float32"),
                     ("dev = tpu", "dev = cpu")):
        assert old in net
        net = net.replace(old, new)
    return net + "\nsilent = 1\nseed = 3\n" + extra


def capacity_conf():
    conf = stack_conf()
    old = "  moe_top_k = 2\n"
    assert old in conf
    return conf.replace(old, old + "  moe_capacity = 1.25\n")


def make_pair(conf):
    jt = JaxTrainer(cfg=conf)
    jt.init_model()
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    convert.train_state_from_numpy(pt, {
        "params": jax.device_get(jt.state["params"]),
        "ustate": jax.device_get(jt.state["ustate"]),
        "epoch": jt.epoch})
    return jt, pt


def assert_routing_margins(jt, data, min_gap=1e-4):
    """Every token's top-k margin at the moe input exceeds `min_gap`."""
    moe_idx = [i for i, info in enumerate(jt.net_cfg.layers)
               if info.type_name == "moe"][0]
    info = jt.net_cfg.layers[moe_idx]
    values, _ = jt.net.forward(jt.state["params"], {0: jnp.asarray(data)},
                               train=False)
    x = np.asarray(values[info.nindex_in[0]])
    b, _, s, e = x.shape
    gate = np.asarray(jt.state["params"]["moe1"]["gate"])
    logits = x.reshape(b, s, e) @ gate.T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), -1)[..., ::-1]
    k = jt.net.layer_objs[moe_idx].top_k
    assert (p[..., k - 1] - p[..., k]).min() > min_gap
    assert (p[..., 0] - p[..., 1]).min() > min_gap


def batches(n, seed, rows=4, padd=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows, 1, 28, 28).astype(np.float32),
             rng.randint(0, 10, (rows, 1)).astype(np.float32), padd)
            for _ in range(n)]


@pytest.mark.filterwarnings("ignore:moe.*drops over-capacity")
@pytest.mark.parametrize("route", ["dense", "capacity"])
@pytest.mark.parametrize("padd", [0, 1])
def test_stack_moe_steps_match_jax(route, padd):
    """stack_moe.conf (4 stacked blocks, a 4-expert top-2 moe, dropout):
    the scaled loss including the moe aux term and 2 SGD + momentum
    steps, the JAX trainer's dropout masks injected; `padd` pads the
    batch's last row (masked out of the loss and of the aux
    statistics, and claiming no expert capacity)."""
    conf = stack_conf() if route == "dense" else capacity_conf()
    jt, pt = make_pair(conf)
    for step, (data, label, pd) in enumerate(batches(2, 5, padd=padd)):
        assert_routing_margins(jt, data)
        jb = JaxBatch(data=data, label=label, num_batch_padd=pd)
        want = jax_loss(jt, jb)
        jt.update(jb)
        got = pt.update(DataBatch(data=data, label=label, num_batch_padd=pd),
                        keep=jax_keep(pt, jt.seed, step))
        assert float(got) == pytest.approx(want, rel=1e-5)
        assert_states_match(jt, pt)


def test_stack_moe_aux_term_is_in_the_loss():
    """The network adds the moe aux term (moe_aux * batch * aux) into the
    training loss and leaves it out of inference."""
    jt, pt = make_pair(stack_conf())
    data, label, _ = batches(1, 6)[0]
    lbl = {"label": torch.from_numpy(label)}
    keep = {i: torch.from_numpy(k) for i, k in
            jax_keep(pt, jt.seed, 0).items()}
    cp = pt.compute_params()
    with torch.no_grad():
        _, with_aux = pt.net(cp, torch.from_numpy(data), train=True,
                             keep=keep, labels=lbl)
        moe = [m for m in pt.net.layer_objs if m.type_name == "moe"][0]
        moe.aux_scale = 0.0
        _, without = pt.net(cp, torch.from_numpy(data), train=True,
                            keep=keep, labels=lbl)

        calls = []
        plain = moe.forward_with_aux

        def record(*a, **k):
            calls.append((k.get("train"), k.get("mask")))
            return plain(*a, **k)
        moe.forward_with_aux = record
        values, infer = pt.net(cp, torch.from_numpy(data), labels=lbl)
        del moe.forward_with_aux
    # inference runs the plain forward: no mask, no aux in the total
    assert calls == [(False, None)]
    moe.aux_scale = 0.01
    assert values[-1].shape == (4, 1, 1, 10)
    assert float(with_aux) > float(without)
    want = jax_loss(jt, JaxBatch(data=data, label=label)) * 4
    np.testing.assert_allclose(float(with_aux), want, rtol=1e-5)


def test_stack_moe_jax_checkpoint_predicts_the_same_rows():
    """A JAX-written stack_moe checkpoint loads in the port (the stacked
    (L, ...) params and the expert tensors under their JAX names) and
    predicts the same rows, on a short batch too; the port saves it
    back byte for byte."""
    jt = JaxTrainer(cfg=stack_conf())
    jt.init_model()
    for data, label, _ in batches(2, 7):
        jt.update(JaxBatch(data=data, label=label))
    buf = io.BytesIO()
    jt.save_model(buf)
    pt = NetTrainer(cfg=stack_conf(), device="cpu")
    pt.load_model(io.BytesIO(buf.getvalue()))
    assert pt.state["params"]["ts1"]["wqkv"].shape == (4, 84, 28)
    assert pt.state["params"]["moe1"]["w1"].shape == (4, 56, 28)
    for rows in (4, 3):
        data, label, _ = batches(1, 8, rows=rows)[0]
        np.testing.assert_allclose(
            pt.predict_dist(DataBatch(data=data, label=label)),
            np.asarray(jt.predict_dist(JaxBatch(data=data, label=label))),
            **TOL)
    out = io.BytesIO()
    pt.save_model(out)
    assert out.getvalue() == buf.getvalue()


def test_stack_moe_server_rows_match_predict_dist():
    """The Server over stack_moe: ragged requests in buckets of 1-4
    rows, every served row within rtol 1e-5 / atol 1e-6 of
    predict_dist."""
    _, pt = make_pair(stack_conf())
    rng = np.random.RandomState(9)
    reqs = [rng.rand(n, 1, 28, 28).astype(np.float32) for n in (1, 4, 3, 2)]
    with Server(pt, max_batch=4, max_wait_ms=0.0, device="cpu") as srv:
        served = [f.result(timeout=60) for f in
                  [srv.submit(r) for r in reqs]]
    for data, got in zip(reqs, served):
        label = np.zeros((data.shape[0], 1), np.float32)
        np.testing.assert_allclose(
            got, pt.predict_dist(DataBatch(data=data, label=label)),
            rtol=1e-5, atol=1e-6)
