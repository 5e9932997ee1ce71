"""The sequence family of the port on the CPU, against the JAX package:
the layers of cxxnet_tpu/layers/attention.py (attention,
attention_naive, seq_fullc, layernorm, pos_embed) and split/add of
cxxnet_tpu/layers/common.py one by one with weights carried across,
their shape errors, then examples/LongSeq/seq_mnist.conf as a whole in
float32 at batch 8 - the forward and SGD steps against the JAX trainer
with its dropout masks injected -, a JAX `save_optimizer` checkpoint
loaded and saved back byte-identical, and the port's CLI training it.

Tolerances (float32; XLA:CPU and torch sum in other orders):
- layer outputs rtol 1e-5 / atol 1e-5, their gradients rtol 1e-4 /
  atol 1e-5 (tests/test_pallas_attention.py:38, :65);
- whole steps: params and updater state rtol 1e-4 / atol 1e-5 after
  each of 3 steps, the scaled loss rtol 1e-5 (tests/test_torch_train.py);
- net outputs (softmax rows) rtol 1e-5 / atol 1e-6.
"""

import gzip
import io
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers import create_layer as port_layer
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Server
from test_torch_train import (assert_metric_lines_match, assert_states_match,
                              jax_keep, jax_loss)

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_CONF = os.path.join(REPO, "examples", "LongSeq", "seq_mnist.conf")


def seq_net_conf(extra=""):
    """seq_mnist.conf from its netconfig on (no iterator blocks) at batch
    8, float32, on the CPU."""
    with open(SEQ_CONF) as f:
        text = f.read()
    net = "netconfig=start" + text.split("netconfig=start", 1)[1]
    for old, new in (("batch_size = 100", "batch_size = 8"),
                     ("dtype = bfloat16", "dtype = float32"),
                     ("dev = tpu", "dev = cpu")):
        assert old in net
        net = net.replace(old, new)
    return net + "\nsilent = 1\nseed = 3\n" + extra


# ---------------------------------------------------------------------------
# layers one by one
# ---------------------------------------------------------------------------

def _pair(type_name, settings, in_shapes):
    """The JAX layer and the port layer, configured alike, shapes
    inferred, the JAX params drawn and carried to the port."""
    jl, pl_ = jax_layer(type_name), port_layer(type_name)
    for k, v in settings:
        jl.set_param(k, v)
        pl_.set_param(k, v)
    if type_name == "split":
        jl.num_out = pl_.num_out = 2
    want_shapes = jl.infer_shapes(list(in_shapes))
    assert pl_.infer_shapes(list(in_shapes)) == want_shapes
    jp = jl.init_params(jax.random.PRNGKey(1), list(in_shapes))
    jp = {n: np.asarray(a) for n, a in jp.items()}
    assert {n: a.shape for n, a in jp.items()} == {
        n: tuple(s) for n, s in pl_.param_shapes(list(in_shapes)).items()}
    assert sorted(pl_.param_tags()) == sorted(jl.param_tags())
    assert pl_.param_tags() == jl.param_tags()
    return jl, pl_, jp


LAYER_CASES = {
    "attention": ("attention", [("nhead", "4"), ("random_type", "xavier")],
                  [(3, 1, 12, 28)]),
    "attention_causal_nobias": (
        "attention", [("nhead", "2"), ("causal", "1"), ("no_bias", "1"),
                      ("init_sigma", "0.1")], [(2, 1, 9, 16)]),
    "attention_naive": ("attention_naive", [("nhead", "4"),
                                            ("causal", "1")],
                        [(2, 1, 12, 28)]),
    "seq_fullc": ("seq_fullc", [("nhidden", "20"), ("random_type", "xavier"),
                                ("init_bias", "0.1")], [(3, 1, 7, 12)]),
    "layernorm": ("layernorm", [("init_slope", "1.5"), ("init_bias", "0.2"),
                                ("eps", "1e-3")], [(3, 1, 7, 12)]),
    "pos_embed": ("pos_embed", [("init_sigma", "0.5")], [(3, 1, 7, 12)]),
    "split": ("split", [], [(3, 1, 7, 12)]),
    "add": ("add", [], [(3, 1, 7, 12), (3, 1, 7, 12), (3, 1, 7, 12)]),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax_apply(case):
    """Outputs, and the gradients of sum(cos(outputs)) with respect to the
    inputs and every param, against the JAX layer's apply."""
    type_name, settings, in_shapes = LAYER_CASES[case]
    jl, pl_, jp = _pair(type_name, settings, in_shapes)
    # the layernorm's init params are constant: make them non-trivial
    rng = np.random.RandomState(7)
    jp = {n: (a + 0.3 * rng.randn(*a.shape)).astype(np.float32)
          for n, a in jp.items()}
    xs = [rng.randn(*s).astype(np.float32) for s in in_shapes]

    def jloss(params, inputs):
        outs = jl.apply(params, inputs, train=False)
        return sum(jnp.sum(jnp.cos(o)) for o in outs), outs

    (_, jouts), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {n: jnp.asarray(a) for n, a in jp.items()},
        [jnp.asarray(x) for x in xs])
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in jp.items()}
    tx = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    outs = pl_(tp, tx)
    assert len(outs) == len(jouts)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   **OUT_TOL)
    sum(torch.cos(o).sum() for o in outs).backward()
    for n in jp:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jgp[n]),
                                   **GRAD_TOL, err_msg=f"d{n}")
    for x, jg in zip(tx, jgx):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   **GRAD_TOL, err_msg="dx")


def test_layer_init_draws_the_configured_distributions():
    """The port draws from torch generators, so its init agrees with the
    JAX package in distribution: xavier bounds, gaussian sigma, the
    layernorm's constants and the bias flag."""
    gen = torch.Generator().manual_seed(0)
    att = port_layer("attention")
    att.set_param("random_type", "xavier")
    p = att.init_params(gen, [(2, 1, 10, 64)])
    for name, a in (("wmat", (3.0 / (64 + 192)) ** 0.5),
                    ("wproj", (3.0 / 128) ** 0.5)):
        w = p[name]
        assert float(w.abs().max()) <= a and float(w.abs().max()) > 0.9 * a
    assert torch.equal(p["bias"], torch.zeros(192))
    pe = port_layer("pos_embed")
    pe.set_param("init_sigma", "0.02")
    w = pe.init_params(gen, [(2, 1, 100, 100)])["wmat"]
    assert w.shape == (100, 100) and abs(float(w.std()) - 0.02) < 1e-3
    ln = port_layer("layernorm")
    ln.set_param("init_slope", "2")
    ln.set_param("init_bias", "0.5")
    p = ln.init_params(gen, [(2, 1, 3, 5)])
    assert torch.equal(p["slope"], torch.full((5,), 2.0))
    assert torch.equal(p["bias"], torch.full((5,), 0.5))


@pytest.mark.parametrize("type_name,settings,in_shapes,match", [
    ("attention", [], [(2, 3, 4, 8)], "must be a sequence node"),
    ("attention", [("nhead", "3")], [(2, 1, 4, 8)],
     "embed 8 not divisible by nhead 3"),
    ("attention", [], [(2, 1, 4, 8), (2, 1, 4, 8)], "1-1 connection"),
    ("seq_fullc", [("nhidden", "4")], [(2, 3, 4, 8)],
     "input must be a sequence node"),
    ("seq_fullc", [], [(2, 1, 4, 8)], "must set nhidden correctly"),
    ("layernorm", [], [(2, 1, 4, 8), (2, 1, 4, 8)], "1-1 connection"),
    ("add", [], [(2, 1, 4, 8)], "add layer needs at least 2 inputs"),
    ("add", [], [(2, 1, 4, 8), (2, 1, 4, 7)], "add: input shapes differ"),
])
def test_shape_errors_match_jax(type_name, settings, in_shapes, match):
    for make in (jax_layer, port_layer):
        lay = make(type_name)
        for k, v in settings:
            lay.set_param(k, v)
        with pytest.raises(ValueError, match=match):
            lay.infer_shapes(list(in_shapes))


def test_seq_parallel_and_kv_block_keys():
    """seq_parallel is validated as in the JAX package and kv_block is
    accepted; neither changes the single-device result."""
    for make in (jax_layer, port_layer):
        with pytest.raises(ValueError, match="ring, ulysses or none"):
            make("attention").set_param("seq_parallel", "tree")
    lay = port_layer("attention")
    lay.set_param("seq_parallel", "ulysses")
    lay.set_param("kv_block", "7")
    assert (lay.seq_parallel, lay.kv_block) == ("ulysses", 7)
    # transformer_stack validates and accepts them the same way, and
    # moe refuses a top-k past its experts in both packages
    for make in (jax_layer, port_layer):
        with pytest.raises(ValueError, match="ring, ulysses or none"):
            make("transformer_stack").set_param("seq_parallel", "tree")
        moe = make("moe")
        for k, v in (("nexpert", "2"), ("nhidden", "4"),
                     ("moe_top_k", "3")):
            moe.set_param(k, v)
        with pytest.raises(ValueError, match="moe_top_k out of range"):
            moe.infer_shapes([(2, 1, 3, 4)])
    ts = port_layer("transformer_stack")
    ts.set_param("seq_parallel", "none")
    ts.set_param("kv_block", "7")
    assert (ts.seq_parallel, ts.kv_block) == ("none", 7)


def test_split_arity_follows_the_connection():
    """layer[1->2,3] = split: the Network sets num_out from the
    connection, and each copy's gradient adds up in the input."""
    tr = NetTrainer(cfg=seq_net_conf(), device="cpu")
    tr.init_model()
    splits = [lay for lay, info in zip(tr.net.layer_objs,
                                       tr.net_cfg.layers)
              if info.type_name == "split"]
    assert [s.num_out for s in splits] == [2, 2]
    lay = port_layer("split")
    lay.num_out = 3
    assert lay.infer_shapes([(2, 1, 4, 8)]) == [(2, 1, 4, 8)] * 3
    x = torch.ones(2, 1, 4, 8, requires_grad=True)
    outs = lay({}, [x])
    (outs[0] * 1 + outs[1] * 2 + outs[2] * 3).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 6.0))


# ---------------------------------------------------------------------------
# seq_mnist.conf as a whole
# ---------------------------------------------------------------------------

TRAIN_EXTRA = "metric = error\n"


def make_pair(extra=""):
    conf = seq_net_conf(TRAIN_EXTRA + extra)
    jt = JaxTrainer(cfg=conf)
    jt.init_model()
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    convert.train_state_from_numpy(pt, {
        "params": jax.device_get(jt.state["params"]),
        "ustate": jax.device_get(jt.state["ustate"]),
        "epoch": jt.epoch})
    return jt, pt


def seq_batches(n, rows=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows, 1, 28, 28).astype(np.float32),
             rng.randint(0, 10, size=(rows, 1)).astype(np.float32))
            for _ in range(n)]


def test_seq_mnist_forward_and_steps_match_jax():
    """Forward rows, then 3 SGD steps (momentum 0.9, expdecay, dropout
    with JAX's masks): loss, params and momentum against the JAX
    trainer after every step, and the train metric line."""
    jt, pt = make_pair()
    assert pt.compute_dtype == torch.float32
    data, label = seq_batches(1, seed=11)[0]
    want = jt.predict_dist(JaxBatch(data=data, label=label))
    got = pt.predict_dist(DataBatch(data=data, label=label))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    start = convert.params_to_numpy(pt.state["params"],
                                    pt.net.param_shapes())
    for step, (data, label) in enumerate(seq_batches(3)):
        want_loss = jax_loss(jt, JaxBatch(data=data, label=label))
        jt.update(JaxBatch(data=data, label=label))
        got_loss = pt.update(DataBatch(data=data, label=label),
                             keep=jax_keep(pt, jt.seed, step))
        np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-5)
        assert_states_match(jt, pt, STEP_TOL)
    moved = convert.params_to_numpy(pt.state["params"],
                                    pt.net.param_shapes())
    for lk in start:
        for pn in start[lk]:
            assert not np.array_equal(moved[lk][pn], start[lk][pn]), (lk, pn)
    assert_metric_lines_match(pt.eval_train_metric(), jt.eval_train_metric())


def test_seq_mnist_wd_scales_every_wmat_tagged_param():
    """wd under `wmat:` reaches wproj, the layernorm slopes and the
    positional embedding (all tagged wmat), not the biases."""
    jt, pt = make_pair("wmat:wd = 0.01\n")
    data, label = seq_batches(1, seed=2)[0]
    jt.update(JaxBatch(data=data, label=label))
    pt.update(DataBatch(data=data, label=label),
              keep=jax_keep(pt, jt.seed, 0))
    assert_states_match(jt, pt, STEP_TOL)
    ups = pt.updaters
    assert ups["att1"]["wproj"].param.wd == 0.01
    assert ups["ln1"]["slope"].param.wd == 0.01
    assert ups["pe"]["wmat"].param.wd == 0.01
    assert ups["att1"]["bias"].param.wd == 0.0


def test_seq_mnist_bf16_params_are_cast_and_trained():
    """Under dtype = bfloat16 every param - wproj and slope too - enters
    the forward in bfloat16, the gradients land in float32 on the
    master, and one step moves them all."""
    pt = NetTrainer(cfg=seq_net_conf(TRAIN_EXTRA).replace(
        "dtype = float32", "dtype = bfloat16"), device="cpu")
    pt.init_model()
    assert {t.dtype for d in pt.compute_params().values()
            for t in d.values()} == {torch.bfloat16}
    before = convert.params_to_numpy(pt.state["params"],
                                     pt.net.param_shapes())
    data, label = seq_batches(1, seed=5)[0]
    loss = pt.update(DataBatch(data=data, label=label))
    assert np.isfinite(float(loss))
    after = pt.state["params"]
    for lk, d in before.items():
        for pn, a in d.items():
            assert after[lk][pn].dtype == torch.float32
            assert not np.array_equal(after[lk][pn].numpy(), a), (lk, pn)


def test_seq_mnist_save_optimizer_checkpoint_is_byte_identical():
    """A JAX checkpoint of seq_mnist with its momentum (save_optimizer =
    1) loads into the port, and the port's save_model of it is the same
    bytes; the loaded state equals the JAX trainer's exactly."""
    jt, _ = make_pair("save_optimizer = 1\n")
    for data, label in seq_batches(2, seed=3):
        jt.update(JaxBatch(data=data, label=label))
    jbuf = io.BytesIO()
    jt.save_model(jbuf)
    pt = NetTrainer(cfg=seq_net_conf(TRAIN_EXTRA + "save_optimizer = 1\n"),
                    device="cpu")
    pt.load_model(io.BytesIO(jbuf.getvalue()))
    assert pt.epoch == 2
    assert_states_match(jt, pt, dict(rtol=0, atol=0))
    assert sorted(pt.state["params"]["att1"]) == ["bias", "wmat", "wproj"]
    assert sorted(pt.state["params"]["ln1"]) == ["bias", "slope"]
    pbuf = io.BytesIO()
    pt.save_model(pbuf)
    assert pbuf.getvalue() == jbuf.getvalue()


def test_seq_mnist_server_rows_match_predict_dist_and_jax():
    """The Server serves the sequence family unchanged: ragged requests
    in buckets of 1-8 rows, every served row within rtol 1e-5 / atol
    1e-6 of the port's predict_dist (other batch sizes, other summation
    blocking) and of the JAX trainer's."""
    jt, pt = make_pair()
    rng = np.random.RandomState(4)
    reqs = [rng.rand(n, 1, 28, 28).astype(np.float32)
            for n in (1, 3, 8, 5, 2, 7)]
    with Server(pt, max_batch=8, max_wait_ms=0.0, device="cpu") as srv:
        futs = [srv.submit(r) for r in reqs]
        served = [f.result(timeout=60) for f in futs]
    for data, got in zip(reqs, served):
        label = np.zeros((data.shape[0], 1), np.float32)
        np.testing.assert_allclose(
            got, pt.predict_dist(DataBatch(data=data, label=label)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got, jt.predict_dist(JaxBatch(data=data, label=label)),
            rtol=1e-5, atol=1e-6)


def write_noisy_mnist(d, prefix, n, seed):
    """MNIST-format data whose class-dependent block (+60) sits in heavy
    noise (sd 60): two rounds of seq_mnist on 300 images leave test
    errors to fall (0.795 -> 0.21 with the CLI test's settings)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = rng.randn(n, 28, 28) * 60 + 100
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 5)
        images[i, r * 10 + 2:r * 10 + 10, c * 5 + 1:c * 5 + 6] += 60
    images = np.clip(images, 0, 255).astype(np.uint8)
    with gzip.open(os.path.join(d, f"{prefix}-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28))
        f.write(images.tobytes())
    with gzip.open(os.path.join(d, f"{prefix}-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())


def test_seq_mnist_cli_trains_and_predicts(tmp_path, capsys, monkeypatch):
    """seq_mnist.conf unmodified but for the data paths, through the
    port's CLI with dev=cpu dtype=float32: 2 rounds on synthetic
    MNIST-format data (test error falls), then task=pred writes one line
    per test image."""
    d = tmp_path / "data"
    d.mkdir()
    write_noisy_mnist(str(d), "train", 300, 3)
    write_noisy_mnist(str(d), "t10k", 200, 4)
    with open(SEQ_CONF) as f:
        text = f.read()
    pred = tmp_path / "pred.txt"
    conf = tmp_path / "seq_mnist.conf"
    conf.write_text(text + f'\npred = {pred}\niter = mnist\n'
                    '    input_flat = 0\n'
                    '    path_img = "./data/t10k-images-idx3-ubyte.gz"\n'
                    '    path_label = "./data/t10k-labels-idx1-ubyte.gz"\n'
                    'iter = end\n')
    monkeypatch.chdir(tmp_path)
    assert port_main.main([str(conf), "dev=cpu", "dtype=float32",
                           "num_round=2", "max_round=2", "silent=1"]) == 0
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("[")]
    errs = [float(ln.split("test-error:")[1]) for ln in lines]
    assert len(errs) == 2 and errs[1] < errs[0], lines
    assert sorted(os.listdir(tmp_path / "models")) == [
        "0000.model", "0001.model", "0002.model"]
    assert port_main.main([str(conf), "dev=cpu", "dtype=float32",
                           "task=pred", "model_in=models/0002.model",
                           "silent=1"]) == 0
    preds = pred.read_text().split()
    assert len(preds) == 200 and set(preds) <= {str(i) for i in range(10)}
