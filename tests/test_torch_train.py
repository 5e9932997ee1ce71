"""The training slice as a whole, on the CPU, against the JAX package:
loss layers, whole `update` steps, the divergence guard, evaluate /
train-metric strings, checkpoints with optimizer state, the mnist
iterator's order and the CLI's `task = train`.

Setup for the whole steps: NARROW_ALEXNET (tests/torch_port_util.py) in
float32; the JAX trainer's params and updater state are carried into
the port (convert.train_state_from_numpy), and the port gets the JAX
package's own dropout masks - uniform(fold_in(fold_in(PRNGKey(seed +
100), step), layer index)) < 1 - threshold - through `update(keep=)`.
Inputs are gaussian images: after relu the pooled windows hold exact
ties (zeros, which both packages handle alike) and no near ties in
float32.

Tolerances (float32 throughout; XLA:CPU and torch's CPU kernels sum in
other orders):
- per-example losses and their gradients: rtol 1e-5 / atol 1e-6;
- whole steps: params and updater state rtol 1e-4 / atol 1e-5 after
  each of 3 steps (measured drift ~1e-6 relative per step, amplified
  by the updates), the scaled loss rtol 1e-5;
- metric values: rtol 1e-5 / atol 1e-6 (error counts are exact)."""

import gzip
import io
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.io.iter_mnist import MNISTIterator as JaxMNIST
from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.layers.common import DropoutLayer as JaxDropout
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.fault import DivergenceError as JaxDivergence
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.iter_mnist import MNISTIterator
from cxxnet_tpu_torch.layers import create_layer as port_layer
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.fault import DivergenceError
from torch_port_util import NARROW_ALEXNET

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)

TRAIN_KEYS = """
eta = 0.01
momentum = 0.9
wd = 0.0005
bias:wd = 0
metric = error
"""


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def jax_keep(pt, seed, step):
    """The JAX trainer's dropout masks at `step`, per layer index."""
    out = {}
    rng = jax.random.fold_in(jax.random.PRNGKey(seed + 100), step)
    for idx, info in enumerate(pt.net_cfg.layers):
        if info.type_name == "dropout":
            shape = pt.net.node_shapes[info.nindex_in[0]]
            key = jax.random.fold_in(rng, idx)
            pkeep = 1.0 - pt.net.layer_objs[idx].threshold
            out[idx] = np.array(
                jax.random.uniform(key, shape, jnp.float32) < pkeep)
    return out


def jax_loss(jt, batch):
    """The scaled loss the JAX trainer's next update() computes."""
    data, label, mask, _ = jt._pad_batch(batch, train=True)
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 100),
                             jt._step_counter)
    labels = {k: jnp.asarray(v) for k, v in
              jt._label_fields(label.astype(np.float32)).items()}
    _, loss = jt.net.forward(jt.state["params"], {0: jnp.asarray(data)},
                             train=True, rng=rng, labels=labels,
                             mask=jnp.asarray(mask))
    return float(loss) / (jt.batch_size * jt.update_period)


def make_pair(extra=""):
    conf = NARROW_ALEXNET + TRAIN_KEYS + extra
    jt = JaxTrainer(cfg=conf)
    jt.init_model()
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    convert.train_state_from_numpy(pt, {
        "params": jax.device_get(jt.state["params"]),
        "ustate": jax.device_get(jt.state["ustate"]),
        "epoch": jt.epoch})
    return jt, pt


def batches(n_steps, rows=8, seed=0):
    rng = np.random.RandomState(seed)
    return [((rng.randn(rows, 3, 35, 35) * 3.0).astype(np.float32),
             rng.randint(0, 10, size=(rows, 1)).astype(np.float32))
            for _ in range(n_steps)]


def assert_states_match(jt, pt, tol=STEP_TOL):
    jp = jax.device_get(jt.state["params"])
    pp = convert.params_to_numpy(pt.state["params"], pt.net.param_shapes())
    for lk in jp:
        for pn in jp[lk]:
            np.testing.assert_allclose(pp[lk][pn], jp[lk][pn], **tol,
                                       err_msg=f"{lk}/{pn}")
    ju = jax.device_get(jt.state["ustate"])
    pu = convert.ustate_to_numpy(pt.state["ustate"])
    assert sorted(ju) == sorted(pu)
    for lk in ju:
        for pn in ju[lk]:
            assert sorted(ju[lk][pn]) == sorted(pu[lk][pn])
            for sn in ju[lk][pn]:
                np.testing.assert_allclose(
                    pu[lk][pn][sn], np.asarray(ju[lk][pn][sn]), **tol,
                    err_msg=f"{lk}/{pn}/{sn}")
    assert pt.epoch == jt.epoch


def metric_values(line):
    """'\\ta-b:1\\tc-d:2' -> {'a-b': 1.0, 'c-d': 2.0}."""
    out = {}
    for tok in line.strip("\n").split("\t"):
        if tok and ":" in tok and not tok.startswith("["):
            k, _, v = tok.rpartition(":")
            out[k] = float(v)
    return out


def assert_metric_lines_match(got, want):
    g, w = metric_values(got), metric_values(want)
    assert list(g) == list(w), (got, want)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], **METRIC_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# loss layers
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "softmax": (10, lambda rng, n, k: rng.randint(0, k, (n, 1))),
    "l2_loss": (6, lambda rng, n, k: rng.randn(n, k)),
    "multi_logistic": (5, lambda rng, n, k: rng.randint(0, 2, (n, k))),
}


@pytest.mark.parametrize("type_name", sorted(LOSS_CASES))
def test_per_example_loss_and_grad_match_jax(type_name):
    k, make_label = LOSS_CASES[type_name]
    rng = np.random.RandomState(3)
    x = (rng.randn(7, k) * 3.0).astype(np.float32)
    label = make_label(rng, 7, k).astype(np.float32)
    jl, pl_ = jax_layer(type_name), port_layer(type_name)
    want = np.asarray(jl.per_example_loss(jnp.asarray(x), jnp.asarray(label)))
    wgrad = np.asarray(jax.grad(lambda a: jnp.sum(
        jl.per_example_loss(a, jnp.asarray(label))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pl_.per_example_loss(xt, torch.from_numpy(label))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **LOSS_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), wgrad, **LOSS_TOL)
    # the gradient is the reference's hand-written one
    if type_name == "softmax":
        onehot = np.eye(k, dtype=np.float32)[label[:, 0].astype(int)]
        ref = torch.softmax(torch.from_numpy(x), -1).numpy() - onehot
    elif type_name == "l2_loss":
        ref = x - label
    else:
        ref = 1.0 / (1.0 + np.exp(-x)) - label
    np.testing.assert_allclose(xt.grad.numpy(), ref, **LOSS_TOL)


@pytest.mark.parametrize("type_name,width,match", [
    ("softmax", 2, "label width must be 1"),
    ("l2_loss", 3, "label width 3 != prediction width 6"),
    ("multi_logistic", 1, "label width 1 != prediction width 6"),
])
def test_loss_width_checks_match_jax(type_name, width, match):
    x = np.zeros((4, 6), np.float32)
    label = np.zeros((4, width), np.float32)
    with pytest.raises(ValueError, match=match):
        jax_layer(type_name).per_example_loss(jnp.asarray(x),
                                              jnp.asarray(label))
    with pytest.raises(ValueError, match=match):
        port_layer(type_name).per_example_loss(torch.from_numpy(x),
                                               torch.from_numpy(label))


# ---------------------------------------------------------------------------
# dropout masks
# ---------------------------------------------------------------------------

def test_injected_masks_are_the_jax_layers_masks():
    """The masks the tests inject are what the JAX dropout layer draws:
    its train output on a ones input is mask / pkeep."""
    jt, pt = make_pair()
    keep = jax_keep(pt, jt.seed, step=2)
    assert sorted(keep) == [18, 21]
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 100), 2)
    for idx, mask in keep.items():
        lay = JaxDropout()
        lay.set_param("threshold", "0.5")
        out = lay.apply({}, [jnp.ones(mask.shape, jnp.float32)], train=True,
                        rng=jax.random.fold_in(rng, idx))[0]
        np.testing.assert_array_equal(np.asarray(out), mask / 0.5)
        assert 0.3 < mask.mean() < 0.7
    # the port layer applies an injected mask the same way
    x = np.random.RandomState(0).randn(*keep[18].shape).astype(np.float32)
    pl_ = port_layer("dropout")
    pl_.set_param("threshold", "0.5")
    got = pl_({}, [torch.from_numpy(x)], train=True,
              keep=torch.from_numpy(keep[18]))[0]
    np.testing.assert_array_equal(got.numpy(), x * keep[18] / 0.5)
    # and its own draws keep about pkeep of the elements, reproducibly
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    d1 = pl_({}, [torch.ones(64, 1, 1, 64)], train=True, gen=g1)[0]
    d2 = pl_({}, [torch.ones(64, 1, 1, 64)], train=True, gen=g2)[0]
    assert torch.equal(d1, d2) and 0.4 < float((d1 > 0).float().mean()) < 0.6
    assert torch.equal(pl_({}, [torch.ones(3, 1, 1, 4)])[0],
                       torch.ones(3, 1, 1, 4))


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

STEP_CASES = {
    "sgd": ("", 8),
    "nag": ("updater = nag\n", 8),
    "adam": ("updater = adam\neta = 0.001\nbeta1 = 0.2\n", 8),
    "update_period_2": ("update_period = 2\n", 8),
    "short_batch": ("", 5),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_update_steps_match_jax(case):
    extra, rows = STEP_CASES[case]
    jt, pt = make_pair(extra)
    start = convert.params_to_numpy(pt.state["params"],
                                    pt.net.param_shapes())
    for step, (data, label) in enumerate(batches(3, rows)):
        want_loss = jax_loss(jt, JaxBatch(data=data, label=label))
        jt.update(JaxBatch(data=data, label=label))
        got_loss = pt.update(DataBatch(data=data, label=label),
                             keep=jax_keep(pt, jt.seed, step))
        np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-5)
        assert_states_match(jt, pt)
    assert pt.epoch == (1 if case == "update_period_2" else 3)
    moved = convert.params_to_numpy(pt.state["params"],
                                    pt.net.param_shapes())
    assert not np.allclose(moved["conv1"]["wmat"], start["conv1"]["wmat"])
    assert_metric_lines_match(pt.eval_train_metric(), jt.eval_train_metric())


def test_check_nan_rolls_back_like_jax(capsys):
    jt, pt = make_pair("check_nan = 1\nmax_bad_rounds = 2\n")
    (d0, l0), (d1, l1), (d2, l2) = batches(3)
    bad = np.full_like(d1, np.nan)
    for step, data, label in ((0, d0, l0), (1, bad, l1), (2, d2, l2)):
        jt.update(JaxBatch(data=data, label=label))
        pt.update(DataBatch(data=data, label=label),
                  keep=jax_keep(pt, jt.seed, step))
        assert_states_match(jt, pt)
    assert pt.bad_rounds == jt.bad_rounds == 1
    assert pt.epoch == jt.epoch == 2
    # the rolled-back step counts nothing toward the train metric
    assert_metric_lines_match(pt.eval_train_metric(), jt.eval_train_metric())
    err = capsys.readouterr().err
    assert "non-finite loss/params at update 1; batch dropped" in err
    # max_bad_rounds consecutive drops abort, params left at the last
    # finite state
    for step in (3, 4):
        batch = DataBatch(data=bad, label=l1)
        if step == 3:
            jt.update(JaxBatch(data=bad, label=l1))
            pt.update(batch, keep=jax_keep(pt, jt.seed, step))
        else:
            with pytest.raises(JaxDivergence, match="2 consecutive"):
                jt.update(JaxBatch(data=bad, label=l1))
            with pytest.raises(DivergenceError, match="2 consecutive"):
                pt.update(batch, keep=jax_keep(pt, jt.seed, step))
    assert_states_match(jt, pt)


class ListIter:
    """A DataIter over fixed batches (both packages' batch types)."""

    def __init__(self, items):
        self.items = items

    def before_first(self):
        self.i = 0

    def next(self):
        self.i += 1
        return self.i <= len(self.items)

    def value(self):
        return self.items[self.i - 1]


def test_evaluate_and_train_metric_strings_match_jax():
    extra = ("metric = logloss\nmetric = rec@3\n"
             "metric[label,21] = rec@1\n")
    jt, pt = make_pair(extra)
    for step, (data, label) in enumerate(batches(2)):
        jt.update(JaxBatch(data=data, label=label))
        pt.update(DataBatch(data=data, label=label),
                  keep=jax_keep(pt, jt.seed, step))
    assert_metric_lines_match(pt.eval_train_metric(), jt.eval_train_metric())
    evals = batches(3, seed=9)
    # a final short batch with wrap-fill rows: eval trims them
    short = (evals[2][0][:6], evals[2][1][:6])
    jitems = [JaxBatch(data=d, label=lb) for d, lb in evals[:2]]
    pitems = [DataBatch(data=d, label=lb) for d, lb in evals[:2]]
    jitems.append(JaxBatch(data=short[0], label=short[1], num_batch_padd=2))
    pitems.append(DataBatch(data=short[0], label=short[1],
                            num_batch_padd=2))
    want = jt.evaluate(ListIter(jitems), "test")
    got = pt.evaluate(ListIter(pitems), "test")
    assert want.startswith("\ttest-error:")
    assert_metric_lines_match(got, want)
    assert metric_values(got)["test-rec@1"] + metric_values(got)[
        "test-error"] == pytest.approx(1.0)
    # update_all: the round, then the named evals
    got = pt.update_all(ListIter(pitems[:1]), [ListIter(pitems)], ["val"])
    assert got.startswith("\tval-error:")


def test_pad_batch_train_marks_only_padded_rows():
    _, pt = make_pair()
    data, label = batches(1, rows=5)[0]
    d, lb, valid = pt._pad_batch(
        DataBatch(data=data, label=label, num_batch_padd=2), train=True)
    assert d.shape == (8, 3, 35, 35) and lb.shape == (8, 1)
    np.testing.assert_array_equal(valid, [1, 1, 1, 1, 1, 0, 0, 0])
    _, _, valid = pt._pad_batch(
        DataBatch(data=data, label=label, num_batch_padd=2), train=False)
    np.testing.assert_array_equal(valid, [1, 1, 1, 0, 0, 0, 0, 0])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_save_optimizer_checkpoint_is_byte_identical_and_resumes():
    jt, _ = make_pair("save_optimizer = 1\n")
    for data, label in batches(2):
        jt.update(JaxBatch(data=data, label=label))
    pt = NetTrainer(cfg=NARROW_ALEXNET + TRAIN_KEYS + "save_optimizer = 1\n",
                    device="cpu")
    pt.init_model()
    convert.train_state_from_numpy(pt, {
        "params": jax.device_get(jt.state["params"]),
        "ustate": jax.device_get(jt.state["ustate"]), "epoch": jt.epoch})
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    jt.save_model(jbuf)
    pt.save_model(pbuf)
    assert pbuf.getvalue() == jbuf.getvalue()
    # resume: params, ustate and the update counter come back
    pt2 = NetTrainer(cfg=NARROW_ALEXNET + TRAIN_KEYS, device="cpu")
    pt2.load_model(io.BytesIO(jbuf.getvalue()))
    assert pt2.epoch == 2
    assert_states_match(jt, pt2, tol=dict(rtol=0, atol=0))
    # without save_optimizer the state is not written and resumes zero
    pt2.save_optimizer = 0
    buf = io.BytesIO()
    pt2.save_model(buf)
    pt3 = NetTrainer(cfg=NARROW_ALEXNET + TRAIN_KEYS, device="cpu")
    pt3.load_model(io.BytesIO(buf.getvalue()))
    assert all(float(t.abs().sum()) == 0 for d in pt3.state["ustate"].values()
               for s in d.values() for t in s.values())


# ---------------------------------------------------------------------------
# the mnist iterator and the CLI
# ---------------------------------------------------------------------------

CLI_CONF = """
data = train
iter = mnist
  path_img = "{d}/train-images-idx3-ubyte.gz"
  path_label = "{d}/train-labels-idx1-ubyte.gz"
  input_flat = 0
  shuffle = {shuffle}
  seed_data = 7
iter = end
eval = test
iter = mnist
  path_img = "{d}/t10k-images-idx3-ubyte.gz"
  path_label = "{d}/t10k-labels-idx1-ubyte.gz"
  input_flat = 0
iter = end

netconfig=start
layer[0->1] = conv:c1
  kernel_size = 5
  stride = 2
  nchannel = 8
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 4
  alpha = 0.01
  beta = 0.75
  knorm = 1
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 10
  init_sigma = 0.1
layer[6->6] = softmax
netconfig=end
input_shape = 1,28,28
batch_size = 25
seed = 5
silent = 1
dev = cpu
eta = 0.1
momentum = 0.9
wd = 0.0001
metric = error
metric = logloss
save_model = 1
num_round = 2
max_round = 2
model_dir = {models}
"""


def net_conf():
    """CLI_CONF without its iterator blocks: what a trainer needs to
    build (or load into) the CLI's net."""
    return "netconfig=start" + CLI_CONF.split("netconfig=start", 1)[1] \
        .format(models="unused")


def write_mnist(d, prefix, n, seed):
    """A synthetic MNIST-format dataset: noise plus a class-dependent
    bright block."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = rng.randn(n, 28, 28) * 8 + 20
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 5)
        images[i, r * 10 + 2:r * 10 + 10, c * 5 + 1:c * 5 + 6] += 150
    images = np.clip(images, 0, 255).astype(np.uint8)
    with gzip.open(os.path.join(d, f"{prefix}-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28))
        f.write(images.tobytes())
    with gzip.open(os.path.join(d, f"{prefix}-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())


def test_mnist_shuffle_order_matches_jax(tmp_path):
    d = str(tmp_path)
    write_mnist(d, "train", 60, 1)
    its = []
    for cls in (JaxMNIST, MNISTIterator):
        it = cls()
        for k, v in (("path_img", f"{d}/train-images-idx3-ubyte.gz"),
                     ("path_label", f"{d}/train-labels-idx1-ubyte.gz"),
                     ("input_flat", "0"), ("shuffle", "1"),
                     ("seed_data", "7"), ("batch_size", "25"),
                     ("silent", "1")):
            it.set_param(k, v)
        it.init()
        its.append(it)
    for it in its:
        it.before_first()
    n = 0
    while its[0].next():
        assert its[1].next()
        a, b = its[0].value(), its[1].value()
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
        n += 1
    assert n == 2 and not its[1].next()


def _cli_setup(tmp_path, shuffle=0):
    d = str(tmp_path)
    write_mnist(d, "train", 100, 3)
    write_mnist(d, "t10k", 50, 4)
    confs = {}
    for pkg in ("jax", "port"):
        models = os.path.join(d, f"models_{pkg}")
        confs[pkg] = os.path.join(d, f"{pkg}.conf")
        with open(confs[pkg], "w") as f:
            f.write(CLI_CONF.format(d=d, models=models, shuffle=shuffle))
    return d, confs


def test_cli_train_matches_jax(tmp_path, capsys):
    """Both CLIs train 2 rounds from one JAX-written checkpoint (no
    dropout, shuffle = 0): the same per-round lines and checkpoints
    whose params agree."""
    d, confs = _cli_setup(tmp_path)
    init = os.path.join(d, "0000.model")
    seed_tr = JaxTrainer(cfg=net_conf())
    seed_tr.init_model()
    with open(init, "wb") as fo:
        seed_tr.save_model(fo)
    out = {}
    for pkg, mod in (("jax", jax_main), ("port", port_main)):
        capsys.readouterr()
        assert mod.main([confs[pkg], f"model_in={init}"]) == 0
        out[pkg] = capsys.readouterr().err.splitlines()
    jl = [ln for ln in out["jax"] if ln.startswith(("[", "\t"))]
    pl_ = [ln for ln in out["port"] if ln.startswith(("[", "\t"))]
    assert len(jl) == len(pl_) == 3  # the eval line, then rounds 1 and 2
    assert pl_[1].startswith("[1]\ttrain-error:")
    for g, w in zip(pl_, jl):
        assert g.split("\t")[0] == w.split("\t")[0]
        assert_metric_lines_match(g, w)
    for counter in (1, 2):
        name = f"{counter:04d}.model"
        blobs = []
        for pkg in ("jax", "port"):
            tr = NetTrainer(cfg=net_conf(), device="cpu")
            with open(os.path.join(d, f"models_{pkg}", name), "rb") as fi:
                tr.load_model(fi)
            blobs.append(convert.params_to_numpy(tr.state["params"],
                                                 tr.net.param_shapes()))
            assert tr.epoch == 4 * counter
        for lk in blobs[0]:
            for pn in blobs[0][lk]:
                np.testing.assert_allclose(blobs[1][lk][pn],
                                           blobs[0][lk][pn], **STEP_TOL)


def test_cli_train_continue_and_pred(tmp_path, capsys):
    """From scratch (0000.model saved first), then `continue = 1`
    resumes at the next round, and task=pred reads the result; an empty
    model_dir under continue = 1 raises, as in the JAX package."""
    d, confs = _cli_setup(tmp_path, shuffle=1)
    conf = confs["port"]
    models = os.path.join(d, "models_port")
    assert port_main.main([conf]) == 0
    assert sorted(os.listdir(models)) == ["0000.model", "0001.model",
                                          "0002.model"]
    err = capsys.readouterr().err
    assert [ln.split("\t")[0] for ln in err.splitlines()] == ["[1]", "[2]"]
    assert port_main.main([conf, "continue=1", "num_round=3"]) == 0
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("\ttest-error:") and err[1].startswith("[3]")
    assert os.path.exists(os.path.join(models, "0003.model"))
    tr = NetTrainer(cfg=net_conf(), device="cpu")
    with open(os.path.join(models, "0003.model"), "rb") as fi:
        tr.load_model(fi)
    assert tr.epoch == 12
    empty = os.path.join(d, "empty")
    with pytest.raises(FileNotFoundError, match="continue training"):
        port_main.main([conf, "continue=1", f"model_dir={empty}"])
    with pytest.raises(FileNotFoundError, match="continue training"):
        jax_main.main([confs["jax"], "continue=1", f"model_dir={empty}"])
    pred = os.path.join(d, "pred.txt")
    with open(conf, "a") as f:
        f.write(f'pred = {pred}\niter = mnist\n  path_img = '
                f'"{d}/t10k-images-idx3-ubyte.gz"\n  path_label = '
                f'"{d}/t10k-labels-idx1-ubyte.gz"\n  input_flat = 0\n'
                'iter = end\n')
    assert port_main.main([conf, "task=pred",
                           f"model_in={models}/0003.model"]) == 0
    with open(pred) as f:
        assert len(f.read().splitlines()) == 50


def test_cli_finetune_copies_named_layers(tmp_path, capsys):
    d, confs = _cli_setup(tmp_path)
    conf = confs["port"]
    assert port_main.main([conf, "num_round=1"]) == 0
    src = os.path.join(d, "models_port", "0001.model")
    capsys.readouterr()
    assert port_main.main([conf, "task=finetune", f"model_in={src}",
                           "num_round=0", "silent=0",
                           f"model_dir={d}/ft"]) == 0
    assert "finetune: copied layers ['c1', 'fc']" in capsys.readouterr().out
