"""The serving slice as a whole, on the CPU: a narrow AlexNet-shaped net
(AlexNet's layer sequence - grouped conv2/4/5, both lrn layers, dropout,
softmax - at 3x35x35, 8-16 channels, 32 hidden units, 10 classes,
float32) through the JAX NetTrainer and the port's NetTrainer with the
same weights; the port's Server on a ragged stream; checkpoints both
ways; and the CLI's task=pred / task=serve against the JAX trainer.

Tolerance for JAX against the port: rtol 1e-4 / atol 1e-5 on the softmax
rows (float32; XLA:CPU and torch's CPU kernels sum in other orders -
measured max abs difference ~3e-8). The port against itself across
bucket sizes: rtol 1e-5 / atol 1e-6 (one float32 forward at two batch
sizes)."""

import gzip
import io
import os
import struct
import threading

import numpy as np
import pytest
import torch

import jax

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Server, bucket_sizes
from torch_port_util import NARROW_ALEXNET, carry

JAX_TOL = dict(rtol=1e-4, atol=1e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-6)


def rows(n, seed):
    return (np.random.RandomState(seed).randn(n, 3, 35, 35) * 3.0).astype(
        np.float32)


def batch(data, cls=DataBatch):
    return cls(data=data, label=np.zeros((data.shape[0], 1), np.float32))


@pytest.fixture(scope="module")
def pair():
    jt = JaxTrainer(cfg=NARROW_ALEXNET)
    jt.init_model()
    pt = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    pt.init_model()
    carry(jt, pt)
    return jt, pt


def test_predict_dist_and_predict_match_jax(pair):
    jt, pt = pair
    data = rows(8, 0)
    want = jt.predict_dist(batch(data, JaxBatch))
    got = pt.predict_dist(batch(data))
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got, want, **JAX_TOL)
    np.testing.assert_array_equal(pt.predict(batch(data)),
                                  jt.predict(batch(data, JaxBatch)))
    # the rows are not all one class: the argmax comparison has teeth
    assert len(set(want.argmax(1).tolist())) > 1


def test_bfloat16_matches_jax(pair):
    """dtype = bfloat16: params and input cast wholesale, float32
    readout, in both packages. The rounding points differ - JAX's XLA
    LRN on the CPU runs in bfloat16, the port's in float32 as the TPU
    and CUDA kernels do - so rows agree to 4 bfloat16 ulps at the
    softmax's scale (atol 2^-6), and the argmax wherever the top-2
    margin is wider than twice that."""
    jt0, _ = pair
    conf = NARROW_ALEXNET + "dtype = bfloat16\n"
    jt = JaxTrainer(cfg=conf)
    jt.init_model()
    jt.state["params"] = jt0.state["params"]
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    carry(jt, pt)
    assert pt.compute_params()["conv1"]["wmat"].dtype == torch.bfloat16
    assert pt.state["params"]["conv1"]["wmat"].dtype == torch.float32
    data = rows(8, 0)
    want = jt.predict_dist(batch(data, JaxBatch))
    got = pt.predict_dist(batch(data))
    assert got.dtype == np.float32
    atol = 2.0 ** -6
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    top2 = np.sort(want, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * atol
    assert decided.sum() >= 4
    np.testing.assert_array_equal(got.argmax(1)[decided],
                                  want.argmax(1)[decided])


def test_shared_weights_and_self_loops_match_jax():
    """share[tag] reuses the primary layer's params (one key in the
    params dict); layer[+0] self-loops overwrite their node."""
    conf = """
netconfig=start
layer[+1:h1] = fullc:fc1
  nhidden = 12
  init_sigma = 0.5
layer[+0] = relu
layer[+1:h2] = share[fc1]
layer[+0] = tanh
layer[+1:out] = fullc:fc2
  nhidden = 5
  init_sigma = 0.5
layer[+0] = softmax
netconfig=end
input_shape = 1,1,12
batch_size = 4
silent = 1
dev = cpu
"""
    jt = JaxTrainer(cfg=conf)
    jt.init_model()
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    assert sorted(pt.state["params"]) == ["fc1", "fc2"]
    carry(jt, pt)
    data = np.random.RandomState(5).randn(4, 1, 1, 12).astype(np.float32)
    np.testing.assert_allclose(pt.predict_dist(batch(data)),
                               jt.predict_dist(batch(data, JaxBatch)),
                               **JAX_TOL)


def test_padding_rows_of_a_short_batch_are_trimmed(pair):
    _, pt = pair
    data = rows(8, 1)
    b = batch(data)
    b.num_batch_padd = 3
    got = pt.predict_dist(b)
    assert got.shape == (5, 10)
    np.testing.assert_allclose(got, pt.predict_dist(batch(data[:5])),
                               **SELF_TOL)


def test_bucket_sizes():
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(6) == (1, 2, 4, 6)
    assert bucket_sizes(1) == (1,)
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_server_ragged_stream_matches_predict_dist(pair):
    """Ragged requests (oversize ones split and re-join) from three
    threads: every row equals the port's own predict_dist of it."""
    _, pt = pair
    sizes = [1, 3, 8, 2, 13, 5, 7, 4, 20, 6, 1, 2]
    reqs = [rows(s, 10 + i) for i, s in enumerate(sizes)]
    srv = Server(pt, max_batch=8, max_wait_ms=2.0, replicas=2,
                 device="cpu")
    srv.warmup()
    out = [None] * len(reqs)

    def client(idx):
        futs = [(i, srv.submit(reqs[i])) for i in idx]
        for i, f in futs:
            out[i] = f.result(timeout=60)

    with srv:
        threads = [threading.Thread(target=client,
                                    args=(range(k, len(reqs), 3),))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    stats = srv.stats()
    assert stats["requests"] == len(reqs)
    assert stats["rows"] == sum(sizes)
    assert stats["errors"] == 0
    assert stats["batches"] == sum(stats["buckets"].values())
    assert stats["latency_p99_ms"] is not None
    for data, got in zip(reqs, out):
        assert got.shape == (data.shape[0], 10)
        np.testing.assert_allclose(
            got, pt.predict_dist(batch(data)) if data.shape[0] <= 8 else
            np.concatenate([pt.predict_dist(batch(data[i:i + 8]))
                            for i in range(0, data.shape[0], 8)]),
            **SELF_TOL)


def test_padding_rows_never_leak(pair):
    """A 3-row request rides the 4-row bucket: one padding row is
    dispatched, none comes back, and the real rows do not depend on the
    padding's contents (bitwise: the same bucket shape both times)."""
    _, pt = pair
    data = rows(3, 30)
    with Server(pt, max_batch=8, max_wait_ms=0.0, device="cpu") as srv:
        got = srv.submit(data).result(timeout=60)
        stats = srv.stats()
    assert got.shape == (3, 10)
    assert stats["padding_rows"] == 1 and stats["buckets"][4] == 1
    fn = pt.infer_fn(pt.net_cfg.num_nodes - 1)
    params = pt.compute_params()
    with torch.inference_mode():
        a = fn(params, pt.stage_infer_rows(np.concatenate(
            [data, np.zeros((1, 3, 35, 35), np.float32)])))[:3]
        b = fn(params, pt.stage_infer_rows(np.concatenate(
            [data, rows(1, 31) * 100.0])))[:3]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(got, a.reshape(3, -1).numpy(), **SELF_TOL)


def test_server_rejects_bad_requests_and_stops(pair):
    _, pt = pair
    srv = Server(pt, max_batch=4, device="cpu")
    with pytest.raises(RuntimeError, match="not started"):
        srv.submit(rows(1, 0))
    srv.start()
    with pytest.raises(ValueError, match="serve request"):
        srv.submit(np.zeros((2, 3, 8, 8), np.float32))
    single = srv.submit(rows(1, 2)[0]).result(timeout=60)
    assert single.shape == (1, 10)
    stats = srv.stop()
    assert stats["requests"] == 1 and not srv._threads
    with pytest.raises(RuntimeError):
        srv.submit(rows(1, 0))


def test_checkpoint_jax_to_port(pair, tmp_path):
    """A JAX save_model loads into the port and predicts the same; the
    port's save_model of it is byte-identical to the JAX file."""
    jt, _ = pair
    path = tmp_path / "jax.model"
    with open(path, "wb") as fo:
        jt.save_model(fo)
    pt = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    with open(path, "rb") as fi:
        pt.load_model(fi)
    data = rows(8, 40)
    np.testing.assert_allclose(pt.predict_dist(batch(data)),
                               jt.predict_dist(batch(data, JaxBatch)),
                               **JAX_TOL)
    buf = io.BytesIO()
    pt.save_model(buf)
    assert buf.getvalue() == path.read_bytes()


def test_checkpoint_port_to_jax(pair):
    """The port's save_model (its own seeded weights) loads into the JAX
    trainer, which then predicts what the port predicts."""
    _, _ = pair
    pt = NetTrainer(cfg=NARROW_ALEXNET + "seed = 11\n", device="cpu")
    pt.init_model()
    buf = io.BytesIO()
    pt.save_model(buf)
    buf.seek(0)
    jt = JaxTrainer(cfg=NARROW_ALEXNET)
    jt.load_model(buf)
    got = jax.device_get(jt.state["params"])
    for lk, d in pt.state["params"].items():
        for pn, t in d.items():
            np.testing.assert_array_equal(got[lk][pn], t.numpy())
    data = rows(8, 41)
    np.testing.assert_allclose(jt.predict_dist(batch(data, JaxBatch)),
                               pt.predict_dist(batch(data)), **JAX_TOL)


def test_get_set_weight(pair):
    _, pt0 = pair
    pt = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    pt.init_model()
    w, shape = pt.get_weight("conv2", "wmat")
    assert shape == (16, 4, 3, 3) and w.shape == (16, 36)
    pt.set_weight(np.zeros_like(w), "conv2", "wmat")
    assert not pt.get_weight("conv2", "wmat")[0].any()
    b, _ = pt0.get_weight("fc8", "bias")
    assert b.shape == (10, 1)


# ---------------------------------------------------------------------------
# the CLI: task=serve == task=pred, and both == the JAX trainer
# ---------------------------------------------------------------------------

CLI_CONF = """
pred = {out}
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
  init_sigma = 0.5
layer[6->6] = softmax
netconfig=end
input_shape = 1,28,28
batch_size = 25
seed = 5
silent = 1
dev = cpu
"""


def write_mnist(d, n, seed):
    """A synthetic MNIST-format dataset: noise plus a class-dependent
    bright block."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = rng.randn(n, 28, 28) * 8 + 20
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 5)
        images[i, r * 10 + 2:r * 10 + 10, c * 5 + 1:c * 5 + 6] += 150
    images = np.clip(images, 0, 255).astype(np.uint8)
    with gzip.open(os.path.join(d, "t10k-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28))
        f.write(images.tobytes())
    with gzip.open(os.path.join(d, "t10k-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())
    return images.astype(np.float32)[:, None] / 256.0


def test_cli_serve_equals_pred_equals_jax(tmp_path):
    d = str(tmp_path)
    images = write_mnist(d, 100, 4)
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d))
    jt = JaxTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d))
    jt.init_model()
    model = os.path.join(d, "0001.model")
    with open(model, "wb") as fo:
        jt.save_model(fo)
    outs = {}
    for task in ("pred", "serve", "pred_raw"):
        out = os.path.join(d, f"{task}.txt")
        assert port_main.main([conf, f"task={task}", f"model_in={model}",
                               f"pred={out}", "serve_rows=0"]) == 0
        with open(out) as f:
            outs[task] = f.read().splitlines()
    assert len(outs["pred"]) == 100
    assert outs["serve"] == outs["pred"]
    want = np.concatenate([jt.predict(JaxBatch(
        data=images[i:i + 25], label=np.zeros((25, 1), np.float32)))
        for i in range(0, 100, 25)])
    assert [float(v) for v in outs["pred"]] == want.tolist()
    assert len(set(outs["pred"])) > 1
    raw = np.array([[float(t) for t in ln.split()] for ln in outs["pred_raw"]])
    assert raw.shape == (100, 10)
    # the CPU path never launches a kernel
    assert kernels.launches()["lrn_fwd"] == 0


@pytest.mark.parametrize("overrides,match", [
    # the cases that were refused while elastic training and serving on
    # a mesh were not ported (their ids kept): `elastic` is inert under
    # serve and `mesh = model:2` serves in one process, both as
    # task = pred answers; a device list past the machine's devices
    # raises as the JAX CLI's mesh does
    pytest.param(["task=serve", "elastic=1"], None,
                 id="overrides0-elastic"),
    pytest.param(["task=serve", "mesh=model:2"], None,
                 id="overrides1-task = serve with a mesh"),
    pytest.param(["task=serve", "dev=tpu:0-63"],
                 "device spec requests index 63 but only 0 devices",
                 id="overrides2-multi-device"),
])
def test_cli_rejects_what_is_not_ported(tmp_path, overrides, match):
    d = str(tmp_path)
    write_mnist(d, 25, 1)
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "p.txt"), d=d))
    if match is not None:
        with pytest.raises(ValueError, match=match):
            port_main.main([conf, "model_in=none.model"] + overrides)
        return
    tr = NetTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d),
                    device="cpu")
    tr.init_model()
    model = os.path.join(d, "0001.model")
    with open(model, "wb") as fo:
        tr.save_model(fo)
    outs = {}
    for task, extra in (("pred", []), ("serve", overrides[1:])):
        out = os.path.join(d, f"{task}.txt")
        assert port_main.main([conf, f"task={task}", f"model_in={model}",
                               f"pred={out}", "serve_rows=0"] + extra) == 0
        with open(out) as f:
            outs[task] = f.read().splitlines()
    assert len(outs["pred"]) == 25 and outs["serve"] == outs["pred"]
    # the CLI armed no coordinator under serve
    assert not os.path.exists(os.path.join(d, "models", "coord"))


TRAIN_BLOCK = """
data = train
iter = mnist
  path_img = "{d}/t10k-images-idx3-ubyte.gz"
  path_label = "{d}/t10k-labels-idx1-ubyte.gz"
  input_flat = 0
iter = end
"""


@pytest.mark.parametrize("overrides", [
    ["task=train", "remat=1"],
    ["task=pred", "steps_per_dispatch=4"],
    ["task=pred", "tuning_cache=tc.json"],
])
def test_cli_takes_the_ported_trainer_keys(tmp_path, overrides):
    """remat, steps_per_dispatch and tuning_cache, which the CLI once
    refused, run: each output equals the run without the key (a
    training run's checkpoint byte for byte)."""
    from cxxnet_tpu_torch.nnet import tuning
    d = str(tmp_path)
    write_mnist(d, 100, 4)
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(TRAIN_BLOCK.format(d=d)
                + CLI_CONF.format(out=os.path.join(d, "p.txt"), d=d))
    tuning.save_entry(os.path.join(d, "tc.json"), "cpu",
                      {"steps_per_dispatch": 2, "prefetch_stage": 0})
    args = [a.replace("tc.json", os.path.join(d, "tc.json"))
            for a in overrides]
    if overrides[0] == "task=train":
        outs = []
        for tag, extra in (("a", args), ("b", ["task=train"])):
            mdir = os.path.join(d, f"m{tag}")
            assert port_main.main([conf, f"model_dir={mdir}",
                                   "num_round=1"] + extra) == 0
            with open(os.path.join(mdir, "0001.model"), "rb") as f:
                outs.append(f.read())
        assert outs[0] == outs[1]
        return
    model = os.path.join(d, "0001.model")
    tr = NetTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d),
                    device="cpu")
    tr.init_model()
    with open(model, "wb") as fo:
        tr.save_model(fo)
    outs = []
    for tag, extra in (("a", args), ("b", ["task=pred"])):
        out = os.path.join(d, f"{tag}.txt")
        assert port_main.main([conf, f"model_in={model}", f"pred={out}"]
                              + extra) == 0
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 100
