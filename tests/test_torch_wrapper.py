"""The port's numpy wrapper (cxxnet_tpu_torch/wrapper.py) held to the
JAX package's (cxxnet_tpu/wrapper.py) on the CPU: the cases of
tests/test_wrapper.py, with both Nets holding the same weights (carried
from the JAX Net). Training steps agree at STEP_TOL (rtol 1e-4 / atol
1e-5, tests/test_torch_train.py), predicted rows at JAX_TOL (rtol 1e-4 /
atol 1e-5); train()'s staged and prefetched paths are bitwise equal
within the port."""

import gzip
import struct

import numpy as np
import pytest
import torch

import cxxnet_tpu.wrapper as JW
import cxxnet_tpu_torch.wrapper as PW
from torch_port_util import carry

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)

NET_CFG = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1] = tanh
layer[+1] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,6
metric = error
silent = 1
"""


def synth(n=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 1, 1, 6).astype(np.float32)
    y = (x.reshape(n, 6).sum(axis=1) > 0).astype(np.float32)
    return x, y


def _pair(cfg=NET_CFG, params=(("batch_size", 32), ("eta", 0.5))):
    nets = []
    for mod in (JW, PW):
        net = mod.Net(dev="cpu", cfg=cfg)
        for k, v in params:
            net.set_param(k, v)
        net.init_model()
        nets.append(net)
    carry(nets[0]._net, nets[1]._net)
    return nets


def _weights(net, jax_side):
    return {lk: {pn: (np.asarray(t) if jax_side else t.numpy())
                 for pn, t in d.items()}
            for lk, d in net._net.state["params"].items()}


def test_update_predict_and_extract_match_jax():
    jn, pn = _pair()
    x, y = synth()
    for r in range(3):
        jn.start_round(r)
        pn.start_round(r)
        for i in range(0, 128, 32):
            jn.update(x[i:i + 32], y[i:i + 32])
            pn.update(x[i:i + 32], y[i:i + 32])
    want, got = _weights(jn, True), _weights(pn, False)
    for lk in want:
        for k in want[lk]:
            np.testing.assert_allclose(got[lk][k], want[lk][k], **STEP_TOL)
    np.testing.assert_allclose(pn.predict_dist(x[:32]),
                               jn.predict_dist(x[:32]), **JAX_TOL)
    np.testing.assert_array_equal(pn.predict(x[:32]), jn.predict(x[:32]))
    assert (pn.predict(x[:32]) == y[:32]).mean() > 0.9
    for node in ("fc1", "top[-2]", "top[-1]"):
        j, p = jn.extract(x[:32], node), pn.extract(x[:32], node)
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, **JAX_TOL)


def test_label_validation_matches_jax():
    x, y = synth(4)
    for net in _pair(params=(("batch_size", 4), ("eta", 0.1))):
        with pytest.raises(ValueError, match="need label"):
            net.update(x, None)
        with pytest.raises(ValueError, match="data size mismatch"):
            net.update(x, y[:2])
        with pytest.raises(ValueError, match="4 dimensional"):
            net.update(x.reshape(4, 6), y)
        with pytest.raises(TypeError):
            net.update([1, 2], y)


def test_get_set_weight_roundtrip_matches_jax():
    jn, pn = _pair(params=(("batch_size", 4),))
    w = pn.get_weight("fc1", "wmat")
    assert w.shape == (16, 6)
    np.testing.assert_array_equal(w, jn.get_weight("fc1", "wmat"))
    assert pn.get_weight("fc1", "bias").shape == jn.get_weight(
        "fc1", "bias").shape
    new = np.arange(96, dtype=np.float32).reshape(16, 6) / 7.0
    for net in (jn, pn):
        net.set_weight(new, "fc1", "wmat")
    np.testing.assert_array_equal(pn.get_weight("fc1", "wmat"), new)
    x, _ = synth(4)
    np.testing.assert_allclose(pn.predict_dist(x), jn.predict_dist(x),
                               **JAX_TOL)
    assert pn.has_layer("fc1") and not pn.has_layer("nope")
    with pytest.raises(KeyError):
        pn.get_weight("fc1", "nope")


def test_train_convenience():
    x, y = synth(256)
    net = PW.train(NET_CFG, x, y, num_round=8,
                   param={"eta": 0.5, "momentum": 0.9}, batch_size=32,
                   dev="cpu", eval_data=(x[:64], y[:64]))
    assert (net.predict(x[:32]) == y[:32]).mean() > 0.85


def test_train_staged_equals_streamed(monkeypatch):
    """train()'s staged path (small datasets, staged once) and its
    prefetched path give the same trajectory, bit for bit."""
    rng = np.random.RandomState(3)
    w = rng.randn(6)
    x = rng.randn(64, 1, 1, 6).astype(np.float32)
    y = (x.reshape(64, 6) @ w > 0).astype(np.float32)
    param = {"eta": 0.3, "momentum": 0.9, "seed": 4}
    calls = []
    orig = PW.NetTrainer.stage_batch

    def spy(self, b, ring=None):
        calls.append(1)
        return orig(self, b, ring)

    monkeypatch.setattr(PW.NetTrainer, "stage_batch", spy)
    staged = PW.train(NET_CFG, x, y, num_round=3, param=param,
                      batch_size=16, dev="cpu")
    # n_batches calls = staged once; streaming stages per update
    assert len(calls) == 4
    monkeypatch.setattr(PW, "_STAGE_BYTES_LIMIT", 0)
    streamed = PW.train(NET_CFG, x, y, num_round=3, param=param,
                        batch_size=16, dev="cpu")
    assert len(calls) == 4 + 12
    a, b = _weights(staged, False), _weights(streamed, False)
    for lk in a:
        for k in a[lk]:
            np.testing.assert_array_equal(a[lk][k], b[lk][k])


def test_sequence_model_matches_jax():
    """The wrapper drives the sequence family (layernorm + causal
    attention) as the JAX wrapper does."""
    cfg = """
netconfig=start
layer[0->1] = layernorm:ln1
layer[1->2] = attention:att1
  nhead = 2
  causal = 1
layer[2->3] = flatten
layer[3->4] = fullc:head
  nhidden = 4
layer[4->4] = softmax
netconfig=end
input_shape = 1,4,8
batch_size = 8
eta = 0.05
random_type = xavier
silent = 1
"""
    jn, pn = _pair(cfg, params=())
    rng = np.random.RandomState(2)
    x = rng.randn(8, 1, 4, 8).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    for _ in range(3):
        jn.update(x, y)
        pn.update(x, y)
    pred = pn.predict(x)
    assert pred.shape == (8,) and np.isfinite(pred).all()
    np.testing.assert_allclose(pn.predict_dist(x), jn.predict_dist(x),
                               **JAX_TOL)


def _write_mnist_gz(tmp_path, images, labels):
    n, rows, cols = images.shape
    img_path, lbl_path = str(tmp_path / "i.gz"), str(tmp_path / "l.gz")
    with gzip.open(img_path, "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, rows, cols))
        f.write(images.tobytes())
    with gzip.open(lbl_path, "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())
    return img_path, lbl_path


def test_dataiter_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, size=(64, 4, 4), dtype=np.uint8)
    labels = rng.randint(0, 2, size=64, dtype=np.uint8)
    img, lbl = _write_mnist_gz(tmp_path, images, labels)
    cfg = (f'iter = mnist\npath_img = "{img}"\npath_label = "{lbl}"\n'
           "batch_size = 16\nsilent = 1\n")
    its = [JW.DataIter(cfg), PW.DataIter(cfg)]
    for it in its:
        with pytest.raises(RuntimeError, match="head state"):
            it.get_data()
    counts = []
    for it in its:
        n = 0
        while it.next():
            n += 1
        counts.append(n)
        with pytest.raises(RuntimeError, match="reaches end"):
            it.get_label()
        it.before_first()
        assert it.next()
    assert counts == [4, 4]
    np.testing.assert_array_equal(its[1].get_data(), its[0].get_data())
    np.testing.assert_array_equal(its[1].get_label(), its[0].get_label())
    assert its[1].get_data().shape == (16, 1, 1, 16)


def test_net_drives_dataiter_batches_as_jax(tmp_path):
    rng = np.random.RandomState(7)
    images = rng.randint(0, 255, size=(32, 4, 4)).astype(np.uint8)
    labels = rng.randint(0, 2, size=32).astype(np.uint8)
    img, lbl = _write_mnist_gz(tmp_path, images, labels)
    it_cfg = (f'iter = mnist\npath_img = "{img}"\npath_label = "{lbl}"\n'
              "batch_size = 16\ninput_flat = 1\nsilent = 1\n")
    cfg = """
netconfig=start
layer[+1] = fullc:fc1
  nhidden = 8
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = 16
eta = 0.1
metric = error
silent = 1
"""
    jn, pn = _pair(cfg, params=())
    outs = []
    for mod, net in ((JW, jn), (PW, pn)):
        it = mod.DataIter(it_cfg)
        while it.next():
            net.update(it)
        it.before_first()
        assert it.next()
        outs.append((net.predict(it), net.predict_dist(it),
                     net.extract(it, "top[-2]"), net.evaluate(it, "t")))
    (jp, jd, jf, je), (pp, pd, pf, pe) = outs
    assert pp.shape == (16,) and pd.shape == (16, 8)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_allclose(pd, jd, **JAX_TOL)
    np.testing.assert_allclose(pf, jf, **JAX_TOL)
    assert pe == je
    with pytest.raises(TypeError):
        pn.evaluate(np.zeros((16, 1, 1, 16), np.float32), "t")


def test_serve_calls_answer_predict_dist_rows():
    _jn, pn = _pair(params=(("batch_size", 8),))
    x, _ = synth(20, 5)
    pn.serve_start(max_batch=8, max_wait_ms=1.0, replicas=2)
    with pytest.raises(RuntimeError, match="already started"):
        pn.serve_start()
    rows = pn.serve_submit(x[:5])
    fut = pn.serve_submit(x[5:20], block=False)
    stats = pn.serve_stop()
    assert stats["requests"] == 2 and stats["rows"] == 20
    np.testing.assert_allclose(rows, pn.predict_dist(x[:5]),
                               rtol=1e-5, atol=1e-6)
    assert fut.result().shape == (15, 2)
    with pytest.raises(RuntimeError, match="serve_start"):
        pn.serve_submit(x[:1])


def test_default_device_is_the_card():
    """With no card the wrapper's default device raises and names the
    CPU spelling (the JAX wrapper defaults to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y = synth(32)
    for make in (lambda: PW.Net(cfg=NET_CFG),
                 lambda: PW.train(NET_CFG, x, y, num_round=1, param={}),
                 lambda: PW.Net(dev="gpu", cfg=NET_CFG)):
        with pytest.raises(RuntimeError, match="cpu"):
            make()
