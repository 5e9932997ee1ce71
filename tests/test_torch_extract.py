"""The CLI tails of the port against the JAX CLI on the CPU: `task =
extract` (by node name and `top[-k]`, text and raw float32 rows, the
`.meta` line, no file from an empty iterator), `keep_latest` checkpoint
rotation with `continue = 1`, and `test_io`.

Byte-equal outputs across the two packages need the same float32 bits,
which XLA:CPU and torch give only where the arithmetic is exact. The
extract net is built so that it is: max-pooling of MNIST pixels (k/256),
two fully connected layers whose carried weights are rounded to a few
bits (multiples of 1/16 in [-1/2, 1/2], then halves in [-1, 1]) and a
relu, so every product and every partial sum up to the pre-softmax node
is exact in float32 in any summation order. Those nodes are compared
byte for byte, text and raw; the softmax node (exp) at JAX_TOL (rtol
1e-4 / atol 1e-5, tests/test_torch_serve.py)."""

import gzip
import os
import struct

import jax
import numpy as np
import pytest

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch import main as port_main

JAX_TOL = dict(rtol=1e-4, atol=1e-5)

EXTRACT_CONF = """
data = train
iter = mnist
  path_img = "{d}/train-images-idx3-ubyte.gz"
  path_label = "{d}/train-labels-idx1-ubyte.gz"
  input_flat = 0
  shuffle = 0
iter = end
pred = {out}
iter = mnist
  path_img = "{d}/{pred}-images-idx3-ubyte.gz"
  path_label = "{d}/{pred}-labels-idx1-ubyte.gz"
  input_flat = 0
iter = end

netconfig=start
layer[0->1] = max_pooling
  kernel_size = 2
  stride = 2
layer[1->2] = flatten
layer[2->3] = fullc:fc1
  nhidden = 16
layer[3->4] = relu
layer[4->5] = fullc:fc2
  nhidden = 10
layer[5->5] = softmax
netconfig=end
input_shape = 1,28,28
batch_size = 25
eta = 0.1
seed = 5
silent = 1
dev = cpu
model_dir = {d}/models
"""


def write_mnist(d, prefix, n, seed):
    """A synthetic MNIST-format set: noise plus a class-dependent block."""
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


def _conf(d, pred="t10k", out="unused.txt"):
    path = os.path.join(d, "net.conf")
    with open(path, "w") as f:
        f.write(EXTRACT_CONF.format(d=d, out=os.path.join(d, out),
                                    pred=pred))
    return path


@pytest.fixture(scope="module")
def extract_set(tmp_path_factory):
    """The data, the conf and a JAX checkpoint with few-bit weights."""
    d = str(tmp_path_factory.mktemp("extract"))
    write_mnist(d, "train", 100, 3)
    write_mnist(d, "t10k", 75, 4)
    write_mnist(d, "empty", 0, 5)
    conf = _conf(d)
    jt = JaxTrainer(cfg=EXTRACT_CONF.format(d=d, out="u", pred="t10k"))
    jt.init_model()
    params = jax.tree.map(np.asarray, jt.state["params"])
    rng = np.random.RandomState(9)
    w1 = rng.randint(-8, 9, size=params["fc1"]["wmat"].shape) / 16.0
    w2 = rng.randint(-2, 3, size=params["fc2"]["wmat"].shape) / 2.0
    for lk, w in (("fc1", w1), ("fc2", w2)):
        jt.set_weight(w.astype(np.float32), lk, "wmat")
    model = os.path.join(d, "0001.model")
    with open(model, "wb") as fo:
        jt.save_model(fo)
    return d, conf, model


def _extract(mod, d, conf, model, node, fmt, tag):
    out = os.path.join(d, f"{tag}.bin")
    rc = mod.main([conf, "task=extract", f"model_in={model}",
                   f"extract_node_name={node}", f"output_format={fmt}",
                   f"pred={out}"])
    assert rc == 0
    with open(out, "rb") as f, open(out + ".meta") as fm:
        return f.read(), fm.read()


@pytest.mark.parametrize("node,same_as", [
    ("3", None), ("4", "top[-2]"), ("1", None)])
@pytest.mark.parametrize("fmt", ["txt", "bin"])
def test_extract_outputs_byte_equal_to_jax(extract_set, node, same_as, fmt):
    d, conf, model = extract_set
    jx = _extract(jax_main, d, conf, model, node, fmt, f"j{node}{fmt}")
    pt = _extract(port_main, d, conf, model, node, fmt, f"p{node}{fmt}")
    assert pt == jx
    width = {"1": (1, 14, 14), "3": (1, 1, 16), "4": (1, 1, 16)}[node]
    assert pt[1] == "75,%d,%d,%d\n" % width
    if fmt == "bin":
        assert len(pt[0]) == 75 * int(np.prod(width)) * 4
    else:
        assert len(pt[0].decode().splitlines()) == 75
    if same_as:
        for mod, tag in ((jax_main, "j"), (port_main, "p")):
            assert _extract(mod, d, conf, model, same_as, fmt,
                            f"{tag}{same_as}{fmt}") == pt


def test_extract_top_node_matches_jax_and_pred_raw(extract_set):
    d, conf, model = extract_set
    rows = {}
    for mod, tag in ((jax_main, "j"), (port_main, "p")):
        raw, meta = _extract(mod, d, conf, model, "top[-1]", "bin",
                             f"{tag}top")
        assert meta == "75,1,1,10\n"
        rows[tag] = np.frombuffer(raw, np.float32).reshape(75, 10)
    np.testing.assert_allclose(rows["p"], rows["j"], **JAX_TOL)
    out = os.path.join(d, "raw.txt")
    assert port_main.main([conf, "task=pred_raw", f"model_in={model}",
                           f"pred={out}"]) == 0
    np.testing.assert_array_equal(
        np.loadtxt(out, dtype=np.float32),
        np.array([[float(f"{v:g}") for v in r] for r in rows["p"]],
                 np.float32))
    assert kernels.launches()["lrn_fwd"] == 0


def test_extract_empty_iterator_leaves_no_file(extract_set):
    d, _conf0, model = extract_set
    conf = _conf(d, pred="empty")
    for mod, tag in ((jax_main, "j"), (port_main, "p")):
        out = os.path.join(d, f"{tag}empty.txt")
        with pytest.raises(ValueError, match="yielded no data"):
            mod.main([conf, "task=extract", f"model_in={model}",
                      "extract_node_name=3", f"pred={out}"])
        assert not os.path.exists(out)
        assert not os.path.exists(out + ".meta")
        assert not os.path.exists(out + ".tmp")
    with pytest.raises(ValueError, match="extract node name"):
        port_main.main([_conf(d), "task=extract", f"model_in={model}"])


def test_keep_latest_rotation_then_resume(tmp_path):
    d = str(tmp_path)
    write_mnist(d, "train", 100, 3)
    write_mnist(d, "t10k", 25, 4)
    conf = _conf(d)
    assert port_main.main([conf, "keep_latest=2", "num_round=6"]) == 0
    models = os.path.join(d, "models")
    assert sorted(os.listdir(models)) == ["0005.model", "0006.model"]
    assert port_main.main([conf, "continue=1", "num_round=8",
                           "keep_latest=2"]) == 0
    assert sorted(os.listdir(models)) == ["0007.model", "0008.model"]


def test_keep_latest_keeps_what_the_jax_cli_keeps(tmp_path):
    kept = []
    for mod in (jax_main, port_main):
        d = str(tmp_path / mod.__name__.split(".")[0])
        os.makedirs(d)
        write_mnist(d, "train", 50, 3)
        write_mnist(d, "t10k", 25, 4)
        conf = _conf(d)
        os.makedirs(os.path.join(d, "models"))
        # a stale higher counter is left alone, rescue.model too
        for name in ("0009.model", "rescue.model"):
            with open(os.path.join(d, "models", name), "wb") as f:
                f.write(b"x")
        assert mod.main([conf, "keep_latest=3", "num_round=5"]) == 0
        kept.append(sorted(os.listdir(os.path.join(d, "models"))))
    assert kept[0] == kept[1] == ["0003.model", "0004.model",
                                  "0005.model", "0009.model",
                                  "rescue.model"]


def test_test_io_runs_the_pipeline_and_skips_the_update(tmp_path, capfd):
    d = str(tmp_path)
    write_mnist(d, "train", 100, 3)
    write_mnist(d, "t10k", 25, 4)
    conf = _conf(d)
    kernels.reset_launches()
    assert port_main.main([conf, "test_io=1", "num_round=1",
                           "silent=0"]) == 0
    out = capfd.readouterr()
    assert "start I/O test" in out.out
    assert "train-error" not in out.err
    assert kernels.launches() == {k: 0 for k in kernels.LAUNCHES}
    # the update was skipped: the round's checkpoint holds the init
    with open(os.path.join(d, "models", "0000.model"), "rb") as a, \
            open(os.path.join(d, "models", "0001.model"), "rb") as b:
        from cxxnet_tpu_torch.nnet import checkpoint
        pa, pb = checkpoint.load_model(a), checkpoint.load_model(b)
    assert pb["epoch"] == 0
    for lk in pa["params"]:
        for pn in pa["params"][lk]:
            np.testing.assert_array_equal(pa["params"][lk][pn],
                                          pb["params"][lk][pn])
