"""The port's C ABI on the CPU: the library (csrc/cxxnet_wrapper.cc,
embedding CPython over cxxnet_tpu_torch.capi) and its C driver
(csrc/capi_driver.c) built with g++, the driver run in a subprocess with
device `cpu` on separable synthetic MNIST data (training, the iterator
surface, evaluate, predict, extract, a model round trip and a weight
round trip, all through the CXN* entry points), the header's prototypes
against the JAX package's native/cxxnet_wrapper.h, and fault F3: both
CLIs accept `net_type = 1` and `compile_cache` and write byte-equal
checkpoints.

The driver's top[-1] rows are held to wrapper.Net on the model it saved
at rtol 1e-5 / atol 1e-6 (one float32 forward in two processes, whose
CPU kernels may split the work differently)."""

import gzip
import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch import capi_build, kernels
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.nnet import trainer as port_trainer
from cxxnet_tpu_torch.wrapper import Net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELF_TOL = dict(rtol=1e-5, atol=1e-6)

DRIVER_NET = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 32
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 10
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,784
random_type = xavier
eta = 0.1
momentum = 0.9
batch_size = 20
seed = 0
silent = 1
metric = error
"""


def write_separable_mnist(d, prefix, n, seed):
    """The synthetic MNIST of .claude/skills/verify/SKILL.md: noise plus
    a bright block whose place is the class."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = np.zeros((n, 28, 28), dtype=np.uint8)
    for i, y in enumerate(labels):
        img = rng.randn(28, 28) * 8 + 20
        r, c = divmod(int(y), 5)
        img[r * 10 + 2:r * 10 + 10, c * 5 + 1:c * 5 + 6] += 150
        images[i] = np.clip(img, 0, 255)
    img = os.path.join(d, f"{prefix}-images-idx3-ubyte.gz")
    lab = os.path.join(d, f"{prefix}-labels-idx1-ubyte.gz")
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28))
        f.write(images.tobytes())
    with gzip.open(lab, "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())
    return img, lab


def test_driver_trains_predicts_and_round_trips_on_the_cpu(tmp_path):
    exe = capi_build.build_driver()
    img, lab = write_separable_mnist(str(tmp_path), "train", 200, 3)
    (tmp_path / "net.conf").write_text(DRIVER_NET)
    (tmp_path / "iter.conf").write_text(
        f'iter = mnist\npath_img = "{img}"\npath_label = "{lab}"\n'
        "input_flat = 1\nbatch_size = 20\niter = end\n")
    model = str(tmp_path / "model.bin")
    out = subprocess.run(
        [exe, "cpu", str(tmp_path / "net.conf"),
         f"iter:{tmp_path / 'iter.conf'}", model, "fc1", "30",
         str(tmp_path)],
        env=capi_build.driver_env(dict(
            os.environ, CXXNET_LAUNCH_LOG=str(tmp_path / "launches.json"))),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout, out.stderr)
    # the shim's launch log: no kernel runs on the CPU
    launches = json.loads((tmp_path / "launches.json").read_text())
    assert launches == {k: 0 for k in kernels.LAUNCHES}
    assert "c-abi driver: all checks passed" in out.stdout
    acc = float(re.search(r"train accuracy: ([0-9.]+)", out.stdout)[1])
    assert acc > 0.9
    assert re.search(r"c-abi images/s: [0-9.]+", out.stdout)
    shape = [int(t) for t in (tmp_path / "shape.txt").read_text().split()]
    assert shape == [20, 1, 1, 784, 10]
    batch = np.fromfile(tmp_path / "batch.f32", np.float32).reshape(
        shape[:4])
    rows = np.fromfile(tmp_path / "rows.f32", np.float32).reshape(20, 10)
    net = Net(dev="cpu", cfg=DRIVER_NET)
    net.load_model(model)
    np.testing.assert_allclose(net.extract(batch, "top[-1]").reshape(20, 10),
                               rows,
                               **SELF_TOL)


def test_driver_refuses_a_card_it_does_not_have(tmp_path):
    """`gpu` with no card: CXNNetCreate fails and names `cpu`."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    exe = capi_build.build_driver()
    (tmp_path / "net.conf").write_text(DRIVER_NET)
    out = subprocess.run(
        [exe, "gpu", str(tmp_path / "net.conf"), "rand:20,1,1,784,10",
         str(tmp_path / "m.bin"), "fc1", "2", str(tmp_path)],
        env=capi_build.driver_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 1
    assert "CHECK failed" in out.stderr and "cpu" in out.stderr


def _prototypes(path):
    """Every CXN* declaration of a header, whitespace-normalized."""
    with open(path) as f:
        text = re.sub(r"/\*.*?\*/", " ", f.read(), flags=re.S)
    decls = re.findall(r"[^;{}#]*\bCXN\w+\s*\([^;]*\);", text)
    return sorted(" ".join(d.split()) for d in decls)


def test_header_prototypes_equal_the_jax_packages():
    port = _prototypes(os.path.join(REPO, "cxxnet_tpu_torch", "csrc",
                                    "cxxnet_wrapper.h"))
    jax_h = _prototypes(os.path.join(REPO, "native", "cxxnet_wrapper.h"))
    assert len(port) == 24
    assert port == jax_h


def test_embed_facts_name_what_embedding_needs():
    f = capi_build.embed_facts()
    assert f["Python.h"] and f["libpython"] and f["g++"]
    assert any(t.startswith("-lpython") for t in capi_build.embed_flags())


# ---------------------------------------------------------------------------
# F3: keys the reference accepts without effect on results
# ---------------------------------------------------------------------------
F3_CONF = """
data = train
iter = mnist
  path_img = "{img}"
  path_label = "{lab}"
  input_flat = 1
iter = end
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 10
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,784
batch_size = 20
eta = 0
lr:minimum_lr = 0
momentum = 0
silent = 1
dev = cpu
"""


def test_f3_keys_leave_the_not_ported_maps():
    assert "net_type" not in port_main._NOT_PORTED
    assert "compile_cache" not in port_trainer._NOT_PORTED


def test_f3_net_type_and_compile_cache_through_both_clis(tmp_path):
    """Both CLIs run `net_type = 1 compile_cache = DIR` and write
    byte-equal checkpoints: each loads one JAX checkpoint and trains a
    round at a learning rate of 0 (eta and the schedule's floor), which
    leaves every weight as loaded (the saved round carries the same
    weights and update counter in both)."""
    d = str(tmp_path)
    img, lab = write_separable_mnist(d, "train", 100, 4)
    conf = os.path.join(d, "f3.conf")
    with open(conf, "w") as f:
        f.write(F3_CONF.format(img=img, lab=lab))
    jt = JaxTrainer(cfg=F3_CONF.format(img=img, lab=lab))
    jt.init_model()
    start = os.path.join(d, "0000.model")
    with open(start, "wb") as fo:
        jt.save_model(fo)
    keys = ["net_type=1", f"compile_cache={d}/cache", f"model_in={start}",
            "num_round=1"]
    jdir, pdir = os.path.join(d, "jax"), os.path.join(d, "port")
    p = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu.main", conf,
         f"model_dir={jdir}"] + keys,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    assert port_main.main([conf, f"model_dir={pdir}"] + keys) == 0
    with open(os.path.join(jdir, "0001.model"), "rb") as a, \
            open(os.path.join(pdir, "0001.model"), "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    # the saved weights are the loaded ones
    from cxxnet_tpu_torch.nnet import checkpoint
    with open(start, "rb") as f:
        before = checkpoint.load_model(f)["params"]
    with open(os.path.join(pdir, "0001.model"), "rb") as f:
        after = checkpoint.load_model(f)
    assert after["epoch"] == 5
    for lk, d in before.items():
        for pn, arr in d.items():
            np.testing.assert_array_equal(after["params"][lk][pn], arr)
    task = port_main.LearnTask()
    task.set_param("net_type", "7")
    assert task.net_type == 7
