"""The port's parallel/ package against the JAX package's (CPU).

- parsing: parse_device_spec / parse_mesh_spec and the data axis's
  pruning equal the JAX functions, errors included;
- ZeRO-1: zero1_eligible_dim and zero_partition_dims equal the JAX
  package's on narrow AlexNet and examples/MNIST/dist.conf's MLP;
- the CLI: examples/MNIST/dist.conf (shrunk to a small synthetic set)
  under launch_dist -n 2 against the JAX package's launch_dist run of
  the same conf from one initial checkpoint: the same round lines and
  checkpoint params within rtol 1e-5 / atol 1e-6;
- check_weights catches a rank whose weight was perturbed; launch_dist
  ends a job whose rank died, non-zero, within its timeout; the axes
  and tasks that are not ported raise naming themselves.
"""

import gzip
import os
import re
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

import jax

from cxxnet_tpu.parallel import mesh as jmesh
from cxxnet_tpu.parallel import sharding as jshard
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.parallel import mesh as pmesh
from cxxnet_tpu_torch.parallel import sharding as pshard
from test_torch_distributed import (MLP, REPO, SMALL_MLP, free_port,
                                    jax_trainer, spawn, worker_env)
from torch_port_util import NARROW_ALEXNET

CLI_TIMEOUT = 300


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the error type is the result
        return ("err", type(e).__name__)


@pytest.mark.parametrize("spec", [
    "cpu", "gpu", "tpu:0-3", "gpu:0,2", "gpu:1", "tpu:0-63", "cpu:0,2",
    "gpu:a", "gpu:0-", "gpu:1-2-3"])
def test_parse_device_spec_equals_jax(spec):
    assert (_outcome(pmesh.parse_device_spec, spec)
            == _outcome(jmesh.parse_device_spec, spec))


@pytest.mark.parametrize("spec", [
    "data:8", "data:8,model:4", " data : 2", "data:1,seq:2",
    "data", "data:x", "data:2,"])
def test_parse_mesh_spec_equals_jax(spec):
    assert (_outcome(pmesh.parse_mesh_spec, spec)
            == _outcome(jmesh.parse_mesh_spec, spec))


@pytest.mark.parametrize("axes,idx,batch", [
    ([("data", 2)], None, 8), ([("data", 4)], None, 6),
    ([("data", 8)], None, 100), ([("data", 3)], None, 7),
    ([("data", 1)], None, 5), (None, [0, 1, 2, 3], 6),
    (None, [0, 2], 4), (None, None, 9)])
def test_data_axis_pruning_equals_jax(axes, idx, batch):
    """A single-process job prunes the data axis to divide the batch,
    as the JAX package's build_mesh does over its local devices."""
    j = jmesh.build_mesh(jmesh.MeshSpec(idx, list(axes or [])), batch,
                         jax.devices()[:8])
    got = pmesh.data_axis(pmesh.MeshSpec(idx, list(axes or [])), batch, 1)
    assert got == dict(zip(j.axis_names, j.devices.shape))["data"]


def test_data_axis_multi_process_rules():
    """A multi-process job refuses an indivisible batch (the JAX text)
    and defaults the data axis to the whole job."""
    with pytest.raises(ValueError, match="multi-controller"):
        pmesh.data_axis(pmesh.MeshSpec(None, [("data", 2)]), 7, 2)
    assert pmesh.data_axis(pmesh.MeshSpec(), 8, 4) == 4
    m = pmesh.build_mesh(pmesh.MeshSpec(), 8, 2, 1)
    assert (m.shape, m.rank) == ({"data": 2}, 1)


@pytest.mark.parametrize("spec,shape,dsize", [
    ((), (96, 3, 11, 11), 2), ((), (4096,), 2), ((), (10, 4096), 4),
    ((), (7, 5), 2), ((None, "model"), (6, 8), 2), (("model",), (6, 9), 3),
    ((), (3,), 3), ((), (1000, 4096), 8)])
def test_zero1_eligible_dim_equals_jax(spec, shape, dsize):
    assert (pshard.zero1_eligible_dim(spec, shape, dsize)
            == jshard.zero1_eligible_dim(spec, shape, dsize))


@pytest.mark.parametrize("net,dsize", [
    (NARROW_ALEXNET, 2), (NARROW_ALEXNET, 4), (MLP, 2), (MLP, 8)])
def test_zero_partition_dims_equal_jax(net, dsize):
    """The ZeRO-1 cut of every weight on narrow AlexNet and dist.conf's
    MLP equals the JAX package's on a data mesh over the conftest's
    virtual CPU devices."""
    cfg = net + "\nbatch_size = 8\nsilent = 1\n"
    from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
    from cxxnet_tpu.utils.config import parse_config_string
    jt = JaxTrainer()
    for k, v in parse_config_string(cfg):
        jt.set_param(k, v)
    jt.set_param("mesh", f"data:{dsize}")
    jt.init_model()
    want = jshard.zero_partition_dims(jt.mesh, jt.net, jt._pshard)
    pt = NetTrainer(device="cpu", cfg=cfg)
    pt.init_model()
    shapes = {lk: {pn: tuple(t.shape) for pn, t in d.items()}
              for lk, d in pt.state["params"].items()}
    got = pshard.zero_partition_dims(
        pmesh.Mesh((("data", dsize),)), shapes)
    assert got == want


# ---------------------------------------------------------------------------
# the CLI: dist.conf under launch_dist against the JAX package's
# ---------------------------------------------------------------------------

def write_idx(d, prefix, n, seed):
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


def dist_conf(d: str) -> str:
    """examples/MNIST/dist.conf with its data paths pointed at d, a
    batch of 20, 2 rounds and a checkpoint per round."""
    with open(os.path.join(REPO, "examples", "MNIST", "dist.conf")) as f:
        text = f.read()
    text = text.replace('"./data/', f'"{d}/data/')
    text = text.replace("batch_size = 100", "batch_size = 20")
    text = text.replace("num_round = 15", "num_round = 2")
    path = os.path.join(d, "dist.conf")
    with open(path, "w") as f:
        f.write(text + "\ntest_on_server = 1\nsave_model = 1\n")
    return path


ROUND = re.compile(r"^\[(\d+)\]\ttrain-error:(\S+)\ttest-error:(\S+)$",
                   re.M)


def run_launch(module: str, d: str, conf: str, model_dir: str, extra=()):
    env = worker_env(0, 1, 0)
    for k in ("CXN_COORDINATOR", "CXN_NUM_WORKER", "CXN_WORKER_RANK"):
        env.pop(k)
    env["XLA_FLAGS"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    # each rank writes its checkpoints into model_dir<rank>: the JAX
    # CLI's ranks share one temporary file name and collide when they
    # write one directory (the port's do not:
    # test_cli_ranks_share_one_model_dir)
    cli = " ".join([sys.executable, "-m", f"{module}.main", conf,
                    f"model_in={d}/init.model",
                    f"model_dir={model_dir}$CXN_WORKER_RANK", "silent=1",
                    *extra])
    cmd = [sys.executable, "-m", f"{module}.tools.launch_dist", "-n", "2",
           "--coordinator", f"127.0.0.1:{free_port()}", "--",
           "sh", "-c", f"exec {cli}"]
    out = subprocess.run(cmd, env=env, cwd=d, capture_output=True,
                         text=True, timeout=CLI_TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    return out


def test_cli_dist_conf_matches_jax_launch_dist(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "data"))
    write_idx(os.path.join(d, "data"), "train", 160, 3)
    write_idx(os.path.join(d, "data"), "t10k", 80, 4)
    conf = dist_conf(d)
    jt = jax_trainer(MLP.replace("batch_size = 8", "batch_size = 20"))
    with open(os.path.join(d, "init.model"), "wb") as f:
        jt.save_model(f)
    jout = run_launch("cxxnet_tpu", d, conf, f"{d}/jax")
    pout = run_launch("cxxnet_tpu_torch", d, conf, f"{d}/port",
                      ["dev=cpu"])
    jrounds = sorted(set(ROUND.findall(jout.stderr)))
    prounds = sorted(set(ROUND.findall(pout.stderr)))
    # both ranks print the same lines: one distinct line a round
    assert [r[0] for r in jrounds] == [r[0] for r in prounds] == ["1", "2"]
    assert prounds == jrounds, (prounds, jrounds)
    assert "diverge" not in pout.stderr
    from cxxnet_tpu_torch.nnet import checkpoint
    names = sorted(os.listdir(f"{d}/jax0"))
    assert names and names == sorted(os.listdir(f"{d}/port0"))
    for name in names:
        with open(f"{d}/jax0/{name}", "rb") as f:
            want = checkpoint.load_model(f)["params"]
        with open(f"{d}/port0/{name}", "rb") as f:
            got = checkpoint.load_model(f)["params"]
        for lk in want:
            for pn in want[lk]:
                np.testing.assert_allclose(got[lk][pn], want[lk][pn],
                                           rtol=1e-5, atol=1e-6)


def test_cli_ranks_share_one_model_dir(tmp_path):
    """Every rank of the port's CLI writes the checkpoint into one
    model_dir, each through its own temporary file: no collision, no
    temporary left, and the ranks' files are equal."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "data"))
    write_idx(os.path.join(d, "data"), "train", 80, 5)
    write_idx(os.path.join(d, "data"), "t10k", 40, 6)
    conf = dist_conf(d)
    pt = NetTrainer(device="cpu", cfg=MLP + "\nsilent = 1\n")
    pt.init_model()
    with open(os.path.join(d, "init.model"), "wb") as f:
        pt.save_model(f)
    env = worker_env(0, 1, 0)
    for k in ("CXN_COORDINATOR", "CXN_NUM_WORKER", "CXN_WORKER_RANK"):
        env.pop(k)
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.launch_dist", "-n",
         "2", "--coordinator", f"127.0.0.1:{free_port()}", "--",
         sys.executable, "-m", "cxxnet_tpu_torch.main", conf, "dev=cpu",
         f"model_in={d}/init.model", f"model_dir={d}/m", "silent=1"],
        env=env, cwd=d, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    assert out.returncode == 0, out.stderr
    files = sorted(os.listdir(f"{d}/m"))
    assert files and not [f for f in files if ".tmp" in f], files


# ---------------------------------------------------------------------------
# check_weights, a dead rank, and what is not ported
# ---------------------------------------------------------------------------

PERTURB = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
t = NetTrainer(device="cpu", cfg=os.environ["CXN_TEST_CFG"])
t.init_model()
rank = int(os.environ["CXN_WORKER_RANK"])
rng = np.random.RandomState(0)
data = rng.randn(8, 1, 1, 8).astype(np.float32)
label = rng.randint(0, 4, size=(8, 1)).astype(np.float32)
lo, lb = t._local_row_start, t._local_batch
t.update(DataBatch(data=data[lo:lo + lb], label=label[lo:lo + lb]))
before = t.check_weights()
if rank == 1:
    t.state["params"]["fc2"]["wmat"][0, 0] += 1e-6
print(json.dumps({"before": before, "after": t.check_weights()}))
"""


def test_check_weights_catches_a_perturbed_rank(tmp_path):
    script = tmp_path / "perturb.py"
    script.write_text(PERTURB)
    cfg = SMALL_MLP.format(fg=0) + "param_server = dist\nsilent = 1\n"
    res = spawn([sys.executable, str(script)], extra={"CXN_TEST_CFG": cfg})
    import json
    for rc, out in res:
        assert rc == 0, out
        rep = json.loads(out.strip().splitlines()[-1])
        assert rep["before"] == []
        assert rep["after"] == ["params['fc2']['wmat']: rank 1 diverges "
                                "from rank 0"]


DIE = r"""
import os, sys
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
import numpy as np
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
t = NetTrainer(device="cpu", cfg=os.environ["CXN_TEST_CFG"])
t.init_model()
if os.environ["CXN_WORKER_RANK"] == "1":
    os._exit(7)
x = np.zeros((4, 1, 1, 8), np.float32)
t.update(DataBatch(data=x, label=np.zeros((4, 1), np.float32)))
"""


def test_launch_dist_ends_a_job_whose_rank_died(tmp_path):
    """Rank 1 dies before the first step; rank 0 would wait in the
    all-reduce. launch_dist tears it down and exits with the failure."""
    script = tmp_path / "die.py"
    script.write_text(DIE)
    env = worker_env(0, 1, 0, {"CXN_TEST_CFG": SMALL_MLP.format(fg=0)
                               + "param_server = dist\nsilent = 1\n"})
    for k in ("CXN_COORDINATOR", "CXN_NUM_WORKER", "CXN_WORKER_RANK"):
        env.pop(k)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.launch_dist", "-n",
         "2", "--coordinator", f"127.0.0.1:{free_port()}", "--",
         sys.executable, str(script)], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 7, out.stderr
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("key,val,match", [
    ("mesh", "data:2,seq:2", "seq"), ("mesh", "model:2,pipe:2", "pipe"),
    ("mesh", "data:2,model:2,expert:2", "expert"), ("mesh", "seq:2", "seq"),
    ("mesh", "pipe:2", "pipe"), ("mesh", "expert:2", "expert")])
def test_unported_parallelism_raises(key, val, match):
    """The seq, pipe and expert axes are ported (the case ids are those
    of the refusals they replaced): set_param takes the mesh, and in one
    process it raises at the net's build naming param_server = dist, as
    a data or model axis larger than the job does
    (tests/test_torch_seq_parallel.py, test_torch_pipe_parallel.py and
    test_torch_expert_parallel.py run them as ranks)."""
    tr = NetTrainer(device="cpu", cfg=SMALL_MLP.format(fg=0))
    tr.set_param(key, val)
    assert dict(tr.mesh_spec.axes)[match] == 2
    with pytest.raises(ValueError, match="param_server = dist"):
        tr.init_model()


def test_alias_after_explicit_zero_stage_is_ignored(capsys):
    """The JAX alias rule: update_on_server after an explicit zero_stage
    that it contradicts warns and keeps the explicit stage."""
    tr = NetTrainer(device="cpu")
    tr.set_param("zero_stage", "0")
    tr.set_param("update_on_server", "1")
    assert tr.zero_stage == 0
    assert "keeping zero_stage=0" in capsys.readouterr().err
    tr = NetTrainer(device="cpu")
    tr.set_param("update_on_server", "1")
    tr.set_param("update_on_server", "0")
    assert tr.zero_stage == 1


PRED_BLOCK = """
pred = {out}
iter = mnist
  path_img = "{d}/t10k-images-idx3-ubyte.gz"
  path_label = "{d}/t10k-labels-idx1-ubyte.gz"
  input_flat = 1
iter = end
input_shape = 1,1,784
"""


@pytest.mark.parametrize("overrides,match", [
    # the cases that were refused while serving on a mesh and elastic
    # training were not ported (their ids kept), each now doing what the
    # JAX CLI does: param_server = dist outside a job serves in one
    # process; a device list serves in one process, its data axis
    # shaping the buckets; elastic = 1 without a supervisor makes a
    # one-member pod that barriers and publishes every round; the
    # supervisor's elastic_nproc reaches a worker without effect
    pytest.param(["task=serve", "param_server=dist"], "[1, 2, 4, 8]",
                 id="overrides0-task = serve"),
    pytest.param(["task=serve", "dev=cpu:0,1"], "[2, 4, 8]",
                 id="overrides1-multi-device"),
    pytest.param(["task=train", "elastic=1"], "elastic",
                 id="overrides2-elastic"),
    pytest.param(["task=train", "elastic_nproc=4"], "elastic_nproc",
                 id="overrides3-elastic_nproc")])
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, overrides, match):
    d = str(tmp_path)
    conf = tmp_path / "net.conf"
    conf.write_text(MLP + PRED_BLOCK.format(out=f"{d}/p.txt", d=d))
    mdir = f"{d}/m"
    if overrides[0] == "task=train":
        # no data block: the CLI saves (and in a pod, publishes) round 0
        assert port_main.main([str(conf), "dev=cpu", f"model_dir={mdir}",
                               "silent=1"] + overrides) == 0
        assert os.path.exists(f"{mdir}/0000.model")
        man = os.path.join(mdir, "coord", "published.json")
        if match == "elastic":
            import json
            rec = json.load(open(man))
            assert rec["round"] == 0 and rec["writer"] == 0
            assert rec["epoch"] == 1 and rec["generation"] == 0
        else:
            assert not os.path.exists(man)
        return
    write_idx(d, "t10k", 40, 8)
    tr = NetTrainer(device="cpu", cfg=MLP + "\nsilent = 1\n")
    tr.init_model()
    with open(f"{d}/init.model", "wb") as f:
        tr.save_model(f)
    outs = {}
    for task, extra in (("pred", []), ("serve", overrides[1:])):
        out = f"{d}/{task}.txt"
        capsys.readouterr()
        assert port_main.main([str(conf), "dev=cpu", f"task={task}",
                               f"model_in={d}/init.model", f"pred={out}",
                               "serve_rows=0", "silent=1"] + extra) == 0
        if task == "serve":
            assert f"buckets {match}" in capsys.readouterr().out
        outs[task] = open(out).read().splitlines()
    assert len(outs["pred"]) == 40 and outs["serve"] == outs["pred"]


def test_init_deadline_raises_config_error():
    """A coordinator nobody serves: the bounded retry gives up within its
    deadline with the JAX package's ConfigError text (the port's retry
    took no deadline before this slice)."""
    from cxxnet_tpu_torch.parallel import distributed
    from cxxnet_tpu_torch.utils.config import ConfigError
    t0 = time.monotonic()
    with pytest.raises(ConfigError, match="could not join the job at "
                       r"127\.0\.0\.1:\d+ as rank 1/2 after 2 attempts"):
        distributed.init_distributed(f"127.0.0.1:{free_port()}", 2, 1,
                                     attempts=2, backoff=0.1, deadline=2.0)
    assert time.monotonic() - t0 < 30
    assert not distributed.is_initialized()


def test_cli_alone_with_a_device_list_starts_its_workers(tmp_path):
    """The reference's `dev = gpu:0-3` form: the CLI started alone with
    a device list (here `cpu:0,1`) starts one worker per listed device
    through launch_dist, with param_server = dist; both ranks print the
    same round lines and test_on_server holds."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "data"))
    write_idx(os.path.join(d, "data"), "train", 80, 7)
    write_idx(os.path.join(d, "data"), "t10k", 40, 8)
    conf = dist_conf(d)
    text = open(conf).read().replace("param_server = dist\n", "").replace(
        "mesh = data:2\n", "")
    with open(conf, "w") as f:
        f.write(text)
    env = worker_env(0, 1, 0)
    for k in ("CXN_COORDINATOR", "CXN_NUM_WORKER", "CXN_WORKER_RANK"):
        env.pop(k)
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", conf, "dev=cpu:0,1",
         f"model_dir={d}/m", "silent=1"], env=env, cwd=d,
        capture_output=True, text=True, timeout=CLI_TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "starting 2 workers (param_server = dist)" in out.stdout
    assert out.stderr.count("param_server=dist: rank ") == 2
    rounds = ROUND.findall(out.stderr)
    assert len(rounds) == 4 and len(set(rounds)) == 2, rounds


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_mnist_shard_equals_jax(tmp_path, rank):
    """dist_num_worker / dist_worker_rank through the mnist iterator under
    a threadbuffer: each worker's batches equal the JAX iterator's."""
    from cxxnet_tpu.io import create_iterator as jax_create
    from cxxnet_tpu_torch.io import create_iterator as port_create
    d = str(tmp_path)
    write_idx(d, "train", 50, 9)
    cfg = [("iter", "mnist"),
           ("path_img", f"{d}/train-images-idx3-ubyte.gz"),
           ("path_label", f"{d}/train-labels-idx1-ubyte.gz"),
           ("shuffle", "1"), ("silent", "1"), ("batch_size", "4"),
           ("dist_num_worker", "3"), ("dist_worker_rank", str(rank)),
           ("iter", "threadbuffer"), ("iter", "end")]
    got = []
    for create in (port_create, jax_create):
        it = create(cfg)
        it.init()
        it.before_first()
        rows = []
        while it.next():
            b = it.value()
            rows.append((np.array(b.data), np.array(b.label)))
        got.append(rows)
    # 16 instances a worker (quota of 50 over 3): 4 batches of 4
    assert len(got[0]) == len(got[1]) == 4
    for (a, la), (b, lb) in zip(*got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_each_rank_takes_its_card_or_raises(monkeypatch):
    """Without an index a rank runs on cuda:<local rank>; with fewer
    cards than that it raises naming dev = gpu:0, which (like a device
    list) names the card instead."""
    import torch
    from cxxnet_tpu_torch.utils.device import device_from_spec
    monkeypatch.setenv("CXN_LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_from_spec("gpu") == "cuda:1"
    assert device_from_spec("gpu:0-1") == "cuda:1"
    assert device_from_spec("tpu:3,5") == "cuda:5"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"dev = gpu:0"):
        device_from_spec("gpu")
    assert device_from_spec("gpu:0") == "cuda:0"
    assert device_from_spec("cpu") == "cpu"
    # a conf's own `dev = tpu` is checked, not placed: the command line's
    # dev = gpu:0 still puts this rank on card 0
    from cxxnet_tpu_torch.main import LearnTask
    conf = os.path.join(REPO, "examples", "ImageNet", "AlexNet.conf")
    task = LearnTask()
    task.load_conf(conf, ["dev=gpu:0"])
    assert device_from_spec(task.device) == "cuda:0"
    with pytest.raises(ValueError, match="unknown dev"):
        LearnTask().load_conf(conf, ["dev=npu"])
