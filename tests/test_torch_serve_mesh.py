"""Serving on a one-process mesh, held to the JAX package on the CPU.

- bucket_sizes / ladder_buckets / ladder_from_histogram with a data
  axis against the JAX functions over one table, the multiple-of-axis
  refusal of serve_max_batch included;
- the port's Server against the JAX Server (8 virtual CPU devices) on
  the narrow AlexNet-shaped net at `mesh = data:2`, `mesh = model:2`,
  `zero_stage = 3` and `mesh = data:2` with `zero_stage = 3`: the same
  bucket set, and the rows of a ragged request stream within the serving
  tests' bar (rtol 1e-4 / atol 1e-5 against JAX). In the port the one
  process holds the params whole; the data axis shapes the buckets and
  their rows;
- the Server refuses a multi-process job with the JAX text;
- the CLI's task = serve for each case the JAX CLI serves - `mesh =
  data:2`, `mesh = model:2`, `zero_stage = 3`, `param_server = dist`, a
  device list - against the JAX CLI run on the same conf and checkpoint:
  the same buckets, the same output file; `serve_max_batch` that the
  axis does not divide and a device list past the machine's devices
  raise as the JAX CLI raises.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.serve import server as jax_server
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.serve import (Server, bucket_sizes, ladder_buckets,
                                    ladder_from_histogram)
from test_torch_serve import CLI_CONF, write_mnist
from torch_port_util import NARROW_ALEXNET, carry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("err", str(e))


@pytest.mark.parametrize("max_batch,axis", [
    (8, 1), (8, 2), (24, 2), (24, 3), (24, 4), (6, 2), (5, 2), (64, 8),
    (1, 1), (0, 2), (12, 5)])
def test_bucket_sizes_with_a_data_axis_equal_jax(max_batch, axis):
    assert (_outcome(bucket_sizes, max_batch, axis)
            == _outcome(jax_server.bucket_sizes, max_batch, axis))


@pytest.mark.parametrize("ladder,max_batch,axis", [
    ([3, 6, 10], 24, 2), ([1, 2, 3, 4], 8, 2), ([5, 50], 16, 4),
    ([], 6, 3), ([2], 5, 2)])
def test_ladder_buckets_with_a_data_axis_equal_jax(ladder, max_batch, axis):
    assert (_outcome(ladder_buckets, ladder, max_batch, axis)
            == _outcome(jax_server.ladder_buckets, ladder, max_batch, axis))


@pytest.mark.parametrize("hist,max_batch,axis,rungs", [
    ({1: 5, 3: 2, 7: 1}, 8, 2, 4), ({5: 10}, 24, 4, 2), ({}, 12, 3, 4),
    ({1: 1, 2: 1, 9: 3}, 16, 1, 3), ({3: 4}, 9, 2, 4)])
def test_ladder_from_histogram_with_a_data_axis_equals_jax(hist, max_batch,
                                                           axis, rungs):
    assert (_outcome(ladder_from_histogram, hist, max_batch, axis, rungs)
            == _outcome(jax_server.ladder_from_histogram, hist, max_batch,
                        axis, rungs))


def _requests(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, 3, 35, 35) * 3.0).astype(np.float32)
            for n in (1, 3, 2, 5, 8, 4)]


@pytest.mark.parametrize("extra", [
    "mesh = data:2\n", "mesh = model:2\n", "zero_stage = 3\n",
    "mesh = data:2\nzero_stage = 3\n"])
def test_server_on_a_mesh_matches_the_jax_server(extra):
    jt = JaxTrainer(cfg=NARROW_ALEXNET + extra)
    jt.init_model()
    pt = NetTrainer(cfg=NARROW_ALEXNET + extra, device="cpu",
                    one_process=True)
    pt.init_model()
    carry(jt, pt)
    reqs = _requests(1)
    with jax_server.Server(jt) as js:
        want = [js.submit(r).result(timeout=120) for r in reqs]
        jbuckets = js.buckets
    with Server(pt, device="cpu") as ps:
        got = [ps.submit(r).result(timeout=120) for r in reqs]
        pbuckets = ps.buckets
    assert pbuckets == jbuckets
    assert pt.serve_data_axis == jt.mesh.shape.get("data", 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **JAX_TOL)
    # the port's one process holds every param whole
    shapes = pt.net.param_shapes()
    for lk, d in pt.state["params"].items():
        for pn, t in d.items():
            assert tuple(t.shape) == tuple(shapes[lk][pn])


def test_server_refuses_a_multi_process_job(monkeypatch):
    pt = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    pt.init_model()
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(RuntimeError,
                       match="serving a multi-controller job is not "
                             "supported; run the server on a "
                             "single-process mesh"):
        Server(pt, device="cpu")


def test_a_training_trainer_still_needs_its_processes():
    """Only an inference trainer of one process (one_process) takes a
    mesh alone; a training trainer refuses as before."""
    tr = NetTrainer(cfg=NARROW_ALEXNET + "mesh = data:2\n", device="cpu")
    with pytest.raises(ValueError, match="param_server = dist"):
        tr.init_model()


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------
CASES = [["mesh=data:2"], ["mesh=model:2"], ["zero_stage=3"],
         ["param_server=dist"], ["dev=cpu:0,1"],
         ["mesh=data:2", "serve_max_batch=6"], ["mesh=data:2", "elastic=1"]]
REFUSED = [(["mesh=data:2", "serve_max_batch=5"],
            "serve_max_batch=5 must be a multiple of the mesh's data-axis "
            "size \\(2\\)")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_mesh"))
    write_mnist(d, 100, 1)
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d)
                .replace("batch_size = 25", "batch_size = 24"))
    jt = JaxTrainer(cfg=open(conf).read())
    jt.init_model()
    model = os.path.join(d, "0001.model")
    with open(model, "wb") as fo:
        jt.save_model(fo)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CXN_NUM_WORKER", "CXN_WORKER_RANK",
                        "CXN_COORDINATOR")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jobs = [(pkg, i, case)
            for i, case in enumerate([[]] + CASES + [c for c, _ in REFUSED])
            for pkg in ("cxxnet_tpu", "cxxnet_tpu_torch")]
    runs = {}
    while jobs:
        # six CLI processes at a time
        procs = {}
        for pkg, i, case in jobs[:6]:
            out = os.path.join(d, f"{pkg}_{i}.txt")
            procs[(pkg, i)] = (out, subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.main", conf, "task=serve",
                 f"model_in={model}", f"pred={out}", "serve_rows=0",
                 "silent=0"] + case, env=env, cwd=d,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        jobs = jobs[6:]
        try:
            for key, (out, p) in procs.items():
                so, se = p.communicate(timeout=300)
                text = open(out).read() if os.path.exists(out) else None
                runs[key] = (p.returncode, so, se, text)
        finally:
            for _, p in procs.values():
                if p.poll() is None:
                    p.kill()
    return runs


BUCKETS = re.compile(r"serve: warming \d+ bucket(?: executable)?s (\[.*\])")


def _buckets(stdout):
    m = BUCKETS.search(stdout)
    return m.group(1) if m else None


@pytest.mark.parametrize("i", range(1, len(CASES) + 1),
                         ids=["+".join(c) for c in CASES])
def test_cli_serves_on_a_mesh_as_the_jax_cli(cli_runs, i):
    jrc, jout, jerr, jtext = cli_runs[("cxxnet_tpu", i)]
    prc, pout, perr, ptext = cli_runs[("cxxnet_tpu_torch", i)]
    assert jrc == 0, jerr[-2000:]
    assert prc == 0, perr[-2000:]
    assert _buckets(pout) == _buckets(jout) is not None
    assert ptext == jtext and len(ptext.splitlines()) == 96
    # a mesh changes the buckets, never the answers
    assert ptext == cli_runs[("cxxnet_tpu_torch", 0)][3]


@pytest.mark.parametrize("k", range(len(REFUSED)),
                         ids=["+".join(c) for c, _ in REFUSED])
def test_cli_refuses_what_the_jax_cli_refuses(cli_runs, k):
    i = 1 + len(CASES) + k
    match = REFUSED[k][1]
    for pkg in ("cxxnet_tpu", "cxxnet_tpu_torch"):
        rc, _out, err, text = cli_runs[(pkg, i)]
        assert rc != 0 and text is None
        assert re.search(match, err), (pkg, err[-2000:])


def test_cli_device_list_past_the_machine_raises(tmp_path):
    """`dev = tpu:0-63` names cards this machine lacks: the JAX CLI
    raises at its mesh, the port's before it builds anything (here no
    card at all)."""
    from cxxnet_tpu_torch import main as port_main
    d = str(tmp_path)
    write_mnist(d, 25, 1)
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "p.txt"), d=d))
    with pytest.raises(ValueError, match="device spec requests index 63 "
                                         "but only 0 devices are available"):
        port_main.main([conf, "task=serve", "model_in=none.model",
                        "dev=tpu:0-63"])
