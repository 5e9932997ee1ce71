"""Fused dispatch (steps_per_dispatch = K) of the port against the JAX
package's update_chunk, and against the port's own streamed updates -
the counterparts of tests/test_fused_dispatch.py.

The port runs a chunk's K microsteps eagerly, one after the other, with
the streamed step's code; so its K = 4 equals its K = 1 BITWISE on the
CPU (same ops, same order), with check_nan, update_period crossing
chunks and short final chunks. Against the JAX package the bar is the
whole-step bar of tests/test_torch_train.py, STEP_TOL = rtol 1e-4 /
atol 1e-5 (float32; XLA:CPU and torch sum in other orders), on the
narrow MLP with the JAX package's initial params carried across; the
train-metric strings at rtol 1e-5 / atol 1e-6 (error counts exact).
Random layers (narrow AlexNet's dropout) draw from the port's own
generators, so those runs are held to the port's K = 1 only."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.profiler import StepProfiler as JaxProfiler
from cxxnet_tpu_torch import convert, telemetry
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.prefetch import StagedPrefetcher
from cxxnet_tpu_torch.nnet.trainer import NetTrainer, StagedChunk
from cxxnet_tpu_torch.utils.fault import DivergenceError
from cxxnet_tpu_torch.utils.profiler import StepProfiler
from torch_port_util import NARROW_ALEXNET

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MLP_CFG = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.1
layer[+1:ac1] = tanh
layer[ac1->fc2] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 16
eta = 0.5
momentum = 0.9
wd = 0.0
metric = error
eval_train = 1
silent = 1
"""


def make_port(extra=""):
    t = NetTrainer(cfg=MLP_CFG + extra, device="cpu")
    t.init_model()
    return t


def make_pair(extra=""):
    """The JAX trainer and a port trainer holding its params and
    updater state."""
    jt = JaxTrainer(cfg=MLP_CFG + extra)
    jt.init_model()
    pt = make_port(extra)
    convert.train_state_from_numpy(pt, {
        "params": jax.device_get(jt.state["params"]),
        "ustate": jax.device_get(jt.state["ustate"]),
        "epoch": jt.epoch})
    return jt, pt


def synth(n_batches=8, seed=0):
    """(port batches, JAX batches) of the same numpy rows."""
    rng = np.random.RandomState(seed)
    w = rng.randn(8)
    port, jx = [], []
    for _ in range(n_batches):
        x = rng.randn(16, 8).astype(np.float32)
        y = (x @ w > 0).astype(np.float32).reshape(16, 1)
        port.append(DataBatch(data=x.reshape(16, 1, 1, 8), label=y))
        jx.append(JaxBatch(data=x.reshape(16, 1, 1, 8), label=y))
    return port, jx


def nan_like(b, cls):
    return cls(data=np.full((16, 1, 1, 8), np.nan, np.float32),
               label=b.label)


class ListIter:
    def __init__(self, batches):
        self.batches = batches
        self.i = -1

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < len(self.batches)

    def value(self):
        return self.batches[self.i]


def port_leaves(t):
    p = t.state["params"]
    return [p[k][n].detach().cpu().numpy() for k in sorted(p)
            for n in sorted(p[k])]


def jax_leaves(t):
    p = jax.device_get(t.state["params"])
    return [np.asarray(p[k][n]) for k in sorted(p) for n in sorted(p[k])]


def assert_close_to_jax(jt, pt):
    for a, b in zip(port_leaves(pt), jax_leaves(jt)):
        np.testing.assert_allclose(a, b, **STEP_TOL)


def assert_bitwise(ta, tb):
    for a, b in zip(port_leaves(ta), port_leaves(tb)):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint32), b.view(np.uint32))


def metric_values(line):
    out = {}
    for part in line.strip("\t").split("\t"):
        k, v = part.split(":")
        out[k] = float(v)
    return out


def assert_metrics_match(got, want):
    g, w = metric_values(got), metric_values(want)
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], **METRIC_TOL)


def run_fused(t, batches, k):
    for i in range(0, len(batches), k):
        t.update_chunk(batches[i:i + k])
    return t


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fused_trajectory_matches_jax(k):
    pb, jb = synth(8)
    jt, pt = make_pair(f"steps_per_dispatch = {k}\n")
    run_fused(jt, jb, k)
    run_fused(pt, pb, k)
    assert_close_to_jax(jt, pt)
    assert pt.epoch == jt.epoch == 8
    assert pt._step_counter == jt._step_counter == 8
    assert_metrics_match(pt.eval_train_metric(), jt.eval_train_metric())


# the bitwise matrix of tests/test_fused_dispatch.py's subprocess, on
# the port: K in {1, 2, 3, 4} against streamed update() calls, plain,
# update_period = 2, the guard with a NaN microstep, and both
BITWISE = [("", k) for k in (1, 2, 3, 4)] + [
    ("update_period = 2\n", k) for k in (2, 4)] + [
    ("check_nan = 1\n", k) for k in (1, 4)] + [
    ("check_nan = 1\nupdate_period = 2\n", k) for k in (3, 4)]


@pytest.mark.parametrize("extra,k", BITWISE)
def test_fused_equals_streamed_bitwise(extra, k):
    pb, _ = synth(7)
    if "check_nan" in extra:
        pb = pb[:5] + [nan_like(pb[5], DataBatch)] + pb[6:]
    ta = make_port(extra)
    for b in pb:
        ta.update(b)
    tb = run_fused(make_port(extra + f"steps_per_dispatch = {k}\n"), pb, k)
    assert_bitwise(ta, tb)
    assert (ta.epoch, ta._count, ta.bad_rounds) == (
        tb.epoch, tb._count, tb.bad_rounds)
    assert ta.eval_train_metric() == tb.eval_train_metric()


@pytest.mark.parametrize("k", [2, 4])
def test_fused_update_period_crosses_chunks(k):
    pb, jb = synth(8)
    jt, pt = make_pair("update_period = 2\n")
    run_fused(jt, jb, k)
    run_fused(pt, pb, k)
    assert_close_to_jax(jt, pt)
    assert pt.epoch == jt.epoch == 4
    assert_metrics_match(pt.eval_train_metric(), jt.eval_train_metric())


def test_fused_short_final_chunk():
    pb, jb = synth(7)
    jt, pt = make_pair()
    run_fused(jt, jb, 4)
    run_fused(pt, pb, 4)
    assert_close_to_jax(jt, pt)
    assert pt._step_counter == 7
    assert_metrics_match(pt.eval_train_metric(), jt.eval_train_metric())


def test_fused_nan_guard_drops_exact_microstep(capfd):
    pb, jb = synth(8)
    pb = pb[:5] + [nan_like(pb[5], DataBatch)] + pb[6:]
    jb = jb[:5] + [nan_like(jb[5], JaxBatch)] + jb[6:]
    ta = make_port("check_nan = 1\n")
    for b in pb:
        ta.update(b)
    err_streamed = capfd.readouterr().err
    jt, pt = make_pair("check_nan = 1\n")
    run_fused(jt, jb, 4)
    capfd.readouterr()
    run_fused(pt, pb, 4)
    err_fused = capfd.readouterr().err
    assert_close_to_jax(jt, pt)
    assert pt.bad_rounds == jt.bad_rounds == 1
    assert pt._skipped_steps == jt._skipped_steps == 1
    assert pt.epoch == jt.epoch == 7
    assert "at update 5" in err_streamed
    assert err_fused == err_streamed
    # one finite-vector readback per chunk
    assert pt.guard_readbacks == 2 and ta.guard_readbacks == 8
    assert_metrics_match(pt.eval_train_metric(), jt.eval_train_metric())


def test_fused_divergence_abort_raises():
    """max_bad_rounds consecutive NaN microsteps across two chunks
    raise at the second chunk's end, after its three good microsteps
    ran: the port's update counter then reads what its params hold
    (2 + 3 updates), as the JAX package's device-side counter does."""
    pb, jb = synth(8)
    bad = nan_like(pb[0], DataBatch)
    seq = pb[:2] + [bad, bad, bad] + pb[5:]
    t = make_port("check_nan = 1\nsteps_per_dispatch = 4\n")
    with pytest.raises(DivergenceError, match="3 consecutive"):
        run_fused(t, seq, 4)
    jt, pt = make_pair("check_nan = 1\nsteps_per_dispatch = 4\n")
    jbad = nan_like(jb[0], JaxBatch)
    with pytest.raises(Exception, match="3 consecutive"):
        run_fused(jt, jb[:2] + [jbad, jbad, jbad] + jb[5:], 4)
    with pytest.raises(DivergenceError, match="3 consecutive"):
        run_fused(pt, seq, 4)
    assert t.bad_rounds == pt.bad_rounds == jt.bad_rounds == 3
    assert t.epoch == pt.epoch == int(jt.state["epoch"]) == 5
    assert_close_to_jax(jt, pt)
    assert all(np.isfinite(a).all() for a in port_leaves(t))


def test_fused_accepts_staged_batches_and_chunks():
    pb, jb = synth(4)
    jt, pt = make_pair()
    for b in jb:
        jt.update(b)
    staged = [pt.stage_batch(b) for b in pb[:2]] + pb[2:]
    chunk = pt.stage_chunk(staged)
    assert isinstance(chunk, StagedChunk)
    assert chunk.n_steps == 4
    assert chunk.n_examples == (16, 16, 16, 16)
    assert tuple(chunk.data.shape) == (4, 16, 1, 1, 8)
    pt.update(chunk)
    assert_close_to_jax(jt, pt)
    with pytest.raises(ValueError, match="chunk takes none"):
        pt.update(chunk, keep={})


def test_fused_empty_chunk_rejected():
    t = make_port()
    with pytest.raises(ValueError, match="at least one batch"):
        t.stage_chunk([])
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
        t.set_param("steps_per_dispatch", "0")
    # a rejected batch raises before the step counter moves
    with pytest.raises(ValueError):
        t.update_chunk([DataBatch(data=np.zeros((17, 1, 1, 8), np.float32),
                                  label=np.zeros((17, 1), np.float32))])
    assert t._step_counter == 0


def test_prefetcher_assembles_chunks_with_partial_tail():
    pb, jb = synth(7)
    jt, pt = make_pair("steps_per_dispatch = 3\n")
    jpf = jt.prefetch(ListIter(jb), depth=2, chunk=3)
    jpf.before_first()
    while jpf.next():
        jt.update(jpf.value())
    jpf.close()
    pf = pt.prefetch(ListIter(pb), depth=2, chunk=3)
    sizes = []
    pf.before_first()
    while pf.next():
        sizes.append(pf.value().n_steps)
        pt.update(pf.value())
    pf.close()
    assert sizes == [3, 3, 1]
    assert_close_to_jax(jt, pt)
    assert_metrics_match(pt.eval_train_metric(), jt.eval_train_metric())
    # and bitwise the port's streamed run
    ta = make_port()
    for b in pb:
        ta.update(b)
    tb = make_port()
    pf = tb.prefetch(ListIter(pb), depth=1, chunk=3)
    pf.before_first()
    while pf.next():
        tb.update(pf.value())
    pf.close()
    assert_bitwise(ta, tb)


def test_prefetcher_chunk_requires_chunk_fn():
    with pytest.raises(ValueError, match="chunk > 1 requires chunk_fn"):
        StagedPrefetcher(lambda b, ring: b, ListIter([]), chunk=2)


def test_prefetcher_chunk_restart_and_close():
    pb, _ = synth(6)
    t = make_port()
    pf = t.prefetch(ListIter(pb), depth=1, chunk=2)
    pf.before_first()
    assert pf.next() and pf.value().n_steps == 2
    pf.before_first()  # restart mid-pass
    n = 0
    while pf.next():
        n += pf.value().n_steps
    assert n == 6
    pf.close()
    assert not pf.next()


@pytest.mark.parametrize("extra", ["", "check_nan = 1\nupdate_period = 2\n"])
def test_narrow_alexnet_fused_equals_streamed(extra):
    """Dropout, grouped convolutions, LRN and the ties max-pool: K = 4
    over 6 batches (a chunk and a short one) equals 6 update() calls
    bitwise - the random draws follow the step counter."""
    rng = np.random.RandomState(0)
    batches = [DataBatch(
        data=(rng.randn(8, 3, 35, 35) * 3.0).astype(np.float32),
        label=rng.randint(0, 10, (8, 1)).astype(np.float32))
        for _ in range(6)]
    conf = NARROW_ALEXNET + "eta = 0.01\nmomentum = 0.9\nmetric = error\n"
    ta = NetTrainer(cfg=conf + extra, device="cpu")
    ta.init_model()
    tb = NetTrainer(cfg=conf + extra, device="cpu")
    tb.init_model()
    for b in batches:
        ta.update(b)
    run_fused(tb, batches, 4)
    assert_bitwise(ta, tb)
    assert ta.eval_train_metric() == tb.eval_train_metric()


GUARD_CASES = {
    "sgd_expdecay": "lr:schedule = expdecay\nlr:gamma = 0.5\nlr:step = 2\n",
    "nag_factor": "updater = nag\nlr:schedule = factor\nlr:step = 3\n"
                  "lr:factor = 0.5\n",
    "adam": "updater = adam\neta = 0.01\n",
    "sgd_momentum_schedule": "momentum_schedule = 1\nbase_momentum = 0.5\n"
                             "final_momentum = 0.95\nsaturation_epoch = 5\n",
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guarded_microsteps_equal_the_host_path_bitwise(case):
    """With nothing to drop, the guarded path (counters on the device,
    schedule values from the host's table, the update committed by a
    select) gives the host path's bits: every schedule, every updater,
    update_period 2 crossing chunks."""
    extra = GUARD_CASES[case] + "update_period = 2\n"
    pb, _ = synth(8)
    ta = make_port(extra)
    for b in pb:
        ta.update(b)
    tb = run_fused(make_port(extra + "check_nan = 1\n"), pb, 3)
    assert_bitwise(ta, tb)
    assert ta.epoch == tb.epoch == 4


def test_cli_fused_vs_streamed_checkpoint_identical(tmp_path):
    """The port's CLI at K = 4 (prefetched chunks) and K = 4 with
    prefetch_stage = 0 (pending chunks) writes the K = 1 run's final
    checkpoint byte for byte, with the same eval lines."""
    from cxxnet_tpu_torch.tools import fused_smoke
    d = str(tmp_path)
    fused_smoke.write_synth_mnist(d, 288, 0, "train")
    fused_smoke.write_synth_mnist(d, 64, 1, "test")
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(fused_smoke.CONF.format(d=d) + "dev = cpu\nsilent = 1\n")

    def run(tag, *args):
        mdir = os.path.join(d, f"m_{tag}")
        r = subprocess.run(
            [sys.executable, "-m", "cxxnet_tpu_torch.main", conf,
             f"model_dir={mdir}", *args],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        with open(os.path.join(mdir, "0003.model"), "rb") as f:
            blob = f.read()
        return blob, [ln for ln in r.stderr.splitlines()
                      if ln.startswith("[")]

    b1, e1 = run("k1", "steps_per_dispatch=1")
    b4, e4 = run("k4", "steps_per_dispatch=4")
    b4s, e4s = run("k4s", "steps_per_dispatch=4", "prefetch_stage=0")
    assert b1 == b4 == b4s
    assert e1 == e4 == e4s and len(e1) == 3


def test_fused_smoke_tool_passes(tmp_path):
    from cxxnet_tpu_torch.tools import fused_smoke
    res = fused_smoke.run_smoke(str(tmp_path), dev="cpu")
    assert res["ok"], res["checks"]
    assert res["chunks"] == [4, 4, 1] * 3


def test_wrapper_honors_steps_per_dispatch():
    from cxxnet_tpu_torch import wrapper
    cfg = MLP_CFG.replace("batch_size = 16\n", "")
    rng = np.random.RandomState(0)
    w = rng.randn(8)
    x = rng.randn(96, 8).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)

    def preds(net):
        return np.concatenate(
            [net.predict(x[i:i + 16].reshape(-1, 1, 1, 8))
             for i in range(0, 96, 16)])

    def params(net):
        return port_leaves(net._net)

    n1 = wrapper.train(cfg, x.reshape(-1, 1, 1, 8), y, 3, {},
                       batch_size=16, dev="cpu")
    n2 = wrapper.train(cfg, x.reshape(-1, 1, 1, 8), y, 3,
                       {"steps_per_dispatch": "4"}, batch_size=16,
                       dev="cpu")
    old = wrapper._STAGE_BYTES_LIMIT
    wrapper._STAGE_BYTES_LIMIT = 0  # the prefetched path
    try:
        n3 = wrapper.train(cfg, x.reshape(-1, 1, 1, 8), y, 3,
                           {"steps_per_dispatch": "4"}, batch_size=16,
                           dev="cpu")
    finally:
        wrapper._STAGE_BYTES_LIMIT = old
    assert np.array_equal(preds(n1), preds(n2))
    assert np.array_equal(preds(n1), preds(n3))
    for a, b, c in zip(params(n1), params(n2), params(n3)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("timings", [
    [("chunk", 0.4, 4, 64), ("chunk", 0.1, 1, 16)],
    [("step", 0.02, 16), ("data", 0.005), ("step", 0.03, 12),
     ("chunk", 0.2, 3, 48), ("data", 0.001)],
    [],
])
def test_profiler_stats_and_summary_match_jax(timings, tmp_path):
    """The port's StepProfiler gives the JAX package's stats keys and
    values and its summary text on the same timings."""
    got = StepProfiler(str(tmp_path / "p"))
    want = JaxProfiler(str(tmp_path / "p"))
    for p in (got, want):
        p.reset()
        for t in timings:
            if t[0] == "chunk":
                p.add_chunk(*t[1:])
            elif t[0] == "step":
                p.add_step(*t[1:])
            else:
                p.add_data(*t[1:])
    assert got.summary() == want.summary()
    gs, ws = got.stats(), want.stats()
    if ws is None:
        assert gs is None
        return
    assert list(gs) == list(ws)
    for k in ws:
        assert gs[k] == pytest.approx(ws[k], rel=1e-12)


def test_fused_telemetry_chunk_span(tmp_path):
    log = str(tmp_path / "ev.jsonl")
    tel = telemetry.get()
    tel.configure(log_file=log)
    try:
        img0 = tel.registry.counter("train.images").value
        cnt0 = tel.registry.histogram("train.step_s").count
        pb, _ = synth(4)
        t = make_port("steps_per_dispatch = 4\n")
        t.update_chunk(pb)
        assert tel.registry.counter("train.images").value - img0 == 64
        assert tel.registry.histogram("train.step_s").count - cnt0 == 4
        assert t.round_stats()["steps"] == 4
    finally:
        tel.close()
    events = list(telemetry.read_jsonl(log))
    chunks = [e for e in events if e.get("name") == "train.chunk"]
    assert len(chunks) == 1
    assert chunks[0]["steps"] == 4
    assert len(chunks[0]["loss"]) == 4
    assert chunks[0]["examples"] == 64
    assert any(e.get("name") == "train.data" for e in events)
    assert any(r["name"] == "train_chunk@K4b16"
               for r in telemetry.get().executables.snapshot())


INSANITY_NET = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 32
  init_sigma = 0.1
layer[+1] = insanity
  lb = 3
  ub = 8
  calm_start = -1
  calm_end = 6
layer[+1:fc2] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 16
eta = 0.2
momentum = 0.9
metric = error
silent = 1
"""


def test_guarded_insanity_anneal_equals_the_host_path_bitwise():
    """insanity's annealed bounds from the device's update counter
    (guarded microsteps) are the host counter's float32 numbers: both
    paths train to the same bits over the whole anneal."""
    pb, _ = synth(8)
    runs = []
    for extra in ("", "check_nan = 1\n"):
        t = NetTrainer(cfg=INSANITY_NET + extra, device="cpu")
        t.init_model()
        runs.append(run_fused(t, pb, 3))
    assert_bitwise(*runs)
    assert runs[0].epoch == runs[1].epoch == 8
