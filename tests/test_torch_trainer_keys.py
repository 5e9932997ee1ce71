"""The trainer's other single-device keys against the JAX package:
`remat`, `profile` / `profile_dir` / `trace_round` with the CLI's
round records, `tuning_cache`, and the schema's entries for them.

Tolerances: whole steps at STEP_TOL (rtol 1e-4 / atol 1e-5, float32 -
tests/test_torch_train.py's bar); the port's remat = 1 against its own
remat = 0 bitwise (the recompute runs the same ops on the same inputs
on the CPU); the profiler's stats to 1e-12 relative (the same float64
arithmetic on the same timings)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.analysis import schema as jax_schema
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet import tuning as jax_tuning
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import ConfigError as JaxConfigError
from cxxnet_tpu_torch import convert, telemetry
from cxxnet_tpu_torch.analysis import schema as port_schema
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet import tuning
from cxxnet_tpu_torch.nnet.network import Network
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import ConfigError, parse_config_file
from cxxnet_tpu_torch.utils.profiler import StepProfiler
from torch_port_util import NARROW_ALEXNET

STEP_TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAIN_KEYS = """
eta = 0.01
momentum = 0.9
wd = 0.0005
bias:wd = 0
metric = error
"""


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


def batches(n, rows=8, seed=0):
    rng = np.random.RandomState(seed)
    return [((rng.randn(rows, 3, 35, 35) * 3.0).astype(np.float32),
             rng.randint(0, 10, size=(rows, 1)).astype(np.float32))
            for _ in range(n)]


def leaves(pt):
    p = pt.state["params"]
    return [p[k][n].detach().numpy() for k in sorted(p) for n in sorted(p[k])]


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", ["", "update_period = 2\n"])
def test_remat_matches_jax_remat(extra):
    """remat = 1 in both packages, narrow AlexNet (LRN, grouped
    convolutions, dropout with the JAX package's masks, the ties
    max-pool): three steps at STEP_TOL."""
    conf = NARROW_ALEXNET + TRAIN_KEYS + extra + "remat = 1\n"
    jt = JaxTrainer(cfg=conf)
    jt.init_model()
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    assert pt._remat_segments is not None and len(pt._remat_segments) > 1
    convert.train_state_from_numpy(pt, {
        "params": jax.device_get(jt.state["params"]),
        "ustate": jax.device_get(jt.state["ustate"]),
        "epoch": jt.epoch})
    for step, (data, label) in enumerate(batches(3)):
        jt.update(JaxBatch(data=data, label=label))
        pt.update(DataBatch(data=data, label=label),
                  keep=jax_keep(pt, jt.seed, step))
    jp = jax.device_get(jt.state["params"])
    pp = convert.params_to_numpy(pt.state["params"], pt.net.param_shapes())
    for lk in jp:
        for pn in jp[lk]:
            np.testing.assert_allclose(pp[lk][pn], jp[lk][pn], **STEP_TOL,
                                       err_msg=f"{lk}.{pn}")


@pytest.mark.parametrize("extra", ["", "check_nan = 1\nsteps_per_dispatch = 3\n"])
def test_remat_equals_no_remat_bitwise(extra):
    """The port's remat = 1 against its remat = 0: the same params bit
    for bit after 4 steps, its own dropout draws included (they are
    drawn again from the same (seed, step, layer) in the recompute),
    and the same train metric."""
    runs = []
    for remat in (0, 1):
        pt = NetTrainer(cfg=NARROW_ALEXNET + TRAIN_KEYS + extra
                        + f"remat = {remat}\n", device="cpu")
        pt.init_model()
        bs = [DataBatch(data=d, label=l) for d, l in batches(4)]
        if "steps_per_dispatch" in extra:
            pt.update_chunk(bs[:3])
            pt.update_chunk(bs[3:])
        else:
            for b in bs:
                pt.update(b)
        runs.append((leaves(pt), pt.eval_train_metric()))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("conf", ["examples/ImageNet/AlexNet.conf",
                                  "examples/ImageNet/GoogLeNet.conf",
                                  "examples/LongSeq/seq_mnist.conf",
                                  "examples/LongSeq/stack_moe.conf"])
def test_remat_segments_cover_the_net_and_cut_at_small_nodes(conf):
    """Segments are consecutive and cover every connection; AlexNet's
    first cut falls after lrn1, where its activations have shrunk."""
    tr = NetTrainer(device="cpu")
    for k, v in parse_config_file(os.path.join(REPO, conf)):
        tr.set_param(k, v)
    tr.net_cfg.configure(tr.cfg_pairs)
    net = Network(tr.net_cfg, tr.batch_size)
    segs = net.remat_segments()
    n = len(tr.net_cfg.layers)
    assert segs[0].start == 0 and segs[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(segs, segs[1:]))
    if "AlexNet" in conf:
        types = [tr.net_cfg.layers[s.stop - 1].type_name
                 for s in segs[:-1]]
        assert types[0] == "lrn" and len(segs) >= 3, (segs, types)


# ---------------------------------------------------------------------------
# profile / profile_dir / trace_round and the CLI's round records
# ---------------------------------------------------------------------------

def test_profiler_traces_exactly_the_trace_round(tmp_path):
    """trace_round = 3: profiled round 3 alone is traced (a Chrome
    trace holding the round's ops), as the JAX profiler traces one."""
    d = str(tmp_path / "prof")
    p = StepProfiler(d, trace_round=3)
    for r in range(5):
        p.round_start()
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
        p.add_step(0.01, 1)
        p.round_end()
    assert os.listdir(d) == ["trace_round3.json"]
    with open(os.path.join(d, "trace_round3.json")) as f:
        trace = json.load(f)
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])
    assert p._round_idx == 5 and p._traced_once
    assert p.summary().endswith(f", trace -> {d}")


CLI_CONF = """
data = train
iter = mnist
    path_img = "{d}/train-img.gz"
    path_label = "{d}/train-lbl.gz"
    shuffle = 1
iter = end
eval = test
iter = mnist
    path_img = "{d}/test-img.gz"
    path_label = "{d}/test-lbl.gz"
iter = end
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1:sg1] = tanh
layer[sg1->fc2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,36
batch_size = 32
num_round = 3
max_round = 3
eta = 0.3
metric = error
dev = cpu
"""


@pytest.fixture
def cli_data(tmp_path):
    from cxxnet_tpu_torch.tools.fused_smoke import write_synth_mnist
    d = str(tmp_path)
    write_synth_mnist(d, 160, 0, "train")
    write_synth_mnist(d, 64, 1, "test")
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(d=d))
    return d, conf


def run_cli(module, conf, *args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-m", module, conf, *args],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    return r


def test_cli_profile_summaries_trace_and_round_events(cli_data):
    """profile_dir + trace_round = 2 over 3 rounds: a summary line a
    round on stderr, exactly one trace (round 2), and a `round` event
    and metrics record a round whose fields are the JAX CLI's."""
    d, conf = cli_data
    port = run_cli("cxxnet_tpu_torch.main", conf,
                   f"model_dir={d}/mp", f"profile_dir={d}/prof",
                   "trace_round=2", f"log_file={d}/ev.jsonl",
                   f"metrics_file={d}/m.jsonl")
    lines = [ln for ln in port.stderr.splitlines() if "profile:" in ln]
    assert len(lines) == 3 and all("images/sec" in ln for ln in lines)
    assert all(ln.endswith(f"trace -> {d}/prof") for ln in lines)
    assert os.listdir(f"{d}/prof") == ["trace_round2.json"]
    jx = run_cli("cxxnet_tpu.main", conf, f"model_dir={d}/mj",
                 f"log_file={d}/jev.jsonl", f"metrics_file={d}/jm.jsonl")
    got = [e for e in telemetry.read_jsonl(f"{d}/ev.jsonl")
           if e.get("kind") == "round"]
    want = [e for e in telemetry.read_jsonl(f"{d}/jev.jsonl")
            if e.get("kind") == "round"]
    assert [e["round"] for e in got] == [e["round"] for e in want] == [
        1, 2, 3]
    drop = {"ts", "host", "pid", "proc", "device"}
    assert [sorted(set(e) - drop) for e in got] == [
        sorted(set(e) - drop) for e in want]
    assert [e["steps"] for e in got] == [e["steps"] for e in want]
    assert [e["examples"] for e in got] == [e["examples"] for e in want]
    mets = [e for e in telemetry.read_jsonl(f"{d}/m.jsonl")
            if e.get("kind") == "round"]
    assert [e["round"] for e in mets] == [1, 2, 3]
    assert "profile:" not in jx.stderr  # profile = 0: no summaries


# ---------------------------------------------------------------------------
# tuning_cache
# ---------------------------------------------------------------------------

TUNE_NET = NARROW_ALEXNET.replace("seed = 3\n", "seed = 3\ndtype = bfloat16\n")


def both_trainers(extra):
    jt = JaxTrainer(cfg=TUNE_NET + extra)
    jt.init_model()
    pt = NetTrainer(cfg=TUNE_NET + extra, device="cpu")
    pt.init_model()
    return jt, pt


def applied(tr):
    return (tr.steps_per_dispatch, tr.serve_max_batch, tr.stage_dtype,
            tr.serve_ladder, [list(c) for c in tr.net_cfg.layercfg])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tuning_cache_applies_the_same_knobs_in_both_packages(tmp_path,
                                                              writer):
    """One cache file, written by either package, loads in both and
    applies the same knobs and layer stamps; explicit keys win."""
    path = str(tmp_path / "tc.json")
    save = jax_tuning.save_entry if writer == "jax" else tuning.save_entry
    save(path, "cpu", {"steps_per_dispatch": 4, "serve_max_batch": 16,
                       "stage_dtype": "float32", "prefetch_stage": 2},
         layers={"conv1": {"space_to_depth": "1"},
                 "fc6": {"layer_dtype": "float32", "layer_quant": "float"},
                 "nope": {"layer_dtype": "float32"}},
         serve_ladder=[2, 6, 16])
    with open(path) as f:
        blob = json.load(f)
    assert blob["version"] == 2 and set(blob["platforms"]) == {"cpu"}
    jt, pt = both_trainers(f"tuning_cache = {path}\n")
    assert applied(pt) == applied(jt)
    assert pt.steps_per_dispatch == 4 and pt.serve_ladder == [2, 6, 16]
    assert ("space_to_depth", "1") in pt.net_cfg.layercfg[0]
    jt, pt = both_trainers(f"tuning_cache = {path}\nsteps_per_dispatch = 2\n"
                           "serve_bucket_ladder = 4,8\n")
    assert applied(pt) == applied(jt)
    assert pt.steps_per_dispatch == 2 and pt.serve_ladder == [4, 8]
    # another platform's entry applies nothing
    gpu = str(tmp_path / "gpu.json")
    tuning.save_entry(gpu, "gpu", {"steps_per_dispatch": 8})
    jt, pt = both_trainers(f"tuning_cache = {gpu}\n")
    assert pt.steps_per_dispatch == jt.steps_per_dispatch == 1
    assert tuning.platform_entry(gpu)["knobs"] == {"steps_per_dispatch": 8}


def test_tuning_cache_v1_migration_and_errors_match_jax(tmp_path):
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({"platforms": {"cpu": {"knobs": {
        "steps_per_dispatch": 3}}}}))
    assert tuning.load_cache(str(v1)) == jax_tuning.load_cache(str(v1))
    assert tuning.load_cache(str(v1))["version"] == 2
    bad = {
        "notjson": "{",
        "noplat": json.dumps({"version": 2}),
        "badver": json.dumps({"version": 7, "platforms": {}}),
        "knob": json.dumps({"platforms": {"cpu": {"knobs": {"x": 1}}}}),
        "layer": json.dumps({"platforms": {"cpu": {"layers": {
            "c1": {"bogus": 1}}}}}),
        "ladder": json.dumps({"platforms": {"cpu": {
            "serve_ladder": [4, 2]}}}),
    }
    for name, text in bad.items():
        p = tmp_path / f"{name}.json"
        p.write_text(text)
        with pytest.raises(ConfigError) as got:
            tuning.load_cache(str(p))
        with pytest.raises(JaxConfigError) as want:
            jax_tuning.load_cache(str(p))
        assert str(got.value) == str(want.value)
    assert tuning.TUNABLE_KEYS == jax_tuning.TUNABLE_KEYS
    assert tuning.LAYER_TUNABLE_KEYS == jax_tuning.LAYER_TUNABLE_KEYS


def test_cli_takes_steps_per_dispatch_from_the_cache(cli_data):
    """The port's CLI applies the task-level knobs (prefetch_stage,
    steps_per_dispatch) from a `cpu` entry - the checkpoint is the
    K = 1 run's, the events show chunks of the cache's K - and an
    explicit key beats the cache."""
    d, conf = cli_data
    tc = f"{d}/tc.json"
    tuning.save_entry(tc, "cpu", {"steps_per_dispatch": 2,
                                  "prefetch_stage": 0})
    r = run_cli("cxxnet_tpu_torch.main", conf, f"model_dir={d}/a",
                f"tuning_cache={tc}", f"log_file={d}/a.jsonl")
    assert "tuning_cache: applied prefetch_stage=0 steps_per_dispatch=2" \
        in r.stdout
    chunks = [e["steps"] for e in telemetry.read_jsonl(f"{d}/a.jsonl")
              if e.get("name") == "train.chunk"]
    # 5 batches a round: chunks of 2 + 2 + 1, three rounds
    assert chunks == [2, 2, 1] * 3
    run_cli("cxxnet_tpu_torch.main", conf, f"model_dir={d}/b",
            f"tuning_cache={tc}", "steps_per_dispatch=1",
            f"log_file={d}/b.jsonl")
    assert not [e for e in telemetry.read_jsonl(f"{d}/b.jsonl")
                if e.get("name") == "train.chunk"]
    run_cli("cxxnet_tpu_torch.main", conf, f"model_dir={d}/c")
    blobs = []
    for tag in "abc":
        with open(f"{d}/{tag}/0003.model", "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1] == blobs[2]


def test_autotune_writes_a_cache_the_cli_applies(tmp_path):
    from cxxnet_tpu_torch.tools import autotune
    out = str(tmp_path / "tc.json")
    assert autotune.main(["--dev", "cpu", "--budget-secs", "2",
                          "--serve", "0", "--per-layer", "0",
                          "--grid-k", "1,2", "--grid-prefetch", "0",
                          "--out", out]) == 0
    entry = tuning.platform_entry(out, "cpu")
    assert entry["knobs"]["steps_per_dispatch"] in (1, 2)
    assert entry["knobs"]["prefetch_stage"] == 0
    assert set(entry["measured"]["grid"]) >= {"k1_p0", "k2_p0"}
    # the JAX package reads the port's file
    assert jax_tuning.platform_entry(out, "cpu") == entry


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["steps_per_dispatch", "remat", "profile",
                                 "profile_dir", "trace_round",
                                 "tuning_cache"])
def test_schema_registers_the_ported_keys_as_the_jax_package_does(key):
    """Each key is a handler key of the same modules in both registries
    (the CLI's and / or the trainer's), and no longer a not-ported
    entry."""
    want = jax_schema.build_registry()
    got = port_schema.build_registry()
    assert key not in got.not_ported

    def files(reg):
        return sorted({w.split(":")[0].split("/", 1)[1]
                       for w in reg.exact[key]})
    assert files(got) == files(want)


def test_profile_step_tool_tabulates_the_step(tmp_path):
    """tools/profile_step.py on the CPU: the narrow AlexNet's ops by
    self time (its LRN backward among them) and a Chrome trace."""
    from cxxnet_tpu_torch.tools import profile_step
    conf = tmp_path / "net.conf"
    conf.write_text(NARROW_ALEXNET + TRAIN_KEYS)
    rows, total, step_ms, device = profile_step.capture(
        str(conf), steps=2, dev="cpu", batch=4,
        trace_dir=str(tmp_path / "tr"))
    assert device == "cpu" and step_ms > 0 and total > 0
    names = [r[0] for r in rows]
    assert any("convolution" in n for n in names)
    assert "_LRNBackward" in names or any("lrn" in n.lower() for n in names)
    md = profile_step.summarize(rows, total, 2, top=5, device=device)
    assert md.count("\n| `") == 5 and "self CPU" in md
    assert os.listdir(tmp_path / "tr") == ["profile_step.json"]
