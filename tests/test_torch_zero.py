"""ZeRO stages 2-3 of the port held to the JAX package (float32, CPU).

Port ranks - real processes joined over gloo by
cxxnet_tpu_torch.parallel.distributed - against the JAX trainer in this
process at the SAME mesh and zero_stage over the conftest's virtual
CPU devices. Both start from one JAX checkpoint, see the same global
batches (numpy, seeded; each port rank feeds the rows of its data
index) and train the same steps. Bar: the ranks bitwise equal to each
other where they hold the same thing (check_weights), every param
within rtol 1e-5 / atol 1e-6 of the JAX trainer's. Also here: the
sharding helpers against the JAX helpers, the stage >= 2 checks, the
group reduce-scatter, and the stage-3 checkpoint's bytes.

The `run_mesh` helper (and its worker) is shared with
tests/test_torch_tensor_parallel.py.
"""

import hashlib
import json
import pickle
import sys

import numpy as np
import pytest

from test_torch_distributed import (
    ATOL, CONV_LRN, MLP, RTOL, SMALL_MLP, Batches, eval_values,
    make_batches, spawn)

# tests/test_tensor_parallel.py's CONV_NET: conv, pool, batch_norm,
# prelu and two fullc, every param cut at model:2
CONV_NET = """
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 8
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 2
  stride = 2
layer[3->4] = batch_norm:bn1
layer[4->5] = prelu:pr1
layer[5->6] = flatten
layer[6->7] = fullc:fc1
  nhidden = 32
layer[7->8] = relu
layer[8->9] = fullc:fc2
  nhidden = 4
layer[9->9] = softmax
netconfig=end
input_shape = 3,8,8
random_type = xavier
eta = 0.1
momentum = 0.9
batch_size = 8
eval_train = 0
"""

# a sequence net: attention (qkv column / wproj row parallel), seq_fullc
ATTN_TP = """
netconfig=start
layer[0->1] = pos_embed:pe
layer[1->2] = layernorm:ln1
layer[2->3] = attention:att1
  nhead = {nhead}
  causal = 1
layer[3->4] = seq_fullc:ff
  nhidden = 8
layer[4->5] = relu
layer[5->6] = flatten
layer[6->7] = fullc:head
  nhidden = 4
layer[7->7] = softmax
netconfig=end
input_shape = 1,4,{e}
batch_size = 8
eta = 0.05
momentum = 0.9
random_type = xavier
"""

WORKER = r"""
import json, os, pickle, sys
import numpy as np
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.parallel import distributed, tensor


class Batches:
    def __init__(self, batches):
        self.batches, self.i = batches, -1

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < len(self.batches)

    def value(self):
        return self.batches[self.i]


spec = json.loads(os.environ["CXN_TEST_SPEC"])
t = NetTrainer(device="cpu", cfg=spec["cfg"] + '''
param_server = dist
dist_init_deadline = 60
silent = 1
''')
with open(spec["init"], "rb") as f:
    t.load_model(f)
if spec.get("state"):
    with open(spec["state"], "rb") as f:
        convert.train_state_from_numpy(t, pickle.load(f))
rank = int(os.environ["CXN_WORKER_RANK"])
lb, lo = t._local_batch, t._local_row_start
report = {"rank": rank}
if spec.get("save_init"):
    with open(f"{spec['out']}.{rank}.init.model", "wb") as f:
        t.save_model(f)


def mine(path):
    return [DataBatch(data=d[lo:lo + lb], label=l[lo:lo + lb])
            for d, l in zip(*np.load(path).values())]


batches = mine(spec["batches"])
k = spec["chunk"]
if k > 1:
    for i in range(0, len(batches), k):
        t.update_chunk(batches[i:i + k])
else:
    for b in batches:
        t.update(b)
report["state_bytes"] = t.state_bytes()
report["reduce_scatters"] = distributed.reduce_scatters[0]
report["tp_calls"] = dict(tensor.calls)
report["bad"] = t.check_weights()
report["bad_rounds"] = t.bad_rounds
report["epoch"] = t.epoch
out = t._host_params()
flat = {f"{lk}/{pn}": a for lk, d in out.items() for pn, a in d.items()}
np.savez(f"{spec['out']}.{rank}.npz", **flat)
if spec.get("save"):
    with open(f"{spec['out']}.{rank}.model", "wb") as f:
        t.save_model(f)
if spec.get("evals"):
    evals = mine(spec["evals"])
    report["eval"] = t.evaluate(Batches(evals), "test")
    np.save(f"{spec['out']}.{rank}.pred.npy",
            np.concatenate([t.predict_dist(b) for b in evals]))
if spec.get("weights"):
    w, shape = t.get_weight(*spec["weights"])
    report["weight_shape"] = list(shape)
    np.save(f"{spec['out']}.{rank}.weight.npy", w)
    t.set_weight(w * 2.0, *spec["weights"])
    w2, _ = t.get_weight(*spec["weights"])
    report["set_weight_ok"] = bool(np.array_equal(w2, w * 2.0))
    report["bad_after_set"] = t.check_weights()
if spec.get("export"):
    ust = convert.train_state_to_numpy(t)["ustate"]
    np.savez(f"{spec['out']}.{rank}.ustate.npz",
             **{f"{lk}/{pn}/{f}": a for lk, d in ust.items()
                for pn, st in d.items() for f, a in st.items()})
print(json.dumps(report), flush=True)
"""


def mesh_sizes(mesh: str):
    """(data size, model size, process count) of a mesh spec."""
    sizes = dict((a.strip(), int(n)) for a, n in
                 (p.split(":") for p in mesh.split(",")))
    d, m = sizes.get("data", 1), sizes.get("model", 1)
    return d, m, d * m


def jax_trainer(cfg: str, mesh: str):
    from cxxnet_tpu.nnet.trainer import NetTrainer
    from cxxnet_tpu.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(cfg + "\nsilent = 1\n"):
        t.set_param(k, v)
    t.set_param("mesh", mesh)
    t.init_model()
    return t


def run_mesh(tmp_path, cfg, mesh, shape, nclass=4, steps=3, chunk=1,
             nan_at=None, evals=0, carry=0, export=False, save=False,
             save_init=False, weights=None, jax_cfg=None):
    """(JAX trainer after `steps` updates at `mesh`, port params per rank
    (whole), port worker reports). `carry` > 0: the JAX trainer first
    takes `carry` updates and the ranks start from its whole train
    state. `evals` > 0: both then evaluate and predict_dist that many
    global batches. `save`: each rank's final checkpoint under
    report["model"]; `save_init`: its save of the loaded init under
    report["init_model"]; `weights` = (layer, tag): get_weight /
    set_weight after training. `jax_cfg`: the JAX trainer's config
    when it differs from the ranks' (default `cfg`)."""
    import jax
    from cxxnet_tpu.io.data import DataBatch
    dsize, _, nproc = mesh_sizes(mesh)
    jt = jax_trainer(jax_cfg or cfg, mesh)
    spec = {"cfg": cfg + f"\nmesh = {mesh}\n",
            "init": str(tmp_path / "init.model"),
            "batches": str(tmp_path / "batches.npz"),
            "chunk": chunk, "out": str(tmp_path / "port"), "save": save,
            "save_init": save_init, "weights": weights, "export": export}
    if carry:
        pre = make_batches(str(tmp_path / "pre.npz"), shape, nclass, carry,
                           seed=7)
        for d, l in zip(*pre):
            jt.update(DataBatch(data=d, label=l))
        spec["state"] = str(tmp_path / "state.pkl")
        with open(spec["state"], "wb") as f:
            pickle.dump({"params": jax.device_get(jt.state["params"]),
                         "ustate": jax.device_get(jt.state["ustate"]),
                         "epoch": jt.epoch}, f)
    with open(spec["init"], "wb") as f:
        jt.save_model(f)
    data, label = make_batches(spec["batches"], shape, nclass, steps, nan_at)
    if evals:
        spec["evals"] = str(tmp_path / "evals.npz")
        edata, elabel = make_batches(spec["evals"], shape, nclass, evals,
                                     seed=11)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    res = spawn([sys.executable, str(script)], nproc=nproc,
                extra={"CXN_TEST_SPEC": json.dumps(spec)})
    for rc, out in res:
        assert rc == 0, out
    reports = [json.loads(out.strip().splitlines()[-1]) for _, out in res]
    for d, l in zip(data, label):
        jt.update(DataBatch(data=d, label=l))
    jparams = jax.device_get(jt.state["params"])
    ports = [dict(np.load(str(tmp_path / f"port.{r}.npz")))
             for r in range(nproc)]
    for r, rep in enumerate(reports):
        base = str(tmp_path / f"port.{r}")
        if evals:
            rep["pred"] = np.load(base + ".pred.npy")
        if save:
            rep["model"] = base + ".model"
        if save_init:
            rep["init_model"] = base + ".init.model"
        if weights:
            rep["weight"] = np.load(base + ".weight.npy")
        if export:
            rep["ustate"] = dict(np.load(base + ".ustate.npz"))
    if evals:
        ebatches = [DataBatch(data=d, label=l) for d, l in zip(edata, elabel)]
        jt.jax_eval = jt.evaluate(Batches(ebatches), "test")
        jt.jax_pred = np.concatenate([jt.predict_dist(b) for b in ebatches])
    jt.dsize = dsize
    return jt, jparams, ports, reports


def assert_held(jparams, ports, reports):
    """Every rank's whole params equal (bitwise) and within the bar of
    the JAX trainer's; no rank's replicated params diverge."""
    for rep in reports:
        assert rep["bad"] == [], rep
    for r in range(1, len(ports)):
        assert ports[r].keys() == ports[0].keys()
        for key in ports[0]:
            np.testing.assert_array_equal(ports[r][key], ports[0][key],
                                          err_msg=key)
    for key in ports[0]:
        lk, pn = key.split("/")
        np.testing.assert_allclose(ports[0][key], np.asarray(jparams[lk][pn]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def assert_eval_held(jt, reports):
    """Every rank prints the JAX trainer's eval line and predicts the JAX
    trainer's rows of its data index's part of each global batch."""
    want = eval_values(jt.jax_eval)
    for rep in reports:
        got = eval_values(rep["eval"])
        assert got.keys() == want.keys(), (rep["eval"], jt.jax_eval)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    n = len(reports) // jt.dsize
    lb = jt.batch_size // jt.dsize
    jp = jt.jax_pred.reshape(-1, jt.dsize, lb, jt.jax_pred.shape[-1])
    for r, rep in enumerate(reports):
        np.testing.assert_allclose(
            rep["pred"], jp[:, r // n].reshape(-1, jp.shape[-1]),
            rtol=RTOL, atol=ATOL)


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# stages 2-3 on a data mesh, against the JAX trainer at the same stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage,net,extra,kw", [
    (2, "mlp", "update_period = 2\n", dict(steps=6)),
    (3, "mlp", "steps_per_dispatch = 2\ncheck_nan = 1\n",
     dict(steps=4, chunk=2, nan_at=1)),
    (2, "conv", "check_nan = 1\n", dict(steps=4, nan_at=2)),
    (3, "conv", "update_period = 2\nsteps_per_dispatch = 2\n",
     dict(steps=4, chunk=2)),
])
def test_zero_stage_matches_jax(tmp_path, stage, net, extra, kw):
    """zero_stage = 2 | 3 on data:2: the cut gradients reduce-scattered,
    the accumulator stored cut, under stage 3 the weights cut between
    steps - each held to the JAX trainer at the same stage, with
    update_period = 2, fused chunks of 2 and a NaN microstep (rank 1's
    rows) that both ranks drop."""
    cfg, shape, nclass = ((MLP, (1, 1, 784), 10) if net == "mlp"
                          else (CONV_LRN, (3, 8, 8), 4))
    cfg = cfg + f"zero_stage = {stage}\n" + extra
    jt, jp, ports, reps = run_mesh(tmp_path, cfg, "data:2", shape, nclass,
                                   **kw)
    assert_held(jp, ports, reps)
    assert [r["epoch"] for r in reps] == [jt.epoch] * 2
    want_bad = 1 if kw.get("nan_at") is not None else 0
    assert jt.bad_rounds == want_bad
    assert [r["bad_rounds"] for r in reps] == [want_bad] * 2
    # one reduce-scatter a microstep carries the cut gradients
    assert [r["reduce_scatters"] for r in reps] == [kw["steps"]] * 2
    b = reps[0]["state_bytes"]
    if net == "mlp":
        whole = 4 * (100 * 784 + 100 + 10 * 100 + 10)
        assert b["ustate"] == whole // 2
        assert b["grads"] == whole // 2
        assert b["params"] == (whole // 2 if stage == 3 else whole)


def test_zero3_carries_a_jax_train_state(tmp_path):
    """A JAX train state at zero_stage = 3 (its momentum after 2 updates,
    whole once device_get has it) carried into two stage-3 ranks: after
    3 more updates the params and the whole updater state, gathered
    back by convert.train_state_to_numpy, are the JAX trainer's."""
    import jax
    cfg = SMALL_MLP.format(fg=0) + "zero_stage = 3\n"
    jt, jp, ports, reps = run_mesh(tmp_path, cfg, "data:2", (1, 1, 8),
                                   carry=2, export=True)
    assert_held(jp, ports, reps)
    ju = jax.device_get(jt.state["ustate"])
    for rep in reps:
        for key, a in rep["ustate"].items():
            lk, pn, f = key.split("/")
            np.testing.assert_allclose(a, np.asarray(ju[lk][pn][f]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def test_zero3_checkpoint_bytes_equal_stage0(tmp_path):
    """A stage-3 run's checkpoints are the same bytes as stage 0's (the
    save gathers the cut; with two ranks each sum has two terms, so
    the reduce-scatter's bits are the all-reduce's), and the JAX
    package loads it to the JAX trainer's params within the bar."""
    from cxxnet_tpu.nnet import checkpoint as jckpt
    cfg = SMALL_MLP.format(fg=0)
    s0 = tmp_path / "s0"
    s3 = tmp_path / "s3"
    s0.mkdir()
    s3.mkdir()
    _, _, _, r0 = run_mesh(s0, cfg, "data:2", (1, 1, 8), save=True)
    _, jp, ports, r3 = run_mesh(s3, cfg + "zero_stage = 3\n", "data:2",
                                (1, 1, 8), save=True)
    assert_held(jp, ports, r3)
    digests = {sha256(r["model"]) for r in r0 + r3}
    assert len(digests) == 1, digests
    with open(r3[0]["model"], "rb") as f:
        blob = jckpt.load_model(f)
    for lk, d in blob["params"].items():
        for pn, a in d.items():
            np.testing.assert_allclose(a, np.asarray(jp[lk][pn]), rtol=RTOL,
                                       atol=ATOL)


def test_zero3_weight_access_and_predict(tmp_path):
    """Stage 3: predict_dist and the eval line equal the JAX trainer's
    (the weights all-gathered just in time), get_weight returns the
    whole 2-D weight on every rank, set_weight lands it whole and each
    rank keeps its cut again."""
    cfg = (SMALL_MLP.format(fg=0) + "zero_stage = 3\nmetric = logloss\n"
           "metric = error\n")
    jt, jp, ports, reps = run_mesh(tmp_path, cfg, "data:2", (1, 1, 8),
                                   evals=2, weights=("fc1", "wmat"))
    assert_held(jp, ports, reps)
    assert_eval_held(jt, reps)
    for rep in reps:
        assert rep["weight_shape"] == [16, 8]
        np.testing.assert_allclose(rep["weight"], np.asarray(
            jp["fc1"]["wmat"]), rtol=RTOL, atol=ATOL)
        assert rep["set_weight_ok"] and rep["bad_after_set"] == []


# ---------------------------------------------------------------------------
# the reduce-scatter's two routes
# ---------------------------------------------------------------------------

RS_WORKER = r"""
import json, os, sys
import torch
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
from cxxnet_tpu_torch.parallel import distributed
distributed.init_distributed(deadline=60)
r = distributed.process_index()
x = torch.arange(12, dtype=torch.float32) * (r + 1) + 0.25
print(json.dumps({"mine": distributed.reduce_scatter(x).tolist(),
                  "count": distributed.reduce_scatters[0]}), flush=True)
"""


def test_reduce_scatter_leaves_each_rank_its_chunk(tmp_path):
    """distributed.reduce_scatter over gloo: each of the 2 ranks gets its
    half of the sum of the ranks' tensors, never the whole."""
    script = tmp_path / "rs.py"
    script.write_text(RS_WORKER)
    res = spawn([sys.executable, str(script)])
    x = np.arange(12, dtype=np.float32)
    total = (x * 1 + 0.25) + (x * 2 + 0.25)
    for r, (rc, out) in enumerate(res):
        assert rc == 0, out
        rep = json.loads(out.strip().splitlines()[-1])
        np.testing.assert_array_equal(rep["mine"], total[r * 6:(r + 1) * 6])
        assert rep["count"] == 1


# ---------------------------------------------------------------------------
# unit tests: the sharding helpers against the JAX package's, the checks
# ---------------------------------------------------------------------------

def _spec_tuple(ps) -> tuple:
    spec = list(tuple(ps))
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _both(cfg, mesh):
    """(JAX trainer at `mesh`, one-process port trainer with its net
    built) for the helpers' inputs."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    jt = jax_trainer(cfg + "\nbatch_size = 8\n", mesh)
    pt = NetTrainer(device="cpu", cfg=cfg + "\nbatch_size = 8\nsilent = 1\n")
    pt.init_model()
    shapes = {lk: {pn: tuple(t.shape) for pn, t in d.items()}
              for lk, d in pt.state["params"].items()}
    return jt, pt, shapes


@pytest.mark.parametrize("net,mesh", [
    ("conv", "model:2"), ("conv", "data:2,model:2"), ("conv", "data:4,model:2"),
    ("attn", "model:2"), ("attn", "data:2,model:4"), ("mlp", "data:4"),
    ("mlp", "data:2,model:4")])
def test_placements_equal_jax(net, mesh):
    """param_pspecs, shardings_for, zero_partition_dims and the ZeRO
    trees equal the JAX helpers' on the same net and mesh."""
    from cxxnet_tpu.parallel import sharding as jshard
    from cxxnet_tpu_torch.parallel import sharding as pshard
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    cfg = {"conv": CONV_NET, "attn": ATTN_TP.format(nhead=2, e=8),
           "mlp": MLP}[net]
    jt, pt, shapes = _both(cfg, mesh)
    pm = Mesh(tuple((a, int(n)) for a, n in
                    (p.split(":") for p in mesh.split(","))))
    jspecs = jshard.param_pspecs(jt.net)
    assert pshard.param_pspecs(shapes, pt.net) == {
        lk: {pn: _spec_tuple(s) for pn, s in d.items()}
        for lk, d in jspecs.items()}
    jsh = jshard.shardings_for(jt.mesh, jt.net)
    got = pshard.shardings_for(pm, shapes, pt.net)
    assert got == {lk: {pn: _spec_tuple(ns.spec) for pn, ns in d.items()}
                   for lk, d in jsh.items()}
    dims = pshard.zero_partition_dims(pm, shapes, got)
    assert dims == jshard.zero_partition_dims(jt.mesh, jt.net, jsh)
    for pfn, jfn in ((pshard.zero_shardings, jshard.zero3_shardings),
                     (pshard.zero_shardings, jshard.zero2_shardings)):
        assert pfn(pm, shapes, got, dims) == {
            lk: {pn: _spec_tuple(ns.spec) for pn, ns in d.items()}
            for lk, d in jfn(jt.mesh, jt.net, jsh).items()}
    pscat, pgat = pshard.zero_region_specs(pm, shapes, got, dims)
    jscat, jgat = jshard.zero_region_specs(jt.mesh, jt.net, jsh)
    assert pscat == {lk: {pn: _spec_tuple(s) for pn, s in d.items()}
                     for lk, d in jscat.items()}
    assert pgat == {lk: {pn: _spec_tuple(s) for pn, s in d.items()}
                    for lk, d in jgat.items()}


FALLBACK_NET = """
netconfig=start
layer[0->1] = fullc:fc
  nhidden = {nh}
layer[1->1] = softmax
netconfig=end
input_shape = 1,1,4
"""


@pytest.mark.parametrize("nhidden,msize,want", [
    (5, 2, ()), (6, 4, ()), (6, 3, ("model",)), (8, 2, ("model",))])
def test_indivisible_dims_fall_back_to_replication(nhidden, msize, want):
    """A declared model dim the axis does not divide stays replicated
    (the whole weight on every model rank), as in the JAX package."""
    from cxxnet_tpu.parallel import sharding as jshard
    from cxxnet_tpu_torch.parallel import sharding as pshard
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    jt, pt, shapes = _both(FALLBACK_NET.format(nh=nhidden),
                           f"model:{msize}")
    got = pshard.shardings_for(Mesh((("model", msize),)), shapes, pt.net)
    assert got["fc"]["wmat"] == want and got["fc"]["bias"] == want
    jsh = jshard.shardings_for(jt.mesh, jt.net)
    assert _spec_tuple(jsh["fc"]["wmat"].spec) == want


ZERO_CHECK_MLP = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 8
layer[1->2] = batch_norm:bn
  global_stats = {gs}
layer[2->3] = fullc:fc2
  nhidden = 2
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 8
zero_stage = 2
silent = 1
"""


@pytest.mark.parametrize("case", ["axes", "updater", "sync_bn", "degrade"])
def test_zero_stage_checks_raise_as_jax(case):
    """The JAX trainer's four rules for zero_stage >= 2: it composes
    with data/model axes only, every updater must be zero_shardable,
    sync-BN is refused (the same messages), and a mesh without a data
    axis degrades the stage to <= 1."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.updater.updaters import SGDUpdater
    t = NetTrainer(device="cpu", cfg=ZERO_CHECK_MLP.format(
        gs=1 if case == "sync_bn" else 0))
    t.init_model()
    assert t._zero_run <= 1 and t.zero_stage == 2
    if case == "degrade":
        assert t._zero is None
        return
    if case == "axes":
        with pytest.raises(ValueError, match="seq"):
            t._check_zero(2, (("data", 2), ("seq", 4)))
        t._check_zero(2, (("data", 2), ("model", 2)))
    if case == "updater":
        orig = SGDUpdater.zero_shardable
        SGDUpdater.zero_shardable = False
        try:
            with pytest.raises(ValueError, match="zero_shardable"):
                t._check_zero(2, (("data", 2),))
        finally:
            SGDUpdater.zero_shardable = orig
    if case == "sync_bn":
        with pytest.raises(ValueError, match="sync-BN"):
            t._check_zero(2, (("data", 2),))
        t._check_zero(1, (("data", 2),))


def test_zero_smoke_tool_passes_on_the_cpu(tmp_path):
    """tools/zero_smoke.py --dev cpu: four two-rank CLI jobs (stage 0, 2,
    2 at steps_per_dispatch = 4, 3) print the same eval lines and end in
    one checkpoint sha256."""
    from cxxnet_tpu_torch.tools import zero_smoke
    runs = zero_smoke.run_smoke(str(tmp_path), dev="cpu")
    assert runs["_checks"] == {"ok": True, "n": 10}
    assert len({runs[t]["sha"] for t in zero_smoke.RUNS}) == 1
    assert len(runs["z0"]["evals"]) == 6
