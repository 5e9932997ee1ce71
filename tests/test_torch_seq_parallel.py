"""The seq mesh axis of the port held to the JAX package (float32, CPU).

Port ranks - real processes joined over gloo by
cxxnet_tpu_torch.parallel.distributed - against the JAX package in this
process at the same mesh over the conftest's virtual CPU devices.

- The ops: each rank runs `ring_attention` / `ulysses_attention` on its
  [B, H_local, S/n, D] blocks (rows of its data index, heads of its
  model shard, its sequence block) of one global q, k, v and output
  gradient; its output block and its q / k / v gradient blocks against
  the JAX functions' on the whole arrays, within rtol / atol 1e-5 (the
  JAX package's own bar, tests/test_attention.py). Also the ring's
  schedule: n - 1 hops, the partials the causal skip leaves, no
  all-gather; Ulysses' all-to-alls only, and its refusal of indivisible
  heads.
- The trainer: a seq_mnist-like net (pos_embed, split, layernorm,
  attention, add, seq_fullc, flatten, dropout with the JAX trainer's
  masks injected, fullc, softmax) at data:1,seq:2 and data:2,seq:2, both
  schemes; a transformer_stack net; a y dim the axis does not divide;
  ZeRO-1 and the refusal of stage 2; the checkpoint's bytes. Three
  steps from one JAX checkpoint; every rank's params bitwise equal and
  within rtol 2e-4 / atol 2e-5 of the JAX trainer's at the same mesh
  (tests/test_transformer.py's bar).
- The CLI at data:1,seq:2 with test_on_server = 1: both ranks print the
  same round lines, and they are the JAX CLI's.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest

from test_torch_distributed import Batches, eval_values, make_batches, spawn
from test_torch_zero import sha256

RTOL_OP, ATOL_OP = 1e-5, 1e-5
RTOL, ATOL = 2e-4, 2e-5

OPS_WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
import torch
import torch.distributed as dist
from cxxnet_tpu_torch.parallel import distributed, ring
from cxxnet_tpu_torch.parallel.mesh import (
    MeshSpec, build_mesh, parse_mesh_spec)

spec = json.loads(os.environ["CXN_TEST_SPEC"])
distributed.init_distributed(deadline=60)
rank = distributed.process_index()
mesh = build_mesh(MeshSpec(axes=parse_mesh_spec(spec["mesh"])), 2,
                  distributed.process_count(), rank)
arrays = np.load(spec["arrays"])
gathers = [0]
real_all_gather = dist.all_gather


def counted(*a, **k):
    gathers[0] += 1
    return real_all_gather(*a, **k)


dist.all_gather = counted
sizes = mesh.shape
b, h, s, d = arrays["q"].shape
nd, nm, ns = sizes.get("data", 1), sizes.get("model", 1), sizes.get("seq", 1)
rows = slice(mesh.rank * b // nd, (mesh.rank + 1) * b // nd)
heads = (slice(mesh.model_rank * h // nm, (mesh.model_rank + 1) * h // nm)
         if h % nm == 0 else slice(0, h))
blk = slice(mesh.seq_rank * s // ns, (mesh.seq_rank + 1) * s // ns)
out = {}
report = {"rank": rank}
for scheme in ("ring", "ulysses"):
    for causal in (0, 1):
        for k in ring.calls:
            ring.calls[k] = 0
        for k in distributed.seq_exchanges:
            distributed.seq_exchanges[k] = 0
        gathers[0] = 0
        q, k_, v = (torch.from_numpy(arrays[n][rows, heads, blk].copy())
                    .requires_grad_(True) for n in ("q", "k", "v"))
        do = torch.from_numpy(arrays["do"][rows, heads, blk].copy())
        o = ring.seq_parallel_attention(q, k_, v, mesh, scheme,
                                        causal=bool(causal))
        (o * do).sum().backward()
        tag = f"{scheme}{causal}"
        out[tag + "/o"] = o.detach().numpy()
        for n, t in (("dq", q), ("dk", k_), ("dv", v)):
            out[f"{tag}/{n}"] = t.grad.numpy()
        report[tag] = {"calls": dict(ring.calls),
                       "exchanges": dict(distributed.seq_exchanges),
                       "all_gather": gathers[0]}
if spec.get("odd_heads"):
    try:
        q = torch.zeros(1, 3, 4, 2)
        ring.ulysses_attention(q, q, q, mesh)
        report["odd_heads"] = ""
    except ValueError as e:
        report["odd_heads"] = str(e)
np.savez(f"{spec['out']}.{rank}.npz", **out)
print(json.dumps(report), flush=True)
"""

# the mesh's coordinates of each rank, row-major in the spec's order
OPS_MESHES = ["seq:2", "data:2,seq:2", "data:1,model:2,seq:2"]


def _sizes(mesh: str):
    return [(a.strip(), int(n)) for a, n in
            (p.split(":") for p in mesh.split(","))]


def _coords(rank: int, sizes):
    out = {}
    for name, n in reversed(sizes):
        out[name] = rank % n
        rank //= n
    return out


@pytest.fixture(scope="module")
def ops_runs(tmp_path_factory):
    """For each mesh: the JAX functions' outputs and gradients on the
    whole arrays, and each port rank's (blocks and report)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from cxxnet_tpu.parallel.ring import ring_attention, ulysses_attention
    rng = np.random.RandomState(0)
    arrays = {n: rng.randn(2, 4, 16, 8).astype(np.float32)
              for n in ("q", "k", "v", "do")}
    runs = {}
    for mesh in OPS_MESHES:
        d = tmp_path_factory.mktemp(mesh.replace(":", "").replace(",", "_"))
        np.savez(d / "arrays.npz", **arrays)
        sizes = _sizes(mesh)
        nproc = int(np.prod([n for _, n in sizes]))
        devs = np.array(jax.devices()[:nproc]).reshape([n for _, n in sizes])
        jmesh = Mesh(devs, tuple(a for a, _ in sizes))
        want = {}
        for scheme, fn in (("ring", ring_attention),
                           ("ulysses", ulysses_attention)):
            for causal in (0, 1):
                def loss(q, k, v):
                    o = fn(q, k, v, jmesh, causal=bool(causal))
                    return jnp.sum(o * arrays["do"])
                q, k, v = (jnp.asarray(arrays[n]) for n in ("q", "k", "v"))
                tag = f"{scheme}{causal}"
                want[tag + "/o"] = np.asarray(
                    fn(q, k, v, jmesh, causal=bool(causal)))
                for n, g in zip(("dq", "dk", "dv"),
                                jax.grad(loss, argnums=(0, 1, 2))(q, k, v)):
                    want[f"{tag}/{n}"] = np.asarray(g)
        spec = {"mesh": mesh, "arrays": str(d / "arrays.npz"),
                "out": str(d / "port"), "odd_heads": mesh == "seq:2"}
        script = d / "ops_worker.py"
        script.write_text(OPS_WORKER)
        res = spawn([sys.executable, str(script)], nproc=nproc,
                    extra={"CXN_TEST_SPEC": json.dumps(spec)})
        for rc, out in res:
            assert rc == 0, out
        reports = [json.loads(out.strip().splitlines()[-1]) for _, out in res]
        ports = [dict(np.load(str(d / f"port.{r}.npz")))
                 for r in range(nproc)]
        runs[mesh] = (sizes, want, ports, reports)
    return runs


@pytest.mark.parametrize("mesh", OPS_MESHES)
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [0, 1])
def test_seq_attention_matches_jax(ops_runs, mesh, scheme, causal):
    """Each rank's output block and q / k / v gradient blocks are the
    JAX function's on the whole arrays (batch on data, heads on model,
    sequence on seq)."""
    sizes, want, ports, _ = ops_runs[mesh]
    b, h, s, _ = want["ring0/o"].shape
    ax = dict(sizes)
    nd, nm, ns = ax.get("data", 1), ax.get("model", 1), ax["seq"]
    tag = f"{scheme}{causal}"
    for r, port in enumerate(ports):
        c = _coords(r, sizes)
        rows = slice(c.get("data", 0) * b // nd,
                     (c.get("data", 0) + 1) * b // nd)
        heads = slice(c.get("model", 0) * h // nm,
                      (c.get("model", 0) + 1) * h // nm)
        blk = slice(c["seq"] * s // ns, (c["seq"] + 1) * s // ns)
        for n in ("o", "dq", "dk", "dv"):
            np.testing.assert_allclose(
                port[f"{tag}/{n}"], want[f"{tag}/{n}"][rows, heads, blk],
                rtol=RTOL_OP, atol=ATOL_OP, err_msg=f"rank {r} {tag} {n}")


@pytest.mark.parametrize("mesh", OPS_MESHES)
@pytest.mark.parametrize("causal", [0, 1])
def test_ring_schedule(ops_runs, mesh, causal):
    """The ring at n = 2: one hop forward (the last block is not sent
    on), two in the backward (the buffers' hop home included); under
    causal seq rank 0 skips rank 1's block (one partial each way) while
    rank 1 computes both; no all-gather."""
    sizes, _, _, reports = ops_runs[mesh]
    for r, rep in enumerate(reports):
        st = rep[f"ring{causal}"]
        seq_rank = _coords(r, sizes)["seq"]
        parts = 1 if (causal and seq_rank == 0) else 2
        assert st["calls"]["ring"] == 1 and st["calls"]["ulysses"] == 0
        assert st["calls"]["hops"] == 1
        assert st["calls"]["partials"] == parts
        assert st["calls"]["backward_partials"] == parts
        assert st["exchanges"] == {"hop": 3, "all_to_all": 0}
        assert st["all_gather"] == 0


@pytest.mark.parametrize("mesh", OPS_MESHES)
def test_ulysses_exchanges_only_all_to_all(ops_runs, mesh):
    """Ulysses: one all-to-all in (q, k, v together) and one out, their
    inverses in the backward; no hop, no all-gather."""
    _, _, _, reports = ops_runs[mesh]
    for rep in reports:
        for causal in (0, 1):
            st = rep[f"ulysses{causal}"]
            assert st["calls"]["ulysses"] == 1 and st["calls"]["ring"] == 0
            assert st["exchanges"] == {"hop": 0, "all_to_all": 4}
            assert st["all_gather"] == 0


def test_ulysses_refuses_indivisible_heads(ops_runs):
    """3 heads over a seq axis of 2: the JAX package's ValueError."""
    _, _, _, reports = ops_runs["seq:2"]
    for rep in reports:
        assert rep["odd_heads"] == (
            "ulysses needs heads per shard (3) divisible by the seq axis "
            "(2); use ring_attention instead")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

SEQ_NET = """
netconfig=start
layer[0->1] = pos_embed:pe
layer[1->2,3] = split
layer[2->4] = layernorm:ln1
layer[4->5] = attention:att1
  nhead = 2
  causal = {causal}
  seq_parallel = {sp}
layer[5,3->6] = add
layer[6->7] = seq_fullc:ff
  nhidden = 8
layer[7->8] = relu
layer[8->9] = flatten
layer[9->9] = dropout
  threshold = 0.2
layer[9->10] = fullc:head
  nhidden = 4
layer[10->10] = softmax
netconfig=end
input_shape = 1,{s},8
batch_size = 8
eta = 0.05
momentum = 0.9
random_type = xavier
metric = error
"""

STACK_NET = """
netconfig=start
layer[0->1] = transformer_stack:ts
  nlayer = 2
  nhead = 2
  nhidden = 16
  causal = 1
  seq_parallel = {sp}
layer[1->2] = flatten
layer[2->3] = fullc:head
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 1,8,8
batch_size = 8
eta = 0.05
momentum = 0.9
random_type = xavier
"""

TRAIN_WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.parallel import distributed, ring


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
rank = int(os.environ["CXN_WORKER_RANK"])
try:
    t = NetTrainer(device="cpu", cfg=spec["cfg"] + '''
param_server = dist
dist_init_deadline = 60
silent = 1
''')
    with open(spec["init"], "rb") as f:
        t.load_model(f)
except ValueError as e:
    print(json.dumps({"rank": rank, "error": str(e)}), flush=True)
    sys.exit(0)
report = {"rank": rank, "seq_rank": t.mesh.seq_rank,
          "local": [t._local_batch, t._local_row_start]}
if spec.get("save_init"):
    with open(f"{spec['out']}.{rank}.init.model", "wb") as f:
        t.save_model(f)
lb, lo = t._local_batch, t._local_row_start
data = np.load(spec["batches"])
keeps = np.load(spec["keeps"]) if spec.get("keeps") else None
for step, (d, l) in enumerate(zip(data["data"], data["label"])):
    keep = ({int(k.split("_")[1]): keeps[k][lo:lo + lb] for k in keeps
             if k.startswith(f"{step}_")} if keeps is not None else None)
    t.update(DataBatch(data=d[lo:lo + lb], label=l[lo:lo + lb]), keep=keep)
report["bad"] = t.check_weights()
report["train"] = t.eval_train_metric()
report["ring_calls"] = dict(ring.calls)
report["pipe_exchanges"] = dict(distributed.pipe_exchanges)
report["ustate_bytes"] = t.ustate_bytes()
report["shapes"] = {f"{lk}/{pn}": list(a.shape)
                    for lk, dd in t.state["params"].items()
                    for pn, a in dd.items()}
out = t._host_params()
np.savez(f"{spec['out']}.{rank}.npz",
         **{f"{lk}/{pn}": a for lk, dd in out.items() for pn, a in dd.items()})
if spec.get("save"):
    with open(f"{spec['out']}.{rank}.model", "wb") as f:
        t.save_model(f)
if spec.get("evals"):
    ev = np.load(spec["evals"])
    evals = [DataBatch(data=d[lo:lo + lb], label=l[lo:lo + lb])
             for d, l in zip(ev["data"], ev["label"])]
    report["eval"] = t.evaluate(Batches(evals), "test")
    np.save(f"{spec['out']}.{rank}.pred.npy",
            np.concatenate([t.predict_dist(b) for b in evals]))
    # a node the network holds seq-sharded comes back whole
    np.save(f"{spec['out']}.{rank}.extract.npy",
            np.concatenate([t.extract_feature(b, spec["extract"])
                            for b in evals]))
print(json.dumps(report), flush=True)
"""


def _jax_trainer(cfg: str, mesh: str):
    from cxxnet_tpu.nnet.trainer import NetTrainer
    from cxxnet_tpu.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(cfg + "\nsilent = 1\n"):
        t.set_param(k, v)
    t.set_param("mesh", mesh)
    t.init_model()
    return t


def _jax_keeps(jt, steps: int) -> dict:
    """The JAX trainer's dropout masks at steps 0.. (global rows)."""
    import jax
    import jax.numpy as jnp
    out = {}
    for step in range(steps):
        rng = jax.random.fold_in(jax.random.PRNGKey(jt.seed + 100), step)
        for idx, info in enumerate(jt.net_cfg.layers):
            if info.type_name == "dropout":
                shape = jt.net.node_shapes[info.nindex_in[0]]
                key = jax.random.fold_in(rng, idx)
                pkeep = 1.0 - jt.net.layer_objs[idx].threshold
                out[f"{step}_{idx}"] = np.array(
                    jax.random.uniform(key, shape, jnp.float32) < pkeep)
    return out


def run_seq(tmp_path, cfg, mesh, shape, steps=3, evals=0, save=False,
            save_init=False, jax_cfg=None, train=True, extract="top[-5]",
            shift=0.0):
    """(JAX trainer after `steps` updates at `mesh`, each port rank's
    whole params, each rank's report). The ranks start from the JAX
    trainer's checkpoint, feed the rows of their data index of the same
    global batches (numpy, seeded; `shift` added to the first 4
    features of the first half of the rows, so that two data shards
    differ) and take the JAX trainer's dropout masks."""
    import jax
    from cxxnet_tpu.io.data import DataBatch
    sizes = dict(_sizes(mesh))
    nproc = int(np.prod(list(sizes.values())))
    jt = _jax_trainer(jax_cfg or cfg, mesh)
    spec = {"cfg": cfg + f"\nmesh = {mesh}\n",
            "init": str(tmp_path / "init.model"),
            "batches": str(tmp_path / "batches.npz"),
            "out": str(tmp_path / "port"), "save": save,
            "save_init": save_init, "extract": extract}
    with open(spec["init"], "wb") as f:
        jt.save_model(f)
    data, label = make_batches(spec["batches"], shape, 4, steps)
    if shift:
        data[:, :4, ..., :4] += shift
        np.savez(spec["batches"], data=data, label=label)
    keeps = _jax_keeps(jt, steps)
    if keeps:
        spec["keeps"] = str(tmp_path / "keeps.npz")
        np.savez(spec["keeps"], **keeps)
    if evals:
        spec["evals"] = str(tmp_path / "evals.npz")
        edata, elabel = make_batches(spec["evals"], shape, 4, evals, seed=11)
    script = tmp_path / "train_worker.py"
    script.write_text(TRAIN_WORKER)
    res = spawn([sys.executable, str(script)], nproc=nproc,
                extra={"CXN_TEST_SPEC": json.dumps(spec)})
    for rc, out in res:
        assert rc == 0, out
    reports = [json.loads(out.strip().splitlines()[-1]) for _, out in res]
    if not train:
        return jt, None, None, reports
    for d, l in zip(data, label):
        jt.update(DataBatch(data=d, label=l))
    jparams = jax.device_get(jt.state["params"])
    ports = [dict(np.load(str(tmp_path / f"port.{r}.npz")))
             for r in range(nproc)]
    for r, rep in enumerate(reports):
        base = str(tmp_path / f"port.{r}")
        if evals:
            rep["pred"] = np.load(base + ".pred.npy")
            rep["extract"] = np.load(base + ".extract.npy")
        if save:
            rep["model"] = base + ".model"
        if save_init:
            rep["init_model"] = base + ".init.model"
    if evals:
        eb = [DataBatch(data=d, label=l) for d, l in zip(edata, elabel)]
        jt.jax_eval = jt.evaluate(Batches(eb), "test")
        jt.jax_pred = np.concatenate([jt.predict_dist(b) for b in eb])
        jt.jax_extract = np.concatenate([jt.extract_feature(b, extract)
                                         for b in eb])
    return jt, jparams, ports, reports


def assert_held(jparams, ports, reports, rtol=RTOL, atol=ATOL):
    """Every rank's params bitwise equal to rank 0's (check_weights
    clean, over the data, model, seq, expert and pipe groups) and within
    the bar (`rtol` / `atol`) of the JAX trainer's."""
    for rep in reports:
        assert rep["bad"] == [], rep
    for r in range(1, len(ports)):
        assert ports[r].keys() == ports[0].keys()
        for key in ports[0]:
            np.testing.assert_array_equal(ports[r][key], ports[0][key],
                                          err_msg=f"rank {r} {key}")
    for key in ports[0]:
        lk, pn = key.split("/")
        np.testing.assert_allclose(ports[0][key], np.asarray(jparams[lk][pn]),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("mesh", ["data:1,seq:2", "data:2,seq:2"])
@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_seq_net_trains_as_jax(tmp_path, mesh, sp):
    """The seq_mnist-like net on a seq mesh: three steps, then the eval
    line, predict_dist and extract_feature of a node the network holds
    seq-sharded (the residual sum, whole on every rank); the seq ranks
    of a data index feed its whole rows, and the train metric counts
    each row once."""
    cfg = SEQ_NET.format(causal=0, sp=sp, s=8)
    jt, jp, ports, reps = run_seq(tmp_path, cfg, mesh, (1, 8, 8), evals=2)
    assert_held(jp, ports, reps)
    nd = dict(_sizes(mesh))["data"]
    lb = 8 // nd
    jtrain = eval_values(jt.eval_train_metric())
    want = eval_values(jt.jax_eval)
    jpred = jt.jax_pred.reshape(2, nd, lb, -1)
    for rep in reps:
        assert rep["ring_calls"][sp] > 0
        got = eval_values(rep["train"])
        np.testing.assert_allclose(got["train-error"],
                                   jtrain["train-error"], atol=1e-6)
        got = eval_values(rep["eval"])
        np.testing.assert_allclose(got["test-error"], want["test-error"],
                                   atol=1e-6)
        d = rep["local"][1] // lb
        np.testing.assert_allclose(
            rep["pred"], jpred[:, d].reshape(-1, jpred.shape[-1]),
            rtol=RTOL, atol=ATOL)
        jx = jt.jax_extract.reshape((2, nd, lb) + jt.jax_extract.shape[1:])
        assert rep["extract"].shape == (2 * lb, 1, 8, 8)
        np.testing.assert_allclose(
            rep["extract"], jx[:, d].reshape(rep["extract"].shape),
            rtol=RTOL, atol=ATOL)


def test_causal_seq_net_trains_as_jax(tmp_path):
    """causal = 1 through the ring at data:2,seq:2: seq rank 0 skips
    the later block."""
    cfg = SEQ_NET.format(causal=1, sp="ring", s=8)
    jt, jp, ports, reps = run_seq(tmp_path, cfg, "data:2,seq:2", (1, 8, 8))
    assert_held(jp, ports, reps)


@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_transformer_stack_trains_as_jax(tmp_path, sp):
    """A two-block causal transformer_stack at data:2,seq:2: each block's
    core through the seq route."""
    jt, jp, ports, reps = run_seq(tmp_path, STACK_NET.format(sp=sp),
                                  "data:2,seq:2", (1, 8, 8))
    assert_held(jp, ports, reps)
    for rep in reps:
        assert rep["ring_calls"][sp] == 3 * 2


def test_indivisible_sequence_falls_back(tmp_path):
    """A y dim of 7 on seq:2: nothing is seq-sharded (the JAX package's
    `_data_sharded` fallback) and attention runs whole on every rank."""
    cfg = SEQ_NET.format(causal=1, sp="ring", s=7)
    jt, jp, ports, reps = run_seq(tmp_path, cfg, "data:1,seq:2", (1, 7, 8))
    assert_held(jp, ports, reps)
    for rep in reps:
        assert rep["ring_calls"]["ring"] == 0


def test_zero1_on_a_seq_mesh_trains_as_jax(tmp_path):
    """update_on_server = 1 at data:2,seq:2: the updater state cut over
    the data ranks (each seq column updates alike)."""
    cfg = SEQ_NET.format(causal=0, sp="ring", s=8) + "update_on_server = 1\n"
    jt, jp, ports, reps = run_seq(tmp_path, cfg, "data:2,seq:2", (1, 8, 8))
    assert_held(jp, ports, reps)
    whole = sum(a.nbytes for a in ports[0].values())
    assert all(rep["ustate_bytes"] < whole for rep in reps)


def test_zero2_on_a_seq_mesh_raises(tmp_path):
    """zero_stage = 2 at data:2,seq:2: every rank raises the JAX
    trainer's ValueError."""
    cfg = SEQ_NET.format(causal=0, sp="ring", s=8)
    _, _, _, reps = run_seq(tmp_path, cfg + "zero_stage = 2\n",
                            "data:2,seq:2", (1, 8, 8), jax_cfg=cfg,
                            train=False)
    for rep in reps:
        assert "composes with 'data'/'model' mesh axes only; axes " \
               "['seq']" in rep["error"], rep


def test_seq_checkpoint_bytes(tmp_path):
    """At data:2,seq:2 every rank saves the loaded JAX init back as the
    init file's bytes, every rank's trained checkpoint is the same
    bytes, and it loads in the JAX package to the JAX trainer's
    params."""
    from cxxnet_tpu.nnet import checkpoint as jckpt
    cfg = SEQ_NET.format(causal=0, sp="ring", s=8)
    jt, jp, ports, reps = run_seq(tmp_path, cfg, "data:2,seq:2", (1, 8, 8),
                                  save=True, save_init=True)
    assert_held(jp, ports, reps)
    init = sha256(str(tmp_path / "init.model"))
    assert {sha256(r["init_model"]) for r in reps} == {init}
    assert len({sha256(r["model"]) for r in reps}) == 1
    with open(reps[0]["model"], "rb") as f:
        blob = jckpt.load_model(f)
    for lk, d in blob["params"].items():
        for pn, a in d.items():
            np.testing.assert_allclose(a, np.asarray(jp[lk][pn]), rtol=RTOL,
                                       atol=ATOL)


def test_seq_carries_a_jax_train_state(tmp_path):
    """A JAX train state at data:2,seq:2 (momentum after 2 updates)
    carried into four ranks (params and state replicated over seq);
    after one more update every rank holds the JAX trainer's params."""
    import jax
    from cxxnet_tpu.io.data import DataBatch
    from test_torch_zero import WORKER
    cfg = SEQ_NET.format(causal=0, sp="ring", s=8).replace(
        "layer[9->9] = dropout\n  threshold = 0.2\n", "")
    jt = _jax_trainer(cfg, "data:2,seq:2")
    pre = make_batches(str(tmp_path / "pre.npz"), (1, 8, 8), 4, 2, seed=7)
    for d, l in zip(*pre):
        jt.update(DataBatch(data=d, label=l))
    spec = {"cfg": cfg + "\nmesh = data:2,seq:2\n",
            "init": str(tmp_path / "init.model"),
            "state": str(tmp_path / "state.pkl"),
            "batches": str(tmp_path / "batches.npz"), "chunk": 1,
            "out": str(tmp_path / "port"), "export": True}
    with open(spec["init"], "wb") as f:
        jt.save_model(f)
    with open(spec["state"], "wb") as f:
        pickle.dump({"params": jax.device_get(jt.state["params"]),
                     "ustate": jax.device_get(jt.state["ustate"]),
                     "epoch": jt.epoch}, f)
    data, label = make_batches(spec["batches"], (1, 8, 8), 4, 1)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    res = spawn([sys.executable, str(script)], nproc=4,
                extra={"CXN_TEST_SPEC": json.dumps(spec)})
    for rc, out in res:
        assert rc == 0, out
    reps = [json.loads(out.strip().splitlines()[-1]) for _, out in res]
    jt.update(DataBatch(data=data[0], label=label[0]))
    ports = [dict(np.load(str(tmp_path / f"port.{r}.npz"))) for r in range(4)]
    assert_held(jax.device_get(jt.state["params"]), ports, reps)
    ju = jax.device_get(jt.state["ustate"])
    for r in range(4):
        ust = dict(np.load(str(tmp_path / f"port.{r}.ustate.npz")))
        for key, a in ust.items():
            lk, pn, f = key.split("/")
            np.testing.assert_allclose(a, np.asarray(ju[lk][pn][f]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_NET = """
netconfig=start
layer[0->1] = layernorm:ln1
layer[1->2] = attention:att1
  nhead = 4
  causal = 1
layer[2->3] = flatten
layer[3->4] = fullc:head
  nhidden = 10
layer[4->4] = softmax
netconfig=end
input_shape = 1,28,28
random_type = xavier
batch_size = 32
eta = 0.05
momentum = 0.9
"""

CLI_DATA = """
data = train
iter = mnist
    path_img = "{d}/data/train-images-idx3-ubyte.gz"
    path_label = "{d}/data/train-labels-idx1-ubyte.gz"
    input_flat = 0
iter = end
eval = test
iter = mnist
    path_img = "{d}/data/t10k-images-idx3-ubyte.gz"
    path_label = "{d}/data/t10k-labels-idx1-ubyte.gz"
    input_flat = 0
iter = end
num_round = 2
max_round = 2
metric = error
save_model = 1
test_on_server = 1
param_server = dist
"""


def test_cli_seq_mesh_matches_jax_cli(tmp_path):
    """mesh = data:1,seq:2 through both CLIs as two ranks with
    test_on_server = 1: the iterators are not data-sharded across seq
    ranks, so both ranks print the same round lines - the JAX CLI's -
    and the checkpoints agree within the bar."""
    from cxxnet_tpu_torch.nnet import checkpoint
    from test_torch_parallel import ROUND, run_launch, write_idx
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "data"))
    write_idx(os.path.join(d, "data"), "train", 128, 3)
    write_idx(os.path.join(d, "data"), "t10k", 64, 4)
    conf = os.path.join(d, "seq.conf")
    with open(conf, "w") as f:
        f.write(CLI_DATA.format(d=d) + CLI_NET)
    jt = _jax_trainer(CLI_NET, "data:1,seq:2")
    with open(os.path.join(d, "init.model"), "wb") as f:
        jt.save_model(f)
    jout = run_launch("cxxnet_tpu", d, conf, f"{d}/jax",
                      ["mesh=data:1,seq:2"])
    pout = run_launch("cxxnet_tpu_torch", d, conf, f"{d}/port",
                      ["dev=cpu", "mesh=data:1,seq:2"])
    jr = sorted(set(ROUND.findall(jout.stderr)))
    pr = sorted(set(ROUND.findall(pout.stderr)))
    # one distinct line a round: both ranks print the same
    assert [r[0] for r in pr] == [r[0] for r in jr] == ["1", "2"], (pr, jr)
    assert pr == jr, (pr, jr)
    assert "diverge" not in pout.stderr
    for name in sorted(os.listdir(f"{d}/jax0")):
        with open(f"{d}/jax0/{name}", "rb") as f:
            want = checkpoint.load_model(f)["params"]
        with open(f"{d}/port0/{name}", "rb") as f:
            got = checkpoint.load_model(f)["params"]
        for lk in want:
            for pn in want[lk]:
                np.testing.assert_allclose(got[lk][pn], want[lk][pn],
                                           rtol=RTOL, atol=ATOL)
