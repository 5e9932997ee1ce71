"""The pipe mesh axis of the port held to the JAX package (float32, CPU).

Port ranks - real processes joined over gloo by
cxxnet_tpu_torch.parallel.distributed - against the JAX trainer in this
process at the same mesh over the conftest's virtual CPU devices, from
one JAX checkpoint, for three steps (tests/test_torch_seq_parallel.py's
run_seq), on tests/test_pipeline.py's net (a four-block causal
transformer_stack): pipe:4, data:2,pipe:2 at the default microbatch,
at microbatch = 4 and under shard_optimizer = 1, beside a model and
a seq axis, the pipe:3 fallback,
eval and predict on data:2,pipe:2, the microbatch refusal and the
checkpoint's bytes. Every rank's params bitwise equal to rank 0's and
within the JAX package's bar (rtol 3e-4 / atol 3e-5,
tests/test_pipeline.py); each stage holds its L/P stacked slices; the
schedule's hops are the microbatches' own (no idle tick is sent).
"""

import hashlib

import numpy as np
import pytest

from test_torch_distributed import eval_values
from test_torch_seq_parallel import _jax_trainer, assert_held, run_seq

RTOL, ATOL = 3e-4, 3e-5

STACK_NET = """
netconfig=start
layer[0->1] = transformer_stack:ts1
  nlayer = 4
  nhead = 2
  nhidden = 32
  causal = 1
  init_sigma = 0.05
layer[1->2] = flatten
layer[2->3] = fullc:head
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 1,8,16
random_type = gaussian
init_sigma = 0.05
eta = 0.05
momentum = 0.9
batch_size = 8
metric = error
"""


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _sizes(mesh: str) -> dict:
    return {a: int(n) for a, n in (p.split(":") for p in mesh.split(","))}


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """data:2,pipe:2 at the default microbatch, once for three tests: the
    three steps, then two eval batches (eval line, predict_dist, the
    stack's output node) and the checkpoints (the loaded init saved
    back, the trained one)."""
    d = tmp_path_factory.mktemp("data2_pipe2")
    return d, run_seq(d, STACK_NET + "microbatch = 0\n", "data:2,pipe:2",
                      (1, 8, 16), evals=2, extract="top[-3]", save=True,
                      save_init=True)


@pytest.mark.parametrize("mesh,extra", [
    ("pipe:4", "microbatch = 0"),
    ("data:2,pipe:2", "microbatch = 0"),
    ("data:2,pipe:2", "microbatch = 4"),
    ("data:2,pipe:2", "shard_optimizer = 1"),
])
def test_pipeline_matches_jax(request, tmp_path, mesh, extra):
    """The GPipe schedule over the pipe ranks trains as the JAX trainer
    at the same mesh; stage p holds its L/P slices of every stacked
    param; each step sends M microbatches down and M gradients up
    between neighbours, and broadcasts twice."""
    if (mesh, extra) == ("data:2,pipe:2", "microbatch = 0"):
        jt, jp, ports, reps = request.getfixturevalue("default_run")[1]
    else:
        jt, jp, ports, reps = run_seq(tmp_path, STACK_NET + extra + "\n",
                                      mesh, (1, 8, 16))
    assert_held(jp, ports, reps, rtol=RTOL, atol=ATOL)
    sizes = _sizes(mesh)
    P, nd = sizes["pipe"], sizes.get("data", 1)
    lb = 8 // nd
    M = int(extra.split("=")[1]) if extra.startswith("microbatch") else 0
    M = M or max(m for m in range(1, P + 1) if lb % m == 0)
    for r, rep in enumerate(reps):
        p = r % P
        assert rep["shapes"]["ts1/wqkv"] == [4 // P, 48, 16]
        assert rep["shapes"]["ts1/b2"] == [4 // P, 16]
        assert rep["shapes"]["head/wmat"] == [4, 128]
        down, up = 3 * M * (p < P - 1), 3 * M * (p > 0)
        assert rep["pipe_exchanges"] == {"send": down + up,
                                         "recv": down + up,
                                         "broadcast": 3 * 2}, (r, rep)
    if "shard_optimizer" in extra:
        whole = sum(a.nbytes for a in ports[0].values())
        assert all(rep["ustate_bytes"] < whole / P for rep in reps)


@pytest.mark.parametrize("mesh", ["model:2,pipe:2", "seq:2,pipe:2"])
def test_pipe_with_model_or_seq_matches_jax(tmp_path, mesh):
    """The pipe axis beside a model axis (the head's fullc cut over
    'model', the stack's params replicated over it) and beside a seq
    axis (the input cut over 'seq', gathered before the pipelined stack,
    whose attention runs per device): both as the JAX trainer."""
    jt, jp, ports, reps = run_seq(tmp_path, STACK_NET, mesh, (1, 8, 16))
    assert_held(jp, ports, reps, rtol=RTOL, atol=ATOL)
    for rep in reps:
        assert rep["shapes"]["ts1/wqkv"] == [2, 48, 16]
        assert rep["pipe_exchanges"]["broadcast"] == 3 * 2
        assert rep["ring_calls"]["ring"] == 0


def test_zero1_placement_matches_jax():
    """ZeRO-1 composes with the pipe axis: each weight's updater state
    is cut over 'data' on the first dim its pipe placement left free -
    ('pipe', 'data') on wqkv - as the JAX trainer's zero1_shardings."""
    from cxxnet_tpu.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.net_config import NetConfig
    from cxxnet_tpu_torch.nnet.network import Network
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    from cxxnet_tpu_torch.parallel.sharding import (
        shardings_for, zero_shardings)
    from cxxnet_tpu_torch.utils.config import parse_config_string
    cfg = STACK_NET + "shard_optimizer = 1\n"
    jt = _jax_trainer(cfg, "data:2,pipe:2")
    rng = np.random.RandomState(0)
    jt.update(DataBatch(data=rng.randn(8, 1, 8, 16).astype(np.float32),
                        label=rng.randint(0, 4, (8, 1)).astype(np.float32)))
    ncfg = NetConfig()
    ncfg.configure(parse_config_string(cfg))
    net = Network(ncfg, 8)
    shapes = net.param_shapes()
    mesh = Mesh((("data", 2), ("pipe", 2)))
    specs = shardings_for(mesh, shapes, net)
    got = zero_shardings(mesh, shapes, specs)
    assert got["ts1"]["wqkv"] == ("pipe", "data")
    for lk, d in got.items():
        for pn, spec in d.items():
            want = tuple(jt._ustate_shard[lk][pn].spec)
            while want and want[-1] is None:
                want = want[:-1]
            assert spec == want, (lk, pn, spec, want)
            want = tuple(jt._pshard[lk][pn].spec)
            while want and want[-1] is None:
                want = want[:-1]
            assert specs[lk][pn] == want, (lk, pn)


def test_indivisible_layers_fall_back(tmp_path):
    """pipe:3 with 4 layers: the stack runs the sequential route with
    its params whole on each of the three ranks (no data axis: each
    feeds the whole batch), and no stage hop is made."""
    jt, jp, ports, reps = run_seq(tmp_path, STACK_NET, "pipe:3", (1, 8, 16))
    assert_held(jp, ports, reps, rtol=RTOL, atol=ATOL)
    for rep in reps:
        assert rep["shapes"]["ts1/wqkv"] == [4, 48, 16]
        assert rep["local"] == [8, 0]
        assert rep["pipe_exchanges"] == {"send": 0, "recv": 0,
                                         "broadcast": 0}


def test_eval_and_predict_on_a_pipe_mesh(default_run):
    """data:2,pipe:2: after three steps the eval line, predict_dist and
    the stack's output node (extract_feature) on each rank are the JAX
    trainer's for the rows of its data index."""
    jt, jp, ports, reps = default_run[1]
    want = eval_values(jt.jax_eval)
    jpred = jt.jax_pred.reshape(2, 2, 4, -1)
    jx = jt.jax_extract.reshape((2, 2, 4) + jt.jax_extract.shape[1:])
    for rep in reps:
        got = eval_values(rep["eval"])
        np.testing.assert_allclose(got["test-error"], want["test-error"],
                                   atol=1e-6)
        d = rep["local"][1] // 4
        np.testing.assert_allclose(rep["pred"], jpred[:, d].reshape(8, -1),
                                   rtol=RTOL, atol=ATOL)
        assert rep["extract"].shape == (8, 1, 8, 16)
        np.testing.assert_allclose(
            rep["extract"], jx[:, d].reshape(rep["extract"].shape),
            rtol=RTOL, atol=ATOL)


def test_microbatch_refusal_matches_jax():
    """An explicit microbatch that does not divide the per-data-shard
    batch raises the JAX trainer's ValueError, word for word."""
    from cxxnet_tpu.io.data import DataBatch
    from cxxnet_tpu_torch.layers import create_layer
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    jt = _jax_trainer(STACK_NET + "microbatch = 3\n", "data:2,pipe:2")
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError) as jerr:
        jt.update(DataBatch(
            data=rng.randn(8, 1, 8, 16).astype(np.float32),
            label=rng.randint(0, 4, (8, 1)).astype(np.float32)))
    layer = create_layer("transformer_stack")
    for k, v in (("nlayer", "4"), ("microbatch", "3")):
        layer.set_param(k, v)
    with pytest.raises(ValueError) as perr:
        layer.microbatches(Mesh((("data", 2), ("pipe", 2))), 4, 2)
    assert str(perr.value) == str(jerr.value)
    assert "microbatch=3 does not divide the per-data-shard batch 4" \
        in str(perr.value)


def test_pipe_checkpoint_bytes(default_run, tmp_path):
    """At data:2,pipe:2 every rank saves the loaded JAX init back as the
    init file's bytes (the stages gathered whole), every rank's trained
    checkpoint is the same bytes, and a one-process port trainer that
    loads it saves the same bytes again."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    d, (jt, jp, ports, reps) = default_run
    init = sha256(str(d / "init.model"))
    assert {sha256(r["init_model"]) for r in reps} == {init}
    shas = {sha256(r["model"]) for r in reps}
    assert len(shas) == 1
    one = NetTrainer(device="cpu", cfg=STACK_NET + "silent = 1\n")
    with open(reps[0]["model"], "rb") as f:
        one.load_model(f)
    with open(tmp_path / "one.model", "wb") as f:
        one.save_model(f)
    assert sha256(str(tmp_path / "one.model")) in shas


def test_pipe_carries_a_jax_train_state(tmp_path):
    """A JAX train state at data:2,pipe:2 under shard_optimizer = 1
    (momentum after 2 updates) carried into four ranks
    (convert.train_state_from_numpy: each rank keeps its stage and its
    ZeRO-1 cut); after one more update every rank holds the JAX
    trainer's params and, gathered whole, its updater state."""
    import json
    import pickle
    import sys

    import jax
    from cxxnet_tpu.io.data import DataBatch
    from test_torch_distributed import make_batches, spawn
    from test_torch_zero import WORKER
    cfg = STACK_NET + "shard_optimizer = 1\n"
    jt = _jax_trainer(cfg, "data:2,pipe:2")
    pre = make_batches(str(tmp_path / "pre.npz"), (1, 8, 16), 4, 2, seed=7)
    for d, l in zip(*pre):
        jt.update(DataBatch(data=d, label=l))
    spec = {"cfg": cfg + "\nmesh = data:2,pipe:2\n",
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
    data, label = make_batches(spec["batches"], (1, 8, 16), 4, 1)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    res = spawn([sys.executable, str(script)], nproc=4,
                extra={"CXN_TEST_SPEC": json.dumps(spec)})
    for rc, out in res:
        assert rc == 0, out
    reps = [json.loads(out.strip().splitlines()[-1]) for _, out in res]
    jt.update(DataBatch(data=data[0], label=label[0]))
    ports = [dict(np.load(str(tmp_path / f"port.{r}.npz"))) for r in range(4)]
    assert_held(jax.device_get(jt.state["params"]), ports, reps, rtol=RTOL,
                atol=ATOL)
    ju = jax.device_get(jt.state["ustate"])
    for r in range(4):
        ust = dict(np.load(str(tmp_path / f"port.{r}.ustate.npz")))
        for key, a in ust.items():
            lk, pn, f = key.split("/")
            np.testing.assert_allclose(a, np.asarray(ju[lk][pn][f]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def test_zero2_on_a_pipe_mesh_raises(tmp_path):
    """zero_stage = 2 at data:2,pipe:2: every rank raises the JAX
    trainer's ValueError."""
    _, _, _, reps = run_seq(tmp_path, STACK_NET + "zero_stage = 2\n",
                            "data:2,pipe:2", (1, 8, 16), jax_cfg=STACK_NET,
                            train=False)
    for rep in reps:
        assert "composes with 'data'/'model' mesh axes only; axes " \
               "['pipe']" in rep["error"], rep
