"""Data parallelism of the port held to the JAX package (float32, CPU).

Two port ranks - two real processes joined over gloo by
cxxnet_tpu_torch.parallel.distributed, each feeding its contiguous half
of the global batch - against the JAX trainer in this process at
`mesh = data:2` over two of the conftest's virtual CPU devices. Both
start from one JAX checkpoint (the port loads the JAX package's native
format unchanged), see the same global batches (numpy, seeded) and take
3 updates. Bar: the two ranks bitwise equal to each other, and every
param within rtol 1e-5 / atol 1e-6 of the JAX trainer's.

Each worker has a free port, an init deadline and its own timeout, so a
hang fails the test instead of eating the suite.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
WORKER_TIMEOUT = 240

MLP = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 100
layer[1->2] = sigmoid:se1
layer[2->3] = fullc:fc2
  nhidden = 10
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,784
batch_size = 8
eta = 0.1
momentum = 0.9
wd = 0.0
random_type = gaussian
init_sigma = 0.01
"""

CONV_LRN = """
netconfig=start
layer[0->1] = conv:c1
  nchannel = 6
  kernel_size = 3
  pad = 1
layer[1->2] = relu
layer[2->3] = lrn
  local_size = 3
  alpha = 0.001
  beta = 0.75
layer[3->4] = max_pooling
  kernel_size = 2
  stride = 2
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 4
layer[6->6] = softmax
netconfig=end
input_shape = 3,8,8
batch_size = 8
eta = 0.05
momentum = 0.9
random_type = xavier
"""

ATTN = """
netconfig=start
layer[0->1] = pos_embed:pe
layer[1->2] = layernorm:ln1
layer[2->3] = attention:att1
  nhead = 2
  causal = 1
layer[3->4] = flatten
layer[4->5] = fullc:head
  nhidden = 4
layer[5->5] = softmax
netconfig=end
input_shape = 1,4,8
batch_size = 8
eta = 0.05
momentum = 0.9
random_type = xavier
"""

BN = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 12
layer[1->2] = batch_norm:bn1
  global_stats = {gs}
layer[2->3] = relu
layer[3->4] = fullc:fc2
  nhidden = 4
layer[4->4] = softmax
netconfig=end
input_shape = 1,1,10
batch_size = 8
eta = 0.1
momentum = 0.9
random_type = xavier
"""

SMALL_MLP = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 16
  fullc_gather = {fg}
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 8
eta = 0.1
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
out = convert.params_to_numpy(t.state["params"], t.net.param_shapes())
flat = {f"{lk}/{pn}": a for lk, d in out.items() for pn, a in d.items()}
np.savez(f"{spec['out']}.{rank}.npz", **flat)
report = {"rank": rank, "bad": t.check_weights(),
          "bad_rounds": t.bad_rounds, "epoch": t.epoch,
          "ustate_bytes": t.ustate_bytes()}
if spec.get("evals"):
    evals = mine(spec["evals"])
    report["eval"] = t.evaluate(Batches(evals), "test")
    np.save(f"{spec['out']}.{rank}.pred.npy",
            np.concatenate([t.predict_dist(b) for b in evals]))
if spec.get("export"):
    ust = convert.train_state_to_numpy(t)["ustate"]
    np.savez(f"{spec['out']}.{rank}.ustate.npz",
             **{f"{lk}/{pn}/{f}": a for lk, d in ust.items()
                for pn, st in d.items() for f, a in st.items()})
print(json.dumps(report), flush=True)
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(rank: int, nproc: int, port: int, extra=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "CXN_LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, CXN_COORDINATOR=f"127.0.0.1:{port}",
               CXN_NUM_WORKER=str(nproc), CXN_WORKER_RANK=str(rank),
               CXN_TEST_REPO=REPO, OMP_NUM_THREADS="1")
    env.update(extra or {})
    return env


def spawn(argv, nproc=2, extra=None, timeout=WORKER_TIMEOUT, cwd=None):
    """Start nproc port workers joined at a free port; their (returncode,
    output) pairs. Survivors are killed when one times out (a dead peer
    leaves the other blocked in a collective)."""
    port = free_port()
    procs = [subprocess.Popen(argv, env=worker_env(r, nproc, port, extra),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=cwd)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def make_batches(path, shape, nclass, steps, nan_at=None, seed=42):
    """`steps` global batches of 8 (numpy, seeded); batch `nan_at` gets
    NaN rows in its second half - rank 1's rows."""
    rng = np.random.RandomState(seed)
    data = rng.randn(steps, 8, *shape).astype(np.float32)
    label = rng.randint(0, nclass, size=(steps, 8, 1)).astype(np.float32)
    if nan_at is not None:
        data[nan_at, 4:] = np.nan
    np.savez(path, data=data, label=label)
    return data, label


def jax_trainer(cfg: str):
    from cxxnet_tpu.nnet.trainer import NetTrainer
    from cxxnet_tpu.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(cfg + "\nsilent = 1\n"):
        t.set_param(k, v)
    t.set_param("mesh", "data:2")
    t.init_model()
    return t


class Batches:
    """The eval iterator over a list of batches (before_first / next /
    value)."""

    def __init__(self, batches):
        self.batches, self.i = batches, -1

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < len(self.batches)

    def value(self):
        return self.batches[self.i]


def eval_values(line: str) -> dict:
    """`\\ttest-error:0.5\\ttest-logloss:1.2` -> {name: float}."""
    return {k: float(v) for k, v in
            (part.split(":") for part in line.strip("\t").split("\t"))}


def run_pair(tmp_path, cfg, shape, nclass=4, steps=3, chunk=1,
             nan_at=None, evals=0, carry=0, export=False):
    """(JAX trainer after `steps` updates, port params per rank, port
    worker reports). `carry` > 0: the JAX trainer first takes `carry`
    updates of its own, and the ranks start from its whole train state
    (convert.train_state_from_numpy). `evals` > 0: then both evaluate and
    predict_dist that many global batches (each report's "eval" line
    and "pred" rows). `export`: each report's "ustate" is the port's
    whole updater state (convert.train_state_to_numpy)."""
    import pickle

    import jax
    from cxxnet_tpu.io.data import DataBatch
    jt = jax_trainer(cfg)
    spec = {"cfg": cfg, "init": str(tmp_path / "init.model"),
            "batches": str(tmp_path / "batches.npz"),
            "chunk": chunk, "out": str(tmp_path / "port")}
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
    spec["export"] = export
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    res = spawn([sys.executable, str(script)],
                extra={"CXN_TEST_SPEC": json.dumps(spec)})
    for rc, out in res:
        assert rc == 0, out
    reports = [json.loads(out.strip().splitlines()[-1]) for _, out in res]
    for d, l in zip(data, label):
        jt.update(DataBatch(data=d, label=l))
    jparams = jax.device_get(jt.state["params"])
    ports = [dict(np.load(str(tmp_path / f"port.{r}.npz"))) for r in (0, 1)]
    for r, rep in enumerate(reports):
        if evals:
            rep["pred"] = np.load(str(tmp_path / f"port.{r}.pred.npy"))
        if export:
            rep["ustate"] = dict(np.load(str(tmp_path /
                                             f"port.{r}.ustate.npz")))
    if evals:
        ebatches = [DataBatch(data=d, label=l) for d, l in zip(edata, elabel)]
        jt.jax_eval = jt.evaluate(Batches(ebatches), "test")
        jt.jax_pred = np.concatenate([jt.predict_dist(b) for b in ebatches])
    return jt, jparams, ports, reports


def assert_eval_held(jt, reports):
    """Both ranks print the JAX trainer's eval line (the sums over the
    ranks) and predict the JAX trainer's rows of each global batch."""
    want = eval_values(jt.jax_eval)
    for rep in reports:
        got = eval_values(rep["eval"])
        assert got.keys() == want.keys(), (rep["eval"], jt.jax_eval)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    lb = jt.batch_size // 2
    jp = jt.jax_pred.reshape(-1, 2, lb, jt.jax_pred.shape[-1])
    for r, rep in enumerate(reports):
        np.testing.assert_allclose(
            rep["pred"], jp[:, r].reshape(-1, jp.shape[-1]), rtol=RTOL,
            atol=ATOL)


def assert_held(jparams, ports, reports):
    for rep in reports:
        assert rep["bad"] == [], rep
    assert ports[0].keys() == ports[1].keys()
    for key in ports[0]:
        np.testing.assert_array_equal(ports[0][key], ports[1][key],
                                      err_msg=key)
        lk, pn = key.split("/")
        np.testing.assert_allclose(ports[0][key], np.asarray(jparams[lk][pn]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("uos", ["0", "1"])
def test_dist_conf_mlp_matches_jax(tmp_path, uos):
    """examples/MNIST/dist.conf's MLP at update_on_server = 0 / 1
    (ZeRO-1: each rank keeps half of each cut weight's updater state)."""
    cfg = MLP + f"update_on_server = {uos}\n"
    _, jp, ports, reps = run_pair(tmp_path, cfg, (1, 1, 784), nclass=10)
    assert_held(jp, ports, reps)
    full = 4 * (100 * 784 + 100 + 10 * 100 + 10)
    want = full if uos == "0" else full // 2
    assert [r["ustate_bytes"] for r in reps] == [want, want]


def test_conv_lrn_net_matches_jax(tmp_path):
    """conv + LRN + pool: the port of the JAX package's sharded LRN
    route, the LRN on each rank's own rows."""
    _, jp, ports, reps = run_pair(tmp_path, CONV_LRN, (3, 8, 8))
    assert_held(jp, ports, reps)


def test_attention_net_matches_jax(tmp_path):
    """The port of the attention core's sharded route: flash attention
    on each rank's own rows (K2's plain versions here)."""
    _, jp, ports, reps = run_pair(tmp_path, ATTN, (1, 4, 8))
    assert_held(jp, ports, reps)


@pytest.mark.parametrize("gs", ["0", "1"])
def test_batch_norm_matches_jax(tmp_path, gs):
    """Per-shard statistics (global_stats = 0) and sync-BN (1), in
    training and then in evaluate's eval lines and predict_dist's rows:
    the eval and inference forwards run under the data mesh too, so
    sync-BN normalizes the ranks' eval rows with the global batch's
    statistics, as the JAX trainer's eval does."""
    cfg = BN.format(gs=gs) + "metric = logloss\nmetric = error\n"
    jt, jp, ports, reps = run_pair(tmp_path, cfg, (1, 1, 10), evals=2)
    assert_held(jp, ports, reps)
    assert_eval_held(jt, reps)


@pytest.mark.parametrize("gs", ["0", "1"])
def test_fold_calibration_matches_jax(tmp_path, gs):
    """graph_passes = fold_conv_bn on a data mesh: predict calibrates the
    folded batch_norm from the global batch's moments (all-reduced over
    the ranks), as the JAX package calibrates on its globally sharded
    batch, so each rank's folded rows are the JAX trainer's."""
    cfg = (BN.format(gs=gs) + "metric = logloss\n"
           "graph_passes = fold_conv_bn\n")
    jt, jp, ports, reps = run_pair(tmp_path, cfg, (1, 1, 10), evals=2)
    assert_held(jp, ports, reps)
    assert_eval_held(jt, reps)


def test_zero1_carries_a_jax_train_state(tmp_path):
    """update_on_server = 1: the JAX trainer's whole train state (its
    momentum after 2 updates) carried into two ZeRO-1 ranks, each
    keeping its slice; after 3 more updates the params and the whole
    updater state, gathered back by convert.train_state_to_numpy, are
    the JAX trainer's."""
    import jax
    cfg = SMALL_MLP.format(fg=0) + "update_on_server = 1\n"
    jt, jp, ports, reps = run_pair(tmp_path, cfg, (1, 1, 8), carry=2,
                                   export=True)
    assert_held(jp, ports, reps)
    full = 4 * (16 * 8 + 16 + 4 * 16 + 4)
    assert [r["ustate_bytes"] for r in reps] == [full // 2] * 2
    ju = jax.device_get(jt.state["ustate"])
    for rep in reps:
        keys = {f"{lk}/{pn}/{f}" for lk, d in ju.items()
                for pn, st in d.items() for f in st}
        assert set(rep["ustate"]) == keys
        for key, a in rep["ustate"].items():
            lk, pn, f = key.split("/")
            np.testing.assert_allclose(a, np.asarray(ju[lk][pn][f]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def test_fullc_gather_matches_jax(tmp_path):
    """fullc_gather = 1: fc1's dw from gathered activations, left out of
    the gradient all-reduce."""
    _, jp, ports, reps = run_pair(tmp_path, SMALL_MLP.format(fg=1),
                                  (1, 1, 8))
    assert_held(jp, ports, reps)


def test_update_period_matches_jax(tmp_path):
    """update_period = 2: 6 microsteps, 3 updates."""
    cfg = SMALL_MLP.format(fg=0) + "update_period = 2\n"
    jt, jp, ports, reps = run_pair(tmp_path, cfg, (1, 1, 8), steps=6)
    assert_held(jp, ports, reps)
    assert [r["epoch"] for r in reps] == [3, 3]


def test_steps_per_dispatch_matches_jax(tmp_path):
    """steps_per_dispatch = 2: the ranks train 4 batches as 2 fused
    chunks; the JAX trainer streams them."""
    cfg = SMALL_MLP.format(fg=0) + "steps_per_dispatch = 2\n"
    _, jp, ports, reps = run_pair(tmp_path, cfg, (1, 1, 8), steps=4,
                                  chunk=2)
    assert_held(jp, ports, reps)


def test_check_nan_skip_matches_jax(tmp_path):
    """check_nan = 1 with NaN rows on rank 1 only: the decision comes
    after the reduce, so BOTH ranks drop the step, as the JAX trainer
    drops it."""
    cfg = SMALL_MLP.format(fg=0) + "check_nan = 1\n"
    jt, jp, ports, reps = run_pair(tmp_path, cfg, (1, 1, 8), steps=4,
                                   nan_at=1)
    assert_held(jp, ports, reps)
    assert jt.bad_rounds == 1
    assert [r["bad_rounds"] for r in reps] == [1, 1]
    assert [r["epoch"] for r in reps] == [3, 3]


def test_dropout_draws_equal_one_process(tmp_path):
    """A random layer on a data mesh draws the global batch's draw and
    takes its rows (layers/base.py rank_rand): two ranks with dropout
    train as one port process of the same seed does, within the bar."""
    from cxxnet_tpu_torch import convert
    from cxxnet_tpu_torch.io.data import DataBatch as PortBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer as PortTrainer
    cfg = SMALL_MLP.format(fg=0).replace(
        "layer[1->2] = relu\n",
        "layer[1->2] = relu\nlayer[2->2] = dropout\n  threshold = 0.5\n")
    one = PortTrainer(device="cpu", cfg=cfg + "silent = 1\n")
    one.init_model()
    init = str(tmp_path / "init.model")
    with open(init, "wb") as f:
        one.save_model(f)
    data, label = make_batches(str(tmp_path / "batches.npz"), (1, 1, 8), 4,
                               3)
    for d, l in zip(data, label):
        one.update(PortBatch(data=d, label=l))
    want = convert.params_to_numpy(one.state["params"],
                                   one.net.param_shapes())
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    spec = {"cfg": cfg, "init": init, "chunk": 1,
            "batches": str(tmp_path / "batches.npz"),
            "out": str(tmp_path / "port")}
    res = spawn([sys.executable, str(script)],
                extra={"CXN_TEST_SPEC": json.dumps(spec)})
    for rc, out in res:
        assert rc == 0, out
    ports = [dict(np.load(str(tmp_path / f"port.{r}.npz"))) for r in (0, 1)]
    reps = [json.loads(out.strip().splitlines()[-1]) for _, out in res]
    assert_held(want, ports, reps)


SLOW_TEARDOWN = r"""
import os, sys, time
sys.path.insert(0, os.environ["CXN_TEST_REPO"])
import torch
import torch.distributed as dist
from cxxnet_tpu_torch.parallel import distributed

distributed.init_distributed(deadline=60)
distributed.all_reduce_(torch.ones(4))
if distributed.process_index() == int(os.environ["CXN_SLOW_RANK"]):
    real = dist.destroy_process_group

    def slow(*a, **k):
        # a teardown that takes its time: the exit order must keep the
        # store up until it is done
        time.sleep(float(os.environ["CXN_SLOW_SECS"]))
        return real(*a, **k)

    dist.destroy_process_group = slow
print("ranks joined", flush=True)
"""


@pytest.mark.parametrize("slow_rank", [0, 1])
def test_exit_waits_for_a_slow_teardown(tmp_path, slow_rank):
    """At exit every peer drops its process group before it checks out
    at the store, and rank 0 (which serves the store) leaves only after
    every peer checked out: a rank whose teardown takes a second still
    exits 0, whichever rank it is."""
    script = tmp_path / "slow.py"
    script.write_text(SLOW_TEARDOWN)
    res = spawn([sys.executable, str(script)], timeout=120,
                extra={"CXN_SLOW_RANK": str(slow_rank),
                       "CXN_SLOW_SECS": "1.0"})
    for rc, out in res:
        assert rc == 0, out
        assert "ranks joined" in out
        assert "terminate called" not in out, out
