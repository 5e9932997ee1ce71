"""The model axis (tensor parallelism) of the port held to the JAX
package (float32, CPU).

Port ranks joined over gloo at `mesh = model:2` (two ranks on the same
rows, each holding its block of every cut weight) or `data:2,model:2`
(four ranks) against the JAX trainer at the same mesh over the
conftest's virtual CPU devices, from one JAX checkpoint and the same
global batches. Bar: every rank's whole params (gathered over the model
cut) bitwise equal across the ranks and within rtol 1e-5 / atol 1e-6
of the JAX trainer's; eval lines and predictions likewise. Cases: the
JAX suite's CONV_NET (conv, batch_norm, prelu, two fullc), an attention
net whose heads split over the ranks and one whose heads do not
(nhead % 2 != 0: every rank runs every head), a grouped conv whose
channel blocks straddle a group boundary, ZeRO-3 on data:2,model:2,
the model-axis checkpoint's bytes and a JAX train state carried in.
"""

import numpy as np
import pytest

from test_torch_distributed import ATOL, RTOL
from test_torch_zero import (
    ATTN_TP, CONV_NET, assert_eval_held, assert_held, run_mesh, sha256)

EVAL = "metric = logloss\nmetric = error\n"


@pytest.mark.parametrize("mesh,gs", [("model:2", 0), ("data:2,model:2", 0),
                                     ("data:2,model:2", 1)])
def test_conv_net_matches_jax(tmp_path, mesh, gs):
    """CONV_NET with every param cut over 'model': training, the eval
    line and predict_dist equal the JAX trainer's at the same mesh; the
    column-parallel layers close with one gather each (enter/gather
    pairs), batch_norm normalises its block of channels - with
    global_stats = 1 (sync-BN) over the data group only."""
    cfg = CONV_NET.replace("layer[3->4] = batch_norm:bn1\n",
                           "layer[3->4] = batch_norm:bn1\n"
                           f"  global_stats = {gs}\n")
    jt, jp, ports, reps = run_mesh(tmp_path, cfg + EVAL, mesh,
                                   (3, 8, 8), evals=2)
    assert_held(jp, ports, reps)
    assert_eval_held(jt, reps)
    for rep in reps:
        calls = rep["tp_calls"]
        assert calls["enter"] == calls["gather"] > 0
        assert calls["reduce"] == 0
    # each rank holds half of every cut param (all of CONV_NET's)
    whole = sum(a.nbytes for a in ports[0].values())
    assert reps[0]["state_bytes"]["params"] == whole // 2


@pytest.mark.parametrize("nhead,e", [(2, 8), (3, 6)])
def test_attention_net_matches_jax(tmp_path, nhead, e):
    """attention at model:2: the qkv block's product gathered, the
    rank's heads (nhead = 2: one each) or every head (nhead = 3) through
    the core, the row-parallel projection closed by one all-reduce;
    seq_fullc column parallel."""
    cfg = ATTN_TP.format(nhead=nhead, e=e)
    jt, jp, ports, reps = run_mesh(tmp_path, cfg, "model:2", (1, 4, e))
    assert_held(jp, ports, reps)
    for rep in reps:
        assert rep["tp_calls"]["reduce"] == 3


GROUPED = """
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = {o}
  ngroup = {g}
layer[1->2] = relu
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 4
layer[4->4] = softmax
netconfig=end
input_shape = 6,4,4
random_type = xavier
eta = 0.1
momentum = 0.9
batch_size = 8
"""


@pytest.mark.parametrize("o,g", [(12, 3), (8, 2)])
def test_grouped_conv_straddling_groups_matches_jax(tmp_path, o, g):
    """nchannel 12 in 3 groups at model:2: each rank's 6 channels cover
    one whole group and half of another, so the local conv runs per
    group piece against each piece's own input channels. nchannel 8 in
    2 groups (AlexNet's conv2/4/5 at model:2): each rank's block is one
    whole group, one conv over that group's input channels."""
    jt, jp, ports, reps = run_mesh(tmp_path, GROUPED.format(o=o, g=g),
                                   "model:2", (6, 4, 4))
    assert_held(jp, ports, reps)


def test_zero3_on_data_and_model_axes_matches_jax(tmp_path):
    """zero_stage = 3 at data:2,model:2 (four ranks): the ZeRO cut on a
    dim the model placement left alone, the model shards reduce-
    scattered over their data group."""
    cfg = CONV_NET + "zero_stage = 3\n"
    jt, jp, ports, reps = run_mesh(tmp_path, cfg, "data:2,model:2",
                                   (3, 8, 8))
    assert_held(jp, ports, reps)
    assert all(rep["reduce_scatters"] == 3 for rep in reps)


def test_model_axis_checkpoint_bytes(tmp_path):
    """At model:2 a save gathers the model cut: the loaded JAX init
    saved back is the init file's bytes on both ranks, and the trained
    checkpoint loads in the JAX package to the JAX trainer's params."""
    from cxxnet_tpu.nnet import checkpoint as jckpt
    jt, jp, ports, reps = run_mesh(tmp_path, CONV_NET, "model:2",
                                   (3, 8, 8), save=True, save_init=True)
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


def test_model_axis_carries_a_jax_train_state(tmp_path):
    """A JAX train state at model:2 (momentum after 2 updates) carried
    into two model ranks through convert.train_state_from_numpy: each
    keeps its blocks; after 3 more updates the whole updater state,
    gathered by convert.train_state_to_numpy, is the JAX trainer's."""
    import jax
    jt, jp, ports, reps = run_mesh(tmp_path, CONV_NET, "model:2",
                                   (3, 8, 8), carry=2, export=True,
                                   weights=("fc1", "wmat"))
    assert_held(jp, ports, reps)
    ju = jax.device_get(jt.state["ustate"])
    for rep in reps:
        assert rep["weight_shape"] == [32, 128]
        assert rep["set_weight_ok"] and rep["bad_after_set"] == []
        for key, a in rep["ustate"].items():
            lk, pn, f = key.split("/")
            np.testing.assert_allclose(a, np.asarray(ju[lk][pn][f]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def _cli(d, conf, n, extra):
    """The port's CLI on `conf` as n ranks under launch_dist; its
    stderr and the last checkpoint's params."""
    import os
    import subprocess
    import sys
    from cxxnet_tpu_torch.nnet import checkpoint
    from test_torch_distributed import free_port, worker_env
    env = worker_env(0, 1, 0)
    for k in ("CXN_COORDINATOR", "CXN_NUM_WORKER", "CXN_WORKER_RANK"):
        env.pop(k)
    mdir = os.path.join(d, f"models_n{n}")
    out = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.launch_dist", "-n",
         str(n), "--coordinator", f"127.0.0.1:{free_port()}", "--",
         sys.executable, "-m", "cxxnet_tpu_torch.main", conf, "dev=cpu",
         f"model_in={d}/init.model", f"model_dir={mdir}", "silent=1",
         *extra], env=env, cwd=d, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    with open(os.path.join(mdir, "0002.model"), "rb") as f:
        return out.stderr, checkpoint.load_model(f)["params"]


def test_cli_ranks_of_one_replica_read_its_rows(tmp_path):
    """examples/MNIST/dist.conf (batch 20, 2 rounds) through the CLI as
    four ranks at mesh = data:2,model:2 under zero_stage = 3 against two
    ranks at data:2: the iterators shard by the data index, so the two
    model ranks of a replica read its rows and the job trains as the
    two-rank one - the same round lines, checkpoints within the bar."""
    import os
    from test_torch_parallel import ROUND, dist_conf, write_idx
    from test_torch_zero import jax_trainer
    from test_torch_distributed import MLP
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "data"))
    write_idx(os.path.join(d, "data"), "train", 160, 3)
    write_idx(os.path.join(d, "data"), "t10k", 80, 4)
    conf = dist_conf(d)
    jt = jax_trainer(MLP.replace("batch_size = 8", "batch_size = 20"),
                     "data:2")
    with open(os.path.join(d, "init.model"), "wb") as f:
        jt.save_model(f)
    err2, p2 = _cli(d, conf, 2, ["mesh=data:2"])
    err4, p4 = _cli(d, conf, 4, ["mesh=data:2,model:2", "zero_stage=3"])
    r2, r4 = sorted(set(ROUND.findall(err2))), sorted(set(ROUND.findall(err4)))
    assert [r[0] for r in r2] == [r[0] for r in r4] == ["1", "2"]
    for a, b in zip(r2, r4):
        np.testing.assert_allclose([float(v) for v in a[1:]],
                                   [float(v) for v in b[1:]], atol=1e-6)
    for lk, dd in p2.items():
        for pn, a in dd.items():
            np.testing.assert_allclose(p4[lk][pn], a, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{lk}/{pn}")
