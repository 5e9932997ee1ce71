"""The moe layer on a mesh and the expert axis of the port, held to the
JAX package (float32, CPU).

Port ranks - real processes joined over gloo by
cxxnet_tpu_torch.parallel.distributed - against the JAX trainer in this
process at the same mesh over the conftest's virtual CPU devices, from
one JAX checkpoint, for three steps (tests/test_seq_parallel.py's
run_seq): every rank's params bitwise equal to rank 0's and within the
JAX package's moe bar (rtol 2e-4 / atol 2e-5, tests/test_moe.py).

- The data axis: the JAX trainer computes the moe route on the global
  batch, so the load-balance term is the global product and the
  capacity route's C and arrival order are the global batch's; ranks
  that took them from their own rows leave it (the pin of the fault
  in ROADMAP's queue 3). Dense, and capacity with tokens dropped; the
  first shard's rows are shifted on 4 features, so the two shards route
  differently (as unshuffled shards do) and the per-shard products
  part from the global one.
- The expert axis: data:2,expert:2 dense and capacity, expert:3 (4
  experts do not split: the weights stay whole), seq:2,expert:2 on a
  stack_moe-like net with dropout (the JAX trainer's masks injected),
  model:2,expert:2;
  each rank holds E/n experts' w1 / w2 and the whole gate.
- The placements against the JAX package's helpers.
"""

import numpy as np
import pytest

from test_torch_seq_parallel import _jax_trainer, assert_held, run_seq

MOE_NET = """
netconfig=start
layer[0->1] = pos_embed:pe
layer[1->2] = transformer_stack:ts1
  nlayer = 2
  nhead = 2
  nhidden = 16
layer[2->3] = layernorm:lnf
layer[3->4] = moe:moe1
  nexpert = 4
  nhidden = 16
  moe_top_k = 2
  moe_aux = 0.01{extra}
layer[4->5] = flatten
{dropout}layer[5->6] = fullc:head
  nhidden = 4
layer[6->6] = softmax
netconfig=end
input_shape = 1,8,8
random_type = xavier
batch_size = 8
eta = 0.05
momentum = 0.9
"""

DROPOUT = "layer[5->5] = dropout\n  threshold = 0.2\n"

# capacity 0.5: C = ceil(2 * 64 / 4 * 0.5) = 16 slots an expert for the
# 64 tokens of the global batch, so the 4 experts' 64 slots hold at most
# half of its 128 (token, slot) pairs; a rank that counted its own 32
# tokens would keep 8 an expert and drop others
CAPACITY = "\n  moe_capacity = 0.5"


def moe_net(capacity=False, dropout=False) -> str:
    return MOE_NET.format(extra=CAPACITY if capacity else "",
                          dropout=DROPOUT if dropout else "")


@pytest.mark.parametrize("capacity", [False, True], ids=["dense", "capacity"])
def test_moe_on_a_data_mesh_matches_jax(tmp_path, capacity):
    """data:2 - the moe fault's pin: the load-balance statistics summed
    over the data group (and the capacity route's global C and order)
    hold the two ranks to the JAX trainer at data:2; then predict_dist
    of two eval batches (the capacity route's inference on the global
    batch) is the JAX trainer's for each rank's rows."""
    jt, jp, ports, reps = run_seq(tmp_path, moe_net(capacity), "data:2",
                                  (1, 8, 8), shift=1.0, evals=2)
    assert_held(jp, ports, reps)
    jpred = jt.jax_pred.reshape(2, 2, 4, -1)
    for rep in reps:
        d = rep["local"][1] // 4
        np.testing.assert_allclose(rep["pred"], jpred[:, d].reshape(8, -1),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("capacity", [False, True], ids=["dense", "capacity"])
def test_expert_parallel_matches_jax(tmp_path, capacity):
    """data:2,expert:2: each rank runs its 2 of 4 experts on its data
    index's rows; its w1 / w2 / b1 / b2 are 2 experts deep, the gate
    whole."""
    jt, jp, ports, reps = run_seq(tmp_path, moe_net(capacity),
                                  "data:2,expert:2", (1, 8, 8))
    assert_held(jp, ports, reps)
    for rep in reps:
        shapes = rep["shapes"]
        assert shapes["moe1/w1"] == [2, 16, 8]
        assert shapes["moe1/w2"] == [2, 8, 16]
        assert shapes["moe1/b1"] == [2, 16]
        assert shapes["moe1/gate"] == [4, 8]


def test_indivisible_expert_axis_replicates(tmp_path):
    """expert:3 with 4 experts: the expert weights stay whole on each of
    the three ranks (the JAX package's fallback), every rank feeds the
    whole batch (no data axis) and trains as the JAX trainer."""
    jt, jp, ports, reps = run_seq(tmp_path, moe_net(), "expert:3",
                                  (1, 8, 8))
    assert_held(jp, ports, reps)
    for rep in reps:
        assert rep["shapes"]["moe1/w1"] == [4, 16, 8]
        assert rep["local"] == [8, 0]


def test_seq_and_expert_axes_match_jax(tmp_path):
    """seq:2,expert:2 on the stack_moe-like net with dropout: the stack
    runs ring attention on each rank's sequence block, the network
    gathers the sequence before moe, whose experts split over the
    expert ranks."""
    jt, jp, ports, reps = run_seq(tmp_path, moe_net(dropout=True),
                                  "seq:2,expert:2", (1, 8, 8))
    assert_held(jp, ports, reps)
    for rep in reps:
        assert rep["ring_calls"]["ring"] == 3 * 2
        assert rep["shapes"]["moe1/w1"] == [2, 16, 8]


def test_model_and_expert_axes_match_jax(tmp_path):
    """model:2,expert:2: the head's fullc cut over 'model', moe's experts
    over 'expert', each rank on every row."""
    jt, jp, ports, reps = run_seq(tmp_path, moe_net(), "model:2,expert:2",
                                  (1, 8, 8))
    assert_held(jp, ports, reps)
    for rep in reps:
        assert rep["shapes"]["moe1/w1"] == [2, 16, 8]
        assert rep["shapes"]["head/wmat"] == [2, 64]


def test_expert_placements_match_jax():
    """shardings_for on data:2,expert:2 and data:2,expert:3 against the
    JAX trainer's placements: w1 / w2 / b1 / b2 on 'expert' where 4
    experts split, the gate replicated, everything whole at expert:3."""
    from cxxnet_tpu_torch.nnet.network import Network
    from cxxnet_tpu_torch.nnet.net_config import NetConfig
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    from cxxnet_tpu_torch.parallel.sharding import shardings_for
    from cxxnet_tpu_torch.utils.config import parse_config_string
    cfg = NetConfig()
    cfg.configure(parse_config_string(moe_net()))
    net = Network(cfg, 8)
    shapes = net.param_shapes()
    for mesh, n in (("data:2,expert:2", 2), ("data:2,expert:3", 3)):
        jt = _jax_trainer(moe_net(), mesh)
        got = shardings_for(Mesh((("data", 2), ("expert", n))), shapes, net)
        for lk, d in got.items():
            for pn, spec in d.items():
                want = tuple(jt._pshard[lk][pn].spec)
                while want and want[-1] is None:
                    want = want[:-1]
                assert spec == want, (mesh, lk, pn, spec, want)
        assert got["moe1"]["gate"] == ()
        assert got["moe1"]["w1"] == (("expert",) if n == 2 else ())


def test_zero2_on_an_expert_mesh_raises(tmp_path):
    """zero_stage = 2 at data:2,expert:2: every rank raises the JAX
    trainer's ValueError."""
    _, _, _, reps = run_seq(tmp_path, moe_net() + "zero_stage = 2\n",
                            "data:2,expert:2", (1, 8, 8), jax_cfg=moe_net(),
                            train=False)
    for rep in reps:
        assert "composes with 'data'/'model' mesh axes only; axes " \
               "['expert']" in rep["error"], rep
