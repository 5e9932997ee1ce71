"""The port's graph passes (cxxnet_tpu_torch/nnet/passes.py) and the
trainer paths they drive, against the JAX package on the CPU.

- Every pass, alone and in pipelines, turns the confs of the JAX
  package's pass tests (tests/test_graph_passes.py,
  test_relay_passes.py, test_quantize.py), a narrowed AlexNet and the
  benchmark's BN MLP into the same transformed graph in both packages:
  layers, nindex_in/out, layercfg stamps, param_keys, sites, dtype_plan
  and log, line for line (the calibration statistics are the same
  numbers handed to both).
- The slice as a whole: NetTrainer of both packages from one set of
  weights (carried with convert.py) under the int8 serving passes and the
  benchmark's int8 pair - frozen scales, int8 weights, predict_dist,
  batch_norm's short-batch rows, calibration, checkpoints, set_weight,
  the `layer_quant = float` pin, the uncalibrated Server, an autocast
  bfloat16 training step - and the port's CLI.

Tolerances are stated where they are used."""

import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet import passes as JP
from cxxnet_tpu.nnet.net_config import NetConfig as JaxNetConfig
from cxxnet_tpu.nnet.network import param_key as jax_param_key
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch import convert, kernels
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet import passes as PP
from cxxnet_tpu_torch.nnet.net_config import NetConfig as PortNetConfig
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Server
from test_graph_passes import BN_CONV_CONF
from test_graph_passes import BN_MLP_CONF as FOLD_MLP_CONF
from test_quantize import BN_MLP_CONF as QUANT_MLP_CONF
from test_relay_passes import (ACT_CONF, CSE_CONF, CSE_DISTINCT_CONF,
                               FOLD_MERGE_CONF, MERGE_CONF)
from torch_port_util import NARROW_ALEXNET, carry

INT8_SERVING = ("graph_passes = dead_layer_elim,elim_reshape,fuse_activation,"
            "quantize_int8\n")
FOLD = "graph_passes = dead_layer_elim,fold_conv_bn,fuse_activation"

# bench.py's _INT8_MLP_CONF (the JAX package's int8 workload) at a
# quarter of its width: 2048 -> 64 hidden, 512 -> 32 inputs
INT8_MLP_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 64
  init_sigma = 0.05
layer[+1:bn1] = batch_norm:bn1
layer[+1:r1] = relu
layer[+1:fc2] = fullc:fc2
  nhidden = 64
  init_sigma = 0.05
layer[+1:bn2] = batch_norm:bn2
layer[+1:r2] = relu
layer[+1:fc3] = fullc:fc3
  nhidden = 10
  init_sigma = 0.05
layer[+0] = softmax
netconfig=end
input_shape = 1,1,32
dev = cpu
eta = 0.1
silent = 1
seed = 19
batch_size = 16
"""

# a pinned layer on each axis: fc2 stays float under quantize_int8,
# the relu pinned float32 under autocast
PINNED_CONF = ACT_CONF.replace(
    "layer[+1:fc2] = fullc:fc2\n",
    "layer[+1:fc2] = fullc:fc2\n  layer_quant = float\n").replace(
    "layer[+1:r1] = relu\n", "layer[+1:r1] = relu\n  layer_dtype = float32\n")

CONFS = {
    "fold_mlp": FOLD_MLP_CONF, "bn_conv": BN_CONV_CONF,
    "quant_mlp": QUANT_MLP_CONF, "act": ACT_CONF, "merge": MERGE_CONF,
    "fold_merge": FOLD_MERGE_CONF, "cse": CSE_CONF,
    "cse_distinct": CSE_DISTINCT_CONF, "alexnet": NARROW_ALEXNET,
    "int8_mlp": INT8_MLP_CONF, "pinned": PINNED_CONF,
}

SPECS = ["all", "space_to_depth", "autocast", "dead_layer_elim",
         "elim_reshape", "cse_share", "fold_conv_bn", "merge_conv_1x1",
         "fuse_activation", "quantize_int8",
         "dead_layer_elim,elim_reshape,fuse_activation,quantize_int8",
         "fold_conv_bn,merge_conv_1x1,fuse_activation,quantize_int8"]


# ---------------------------------------------------------------------------
# the transformed graph, line for line
# ---------------------------------------------------------------------------

def _stats(cfg, pkg_key):
    """The same made-up calibration statistics for both packages: per
    fold site (mean, rstd) of 3 channels, per quant site an absmax."""
    fold = {}
    for n, (_i, j) in enumerate(JP.find_fold_sites(cfg)):
        r = np.random.RandomState(n)
        fold[pkg_key(cfg, j)] = (r.randn(3).astype(np.float32),
                                 r.rand(3).astype(np.float32) + 0.5)
    quant = {pkg_key(cfg, q): 0.25 + 0.37 * n
             for n, q in enumerate(JP.find_quant_sites(cfg))}
    return fold, quant


def _run(pkg, conf, spec, dtype, calibrated, target=None):
    """(graph-stage GraphModule, infer-stage GraphModule) as the
    trainer builds them: graph passes on the live config, infer passes
    on a clone stamped with the graph-stage plan."""
    if pkg == "jax":
        cfg_cls, mod, d = JaxNetConfig, JP, {"float32": jnp.float32,
                                             "bfloat16": jnp.bfloat16}
    else:
        cfg_cls, mod, d = PortNetConfig, PP, {"float32": torch.float32,
                                              "bfloat16": torch.bfloat16}
    cfg = cfg_cls()
    cfg.configure(parse_config_string(conf))
    jcfg = JaxNetConfig()
    jcfg.configure(parse_config_string(conf))
    fold, quant = _stats(jcfg, jax_param_key) if calibrated else (None,
                                                                  None)
    pl = mod.PassPipeline.from_config(spec)
    gm = pl.run_graph(mod.GraphModule.from_net_config(cfg, 8, d[dtype]))
    gm2 = mod.GraphModule.from_net_config(cfg.clone(), 8, d[dtype])
    gm2.dtype_plan = dict(gm.dtype_plan)
    node = cfg.num_nodes - 1 if target is None else target
    gm2 = pl.run_infer(gm2, mod.PassContext(
        target_node=node, fold_stats=fold, quant_stats=quant))
    return gm, gm2


def _summary(gm):
    def name(dt):
        return jnp.dtype(dt).name if not isinstance(dt, torch.dtype) \
            else PP.dtype_name(dt)
    return {
        "layers": [(li.type_name, li.primary_layer_index, li.name,
                    list(li.nindex_in), list(li.nindex_out))
                   for li in gm.cfg.layers],
        "layercfg": [list(c) for c in gm.cfg.layercfg],
        "param_keys": list(gm.param_keys),
        "param_map": gm.param_map(),
        "folds": [(f.conv_key, f.bn_key, f.mean.tolist(), f.rstd.tolist())
                  for f in gm.folds],
        "merges": [(m.first_key, m.second_key) for m in gm.merges],
        "act_fuses": [(a.producer_key, list(a.bias_keys))
                      for a in gm.act_fuses],
        "quants": [(q.key, q.act_scale) for q in gm.quants],
        "dtype_plan": {i: name(dt) for i, dt in gm.dtype_plan.items()},
        "log": list(gm.log),
    }


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_every_pass_gives_the_jax_graph(conf, spec):
    """Calibrated, float32: the graph stage and the infer stage."""
    for a, b in zip(_run("jax", CONFS[conf], spec, "float32", True),
                    _run("port", CONFS[conf], spec, "float32", True)):
        assert _summary(b) == _summary(a)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("calibrated", [False, True])
def test_all_passes_bf16_and_deferred_give_the_jax_graph(conf, calibrated):
    """`all` under bfloat16 (the autocast plan stamped) and uncalibrated
    (fold and quant sites deferred, logged)."""
    for a, b in zip(_run("jax", CONFS[conf], "all", "bfloat16", calibrated),
                    _run("port", CONFS[conf], "all", "bfloat16",
                         calibrated)):
        assert _summary(b) == _summary(a)


def test_intermediate_target_gives_the_jax_graph():
    """dead_layer_elim / elim_reshape / fuse_activation toward an
    intermediate node of the narrowed AlexNet (fc6's output)."""
    cfg = JaxNetConfig()
    cfg.configure(parse_config_string(NARROW_ALEXNET))
    node = cfg.node_name_map["17"]
    for a, b in zip(_run("jax", NARROW_ALEXNET, "all", "float32", True,
                         node),
                    _run("port", NARROW_ALEXNET, "all", "float32", True,
                         node)):
        assert _summary(b) == _summary(a)


def test_pipeline_names_order_toggles_and_did_you_mean():
    for spec, toggles in [("fold_conv_bn,space_to_depth", None),
                          ("all", {"quantize_int8": 0}),
                          ("none", {"quantize_int8": 1}), ("0", None),
                          ("off", None), ("", {"cse_share": 1})]:
        assert (PP.PassPipeline.from_config(spec, toggles).names()
                == JP.PassPipeline.from_config(spec, toggles).names())
    assert PP._CANONICAL_ORDER == JP._CANONICAL_ORDER
    assert sorted(PP.PASS_REGISTRY) == sorted(JP.PASS_REGISTRY)
    for bad in ("fold_conv", "quantise_int8", "nope"):
        with pytest.raises(ValueError) as pe:
            PP.resolve_pass_name(bad)
        with pytest.raises(ValueError) as je:
            JP.resolve_pass_name(bad)
        assert str(pe.value) == str(je.value)


def test_trainer_rejects_a_typo_pass_name():
    tr = NetTrainer(cfg=FOLD_MLP_CONF + "graph_passes = fold_conv\n",
                    device="cpu")
    with pytest.raises(ValueError, match="did you mean 'fold_conv_bn'"):
        tr.init_model()
    tr = NetTrainer(cfg=FOLD_MLP_CONF + "pass_quantize_int9 = 1\n",
                    device="cpu")
    with pytest.raises(ValueError, match="quantize_int8"):
        tr.init_model()


# ---------------------------------------------------------------------------
# the slice as a whole: NetTrainer of both packages
# ---------------------------------------------------------------------------

def _pair(conf):
    jt = JaxTrainer()
    for k, v in parse_config_string(conf):
        jt.set_param(k, v)
    jt.init_model()
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    carry(jt, pt)
    return jt, pt


def _batch(shape, n, seed, lo=-1.0):
    r = np.random.RandomState(seed)
    data = (r.rand(n, *shape) * (1.0 - lo) + lo).astype(np.float32)
    label = r.randint(0, 3, (n, 1)).astype(np.float32)
    return JaxBatch(data=data, label=label), DataBatch(data=data,
                                                       label=label)


def _inject_quant_stats(jt, pt):
    """Hand the port the JAX package's activation ranges (the two
    packages' float32 convolutions may differ in the last bit, and an
    absmax with them)."""
    epoch = pt._fold_epoch
    fold, _quant = pt.calibration()
    pt.set_calibration(fold, jt._quant_stats)
    assert pt._fold_epoch == epoch + 1 and pt.calibration()[1] == dict(
        jt._quant_stats)


def _np(t):
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype not in (np.int8, np.float32) \
        else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_alexnet_int8_slice_matches_jax(dtype):
    """The int8 serving passes on the narrowed AlexNet (grouped convs,
    both lrn layers, flatten, dropout, softmax).

    - activation ranges: rtol 1e-6 (one float32 ulp of an upstream
      convolution); with the JAX package's ranges injected, every
      transformed param - int8 weights, frozen scales (bfloat16-rounded
      under dtype = bfloat16, the JAX `_cast` order), biases - is
      bitwise the JAX package's;
    - predict_dist: float32 atol 1e-6 (integer contractions are exact;
      the float32 layers between them differ in summation order);
      bfloat16 within two bfloat16 ulps of each probability (2^-6
      relative: the bfloat16 softmax rounds once more after a logit
      that may itself sit one ulp apart), argmax equal."""
    jt, pt = _pair(NARROW_ALEXNET + INT8_SERVING + f"dtype = {dtype}\n")
    jb, pb = _batch((3, 35, 35), 8, 1)
    want, got = jt.predict_dist(jb), pt.predict_dist(pb)
    assert set(pt._quant_stats) == set(jt._quant_stats) == {
        "conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"}
    for k, v in jt._quant_stats.items():
        assert pt._quant_stats[k] == pytest.approx(v, rel=1e-6)
    _inject_quant_stats(jt, pt)
    node = pt.net_cfg.num_nodes - 1
    graph = pt.infer_graph(node)
    _net2, pfn, jgm = jt._build_infer_graph(node)
    assert [(q.key, q.act_scale) for q in graph.gm.quants] == [
        (q.key, q.act_scale) for q in jgm.quants]
    for q, jq in zip(graph.gm.quants, jgm.quants):
        np.testing.assert_array_equal(q.wscale, jq.wscale)
    jparams = jax.device_get(jt._cast(pfn(jt.state["params"])))
    pparams = graph.params()
    assert sorted(pparams) == sorted(jparams)
    for k in jparams:
        assert sorted(pparams[k]) == sorted(jparams[k])
        for n in jparams[k]:
            assert pparams[k][n].dtype == {
                "int8": torch.int8, "float32": torch.float32,
                "bfloat16": torch.bfloat16}[jnp.dtype(
                    jparams[k][n].dtype).name]
            np.testing.assert_array_equal(
                pparams[k][n].float().numpy() if n != "wmat_q"
                else pparams[k][n].numpy(), _np(jparams[k][n]))
    jb, pb = _batch((3, 35, 35), 8, 2)
    want, got = jt.predict_dist(jb), pt.predict_dist(pb)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -6 + 1e-7)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("quant", [False, True])
def test_int8_mlp_pair_matches_jax(quant):
    """The benchmark's int8 workload (bench.py _INT8_MLP_CONF, narrowed):
    fold + fuse, with and without quantize_int8, at b16 and on a short
    batch of 5. float32: atol 1e-6 (float32 layers in another
    summation order around exact integer products)."""
    jt, pt = _pair(INT8_MLP_CONF + FOLD + (",quantize_int8" if quant else "")
                   + "\n")
    for n, seed in ((16, 41), (5, 42), (16, 43)):
        jb, pb = _batch((1, 1, 32), n, seed, lo=0.0)
        want, got = jt.predict_dist(jb), pt.predict_dist(pb)
        assert got.shape == (n, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert sorted(pt._fold_stats) == sorted(jt._fold_stats) == ["bn1",
                                                                 "bn2"]
    for k, (m, r) in jt._fold_stats.items():
        np.testing.assert_allclose(pt._fold_stats[k][0], m, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pt._fold_stats[k][1], r, rtol=1e-5)
    gm = pt.infer_graph(pt.net_cfg.num_nodes - 1).gm
    assert len(gm.folds) == 2
    assert [q.key for q in gm.quants] == (["fc1", "fc2", "fc3"] if quant
                                          else [])


@pytest.mark.parametrize("n", [1, 5, 7])
def test_batch_norm_short_batch_matches_jax(n):
    """A short predict batch is zero-padded to batch_size before the
    forward, so batch_norm's minibatch statistics include the zero rows,
    as in the JAX package (float32, rtol 1e-5 / atol 1e-6: the same
    sums in another order). Unpadded, the rows would differ."""
    jt, pt = _pair(FOLD_MLP_CONF.replace("batch_size = 32", "batch_size = 8"))
    jb, pb = _batch((1, 1, 36), n, 3, lo=0.0)
    want, got = jt.predict_dist(jb), pt.predict_dist(pb)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if n > 1:
        with torch.inference_mode():
            unpadded = pt.infer_fn(pt.net_cfg.num_nodes - 1)(
                pt.compute_params(), pt.stage_infer_rows(pb.data))
        assert not np.allclose(unpadded.reshape(n, -1).numpy(), want,
                               atol=1e-3)
    if n == 1:
        return
    # num_batch_padd rows are trimmed as well
    jb.num_batch_padd = pb.num_batch_padd = 1
    want, got = jt.predict_dist(jb), pt.predict_dist(pb)
    assert got.shape == (n - 1, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_short_batch_calibration_matches_jax():
    """Calibration on a short batch: fold moments over the padded batch
    (unmasked, the pinned single-batch rule), quant absmax over the
    valid rows only (masked) - rtol 1e-5 / 1e-6."""
    conf = QUANT_MLP_CONF + "graph_passes = fold_conv_bn,quantize_int8\n"
    jt, pt = _pair(conf)
    jb, pb = _batch((1, 1, 36), 5, 4, lo=0.0)
    jb.num_batch_padd = pb.num_batch_padd = 1
    assert jt.calibrate_graph_passes(jb) and pt.calibrate_graph_passes(pb)
    for k, v in jt._quant_stats.items():
        assert pt._quant_stats[k] == pytest.approx(v, rel=1e-6)
    for k, (m, r) in jt._fold_stats.items():
        np.testing.assert_allclose(pt._fold_stats[k][0], m, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pt._fold_stats[k][1], r, rtol=1e-5)
    assert not pt.calibrate_graph_passes(pb)  # nothing left to calibrate


def test_multi_batch_calibration_matches_jax():
    """A sequence of batches (one of them short): moments pooled by
    valid-row count, ranges pooled by max (rtol 1e-5)."""
    conf = QUANT_MLP_CONF + "graph_passes = fold_conv_bn,quantize_int8\n"
    jt, pt = _pair(conf)
    pairs = [_batch((1, 1, 36), n, 10 + n, lo=0.0) for n in (8, 8, 3)]
    assert jt.calibrate_graph_passes([j for j, _ in pairs])
    assert pt.calibrate_graph_passes([p for _, p in pairs])
    for k, v in jt._quant_stats.items():
        assert pt._quant_stats[k] == pytest.approx(v, rel=1e-6)
    for k, (m, r) in jt._fold_stats.items():
        np.testing.assert_allclose(pt._fold_stats[k][0], m, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pt._fold_stats[k][1], r, rtol=1e-5)
    assert pt._fold_epoch == jt._fold_epoch == 1


def test_checkpoints_identical_with_passes_on_and_off():
    """Passes never touch the saved weights or structure: trained with
    and without them, the checkpoints are byte-identical, and a JAX
    checkpoint loads into the port under the passes."""
    conf = FOLD_MLP_CONF.replace("batch_size = 32", "batch_size = 8")
    off = NetTrainer(cfg=conf, device="cpu")
    on = NetTrainer(cfg=conf + "graph_passes = all\n", device="cpu")
    blobs = []
    for tr in (off, on):
        tr.init_model()
        for i in range(3):
            tr.update(_batch((1, 1, 36), 8, 20 + i, lo=0.0)[1])
        tr.predict_dist(_batch((1, 1, 36), 8, 30, lo=0.0)[1])
        f = io.BytesIO()
        tr.save_model(f)
        blobs.append(f.getvalue())
    assert blobs[0] == blobs[1]
    assert on._fold_stats is not None
    jt = JaxTrainer()
    for k, v in parse_config_string(conf):
        jt.set_param(k, v)
    jt.init_model()
    f = io.BytesIO()
    jt.save_model(f)
    f.seek(0)
    pt = NetTrainer(cfg=conf + "graph_passes = fold_conv_bn,"
                    "dead_layer_elim\n", device="cpu")
    pt.load_model(f)
    jb, pb = _batch((1, 1, 36), 8, 31, lo=0.0)
    np.testing.assert_allclose(pt.predict_dist(pb), jt.predict_dist(jb),
                               rtol=1e-5, atol=1e-6)


def test_set_weight_recalibrates():
    """set_weight retires the frozen statistics (the next inference
    recalibrates, at a new epoch, with scales from the new weights); a
    training step keeps them, and the int8 weights follow the live
    params."""
    jt, pt = _pair(QUANT_MLP_CONF + "graph_passes = fold_conv_bn,"
                   "dead_layer_elim,quantize_int8\n")
    jb, pb = _batch((1, 1, 36), 8, 5, lo=0.0)
    jt.predict_dist(jb)
    pt.predict_dist(pb)
    assert pt._fold_epoch == jt._fold_epoch == 1
    node = pt.net_cfg.num_nodes - 1
    old = pt.infer_graph(node).params()["fc2"]["wmat_q"].clone()
    pt.update(pb)  # weights move, statistics stay
    assert not pt.passes_need_calibration() and pt._fold_epoch == 1
    assert not torch.equal(pt.infer_graph(node).params()["fc2"]["wmat_q"],
                           old)
    w, _shape = pt.get_weight("fc2", "wmat")
    pt.set_weight(w * 3.0, "fc2", "wmat")
    jt.set_weight(w * 3.0, "fc2", "wmat")
    assert pt.passes_need_calibration() and jt.passes_need_calibration()
    assert pt._fold_epoch == jt._fold_epoch == 2
    assert pt._infer_graph_cache == {}
    jt.predict_dist(jb)
    pt.predict_dist(pb)
    assert pt._fold_epoch == jt._fold_epoch == 3
    ws = {q.key: q.wscale for q in pt.infer_graph(node).gm.quants}
    np.testing.assert_allclose(
        ws["fc2"], np.abs(w * 3.0).max(axis=1) / 127.0, rtol=1e-6)


def test_layer_quant_float_pin_keeps_a_layer_float():
    jt, pt = _pair(PINNED_CONF + "graph_passes = quantize_int8\n")
    jb, pb = _batch((1, 1, 36), 8, 6, lo=0.0)
    np.testing.assert_allclose(pt.predict_dist(pb), jt.predict_dist(jb),
                               rtol=0, atol=1e-6)
    assert sorted(pt._quant_stats) == sorted(jt._quant_stats) == ["fc1"]
    params = pt.infer_graph(pt.net_cfg.num_nodes - 1).params()
    assert "wmat_q" in params["fc1"] and "wmat" in params["fc2"]
    with pytest.raises(ValueError, match="layer_quant"):
        NetTrainer(cfg=ACT_CONF.replace("nhidden = 3", "nhidden = 3\n  "
                                        "layer_quant = int4"),
                   device="cpu").init_model()


def test_uncalibrated_server_warns_and_serves_float(capsys):
    """A Server built before calibration warns and serves the float
    graph for its whole life, even after the trainer calibrates; one
    built after calibration serves the int8 graph, whose rows equal
    predict_dist (row-independent net; atol 1e-6 for the float32
    layers at another row count)."""
    conf = NARROW_ALEXNET + INT8_SERVING
    pt = NetTrainer(cfg=conf, device="cpu")
    pt.init_model()
    ref = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    ref.init_model()
    ref._set_params(pt.state["params"])
    assert pt.passes_need_calibration()
    _jb, pb = _batch((3, 35, 35), 8, 7)
    srv = Server(pt, max_batch=8, max_wait_ms=1.0, replicas=1, device="cpu")
    assert "have no calibration stats" in capsys.readouterr().err
    expect = pt.predict_dist(pb)  # calibrates the trainer, not srv
    with srv:
        rows = srv.submit(pb.data).result(timeout=120)
    np.testing.assert_allclose(rows, ref.predict_dist(pb), rtol=0,
                               atol=1e-6)
    assert not np.allclose(rows, expect, rtol=0, atol=1e-6)
    with Server(pt, max_batch=8, max_wait_ms=1.0, replicas=1,
                device="cpu") as srv2:
        rows2 = srv2.submit(pb.data[:5]).result(timeout=120)
    assert "calibration" not in capsys.readouterr().err
    np.testing.assert_allclose(rows2, expect[:5], rtol=0, atol=1e-6)


def test_autocast_bf16_train_step_matches_jax():
    """One training step under `graph_passes = autocast`, bfloat16: the
    same per-layer plan (batch_norm, lrn and the loss in float32), the
    master params stay float32, and each param's update agrees with the
    JAX package's to 10% of that tensor's largest update - bfloat16
    gradients, rounded at other places by the two frameworks (eight
    bits of mantissa, sums of a few hundred terms). The conv feeding the
    batch_norm has no bias: its exact gradient is zero, and what either
    framework computes there is rounding noise."""
    conf = BN_CONV_CONF.replace(
        "layer[+1:r1] = relu\n",
        "layer[+1:r1] = relu\nlayer[+1:l1] = lrn\n  local_size = 3\n"
    ).replace("  kernel_size = 4\n", "  kernel_size = 4\n  no_bias = 1\n") \
        + "dtype = bfloat16\ngraph_passes = autocast\n"
    jt, pt = _pair(conf)
    assert {i: PP.dtype_name(d) for i, d in pt._graph_dtype_plan.items()} \
        == {i: jnp.dtype(d).name for i, d in jt._graph_dtype_plan.items()}
    assert pt.compute_params() is pt.state["params"]
    before = convert.params_to_numpy(pt.state["params"],
                                      pt.net.param_shapes())
    jb, pb = _batch((3, 16, 16), 8, 8, lo=0.0)
    jt.update(jb)
    pt.update(pb)
    jp = jax.device_get(jt.state["params"])
    pp = convert.params_to_numpy(pt.state["params"], pt.net.param_shapes())
    for k in jp:
        for n in jp[k]:
            dj, dp = jp[k][n] - before[k][n], pp[k][n] - before[k][n]
            assert np.abs(dj).max() > 0
            assert np.abs(dp - dj).max() <= 0.1 * np.abs(dj).max(), (k, n)


def test_cli_pred_and_serve_with_int8_passes(tmp_path, capsys):
    """The port's CLI with the int8 serving passes on an MNIST-format set:
    task = pred (explicit calibration on 2 pred batches) and task =
    serve (calibrated on its first pred batch) write the same lines,
    and both print their calibration line."""
    from test_torch_serve import CLI_CONF, write_mnist
    d = str(tmp_path)
    write_mnist(d, 100, 1)
    conf = os.path.join(d, "net.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "p.txt"), d=d))
    tr = NetTrainer(cfg=CLI_CONF.format(out="p.txt", d=d), device="cpu")
    tr.init_model()
    model = os.path.join(d, "m.model")
    with open(model, "wb") as fo:
        tr.save_model(fo)
    passes = ["graph_passes=dead_layer_elim,elim_reshape,fuse_activation,"
              "quantize_int8", "dev=cpu", f"model_in={model}"]
    outs = {}
    for task, extra in (("pred", ["pass_calibration_batches=2"]),
                        ("serve", ["serve_rows=0"])):
        out = os.path.join(d, f"{task}.txt")
        assert port_main.main([conf, f"task={task}", f"pred={out}"]
                              + passes + extra) == 0
        with open(out) as f:
            outs[task] = f.read()
    stdout = capsys.readouterr().out
    assert "graph_passes: calibrated on 2 batch(es) from the pred " \
           "iterator" in stdout
    assert "serve: calibrated graph passes on the first pred batch" in stdout
    assert outs["pred"].count("\n") == 100
    assert outs["serve"] == outs["pred"]
    assert kernels.launches()["int8_mm"] == 0  # the CPU runs no kernel
