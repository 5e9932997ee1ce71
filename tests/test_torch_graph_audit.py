"""The port's graph audit (cxxnet_tpu_torch/analysis/graph_audit.py) on
the CPU: every check passes, the counts that mean the same thing in the
JAX package's jaxpr audit equal its counts on the same confs (bucket
programs, int8 data-path products, pruned layers), and the probe's
parts (op log, host reads, plain-version calls) see what they claim to
and restore what they wrap."""

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.analysis import graph_audit as GA


@pytest.fixture(scope="module")
def audit():
    return GA.run_audit("cpu")


def test_every_check_passes_on_the_cpu(audit):
    bad = [c for c in audit["checks"] if not c["ok"]]
    assert bad == []
    assert audit["failed"] == 0 and audit["platform"] == "cpu"


@pytest.mark.parametrize("target,check", [
    ("train_step", "no-f64"), ("train_step", "no-host-sync"),
    ("train_step", "update-in-place"), ("train_step", "no-param-sized-copy"),
    ("train_chunk[K=1]", "update-in-place"),
    ("train_chunk[K=4]", "no-host-sync"),
    ("train_chunk[K=4,check_nan=1]", "one-guard-readback-a-chunk"),
    ("eval_step", "eval-leaves-params"), ("eval_metric_step", "no-f64"),
    ("infer_step", "no-host-sync"),
    ("recompile", "chunk-programs==2 after 4+4+1 round"),
    ("recompile", "no-kernel-build-or-load-after-warmup"),
    ("serve", "bucket-programs==bucket-count"),
    ("serve", "no-new-program-over-100-mixed-requests"),
    ("serve[b=8]", "eval-leaves-params"),
    ("passes/fold", "no-bn-moment-ops"), ("passes/dle",
                                         "pruned-subgraph-absent"),
    ("passes/fuse_activation", "fewer-ops-equal-matmuls"),
    ("passes/merge_conv_1x1", "one-conv-fewer"),
    ("passes/cse_share", "duplicate-matmul-deduped"),
    ("passes/elim_reshape", "fewer-ops-equal-matmuls"),
    ("quant", "int8-data-path-engaged"),
    ("quant", "float-trace-vacuity-guard"),
    ("quant", "layer_quant-float-pin-honored"),
    ("quant/serve", "no-new-program-after-calibration"),
    ("executables", "covers-train-infer-serve"),
])
def test_check_present_and_passing(audit, target, check):
    hits = [c for c in audit["checks"]
            if c["target"] == target and c["check"] == check]
    assert len(hits) == 1, (target, check)
    assert hits[0]["ok"], hits[0]["detail"]


def test_zero_audit_is_deferred_not_passed(audit):
    """The zero audit is no longer deferred: it runs, on two ranks a
    case, and every one of its checks passes on every rank (the stage-2
    and stage-3 collectives, stage 3's cut storage, the model axis's
    enter / gather / reduce)."""
    assert audit["deferred"] == []
    zero = [c for c in audit["checks"] if c["target"].startswith("zero")]
    names = {(c["target"].rsplit("/", 1)[0], c["check"]) for c in zero}
    assert names == {
        (f"zero-audit/stage{s}[data:2]", chk) for s in (2, 3)
        for chk in ("zero-reduce-scatter-present",
                    "zero-no-full-grad-allreduce",
                    "zero-weight-all-gather-present")} | {
        ("zero-audit/stage3[data:2]", "zero3-params-stored-sharded")} | {
        ("zero-audit/tp[model:2]", chk) for chk in (
            "tp-enter-gather-pairs", "tp-row-parallel-all-reduce",
            "tp-no-data-collective")}
    for c in zero:
        assert c["ok"], c
    assert "kernel_routing" not in audit["counts"]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GA.run_audit()


# ---------------------------------------------------------------------------
# the counts that mean the same thing in the JAX audit
# ---------------------------------------------------------------------------
def test_bucket_programs_equal_jax(audit):
    from cxxnet_tpu.analysis import jaxpr_audit as JA
    sizes = JA._serve_audit([])
    assert audit["counts"]["serve_programs_warm"] == \
        sizes["serve_infer_warm"] == 4
    assert audit["counts"]["serve_programs_after"] == \
        sizes["serve_infer_after"]


def _jax_trainer(conf, extra):
    from cxxnet_tpu.nnet.trainer import NetTrainer
    from cxxnet_tpu.utils.config import parse_config_string
    tr = NetTrainer()
    for k, v in parse_config_string(conf + extra):
        tr.set_param(k, v)
    tr.init_model()
    return tr


def test_int8_products_equal_jax(audit):
    from cxxnet_tpu.analysis import jaxpr_audit as JA
    tr = _jax_trainer(JA._CONF_BN, f"graph_passes = {JA._QUANT_PASSES}\n")
    tr.calibrate_graph_passes(JA._batch(0))
    final = tr.net_cfg.num_nodes - 1
    g, ge = tr.stage_infer_rows(np.zeros((32, 1, 1, 36), np.float32))
    i8, fp = JA._data_path_dots(tr._infer_fn(final),
                                (tr.state["params"], g, ge), 32)
    assert audit["counts"]["int8_products"] == i8 == 2
    assert audit["counts"]["float_products_quant"] == fp == 0


def test_pruned_layers_equal_jax(audit):
    from cxxnet_tpu.analysis import jaxpr_audit as JA
    tr = _jax_trainer(JA._CONF_BN,
                      "graph_passes = fold_conv_bn,dead_layer_elim\n")
    tr.calibrate_graph_passes(JA._batch(0))
    early = tr.net.node_index("fc1")
    gm = tr._build_infer_graph(early)[2]
    pruned = len(tr.net_cfg.layers) - len(gm.cfg.layers)
    assert audit["counts"]["dle_pruned_layers"] == pruned > 0


# ---------------------------------------------------------------------------
# the probe's parts
# ---------------------------------------------------------------------------
def test_probe_sees_f64_host_reads_and_restores():
    real_item = torch.Tensor.item
    with GA.Probe("cpu") as p:
        x = torch.ones(3, dtype=torch.float64)
        float(x.sum())
        torch.ones(2).cpu()
    assert torch.Tensor.item is real_item
    assert "aten::sum" in p.f64_ops()
    assert p.count(GA.HOST_SYNC_OPS) == 1
    assert p.read_kinds == {"Tensor.cpu": 1}


def test_probe_counts_plain_versions_and_keeps_errors():
    from cxxnet_tpu_torch.ops import lrn as lrn_ops
    real = lrn_ops.lrn_reference
    x = torch.rand(2, 8, 5, 5)
    with GA.Probe("cpu") as p:
        lrn_ops.lrn_cpu(x, 5, 1e-4, 0.75, 1.0)
    assert lrn_ops.lrn_reference is real
    assert p.plain == {"lrn_reference": 1}
    with GA.Probe("cpu") as p:
        raise ValueError("kept")
    assert p.error == "ValueError: kept"


def test_data_path_products_split_int_and_float():
    with GA.Probe("cpu") as p:
        a = torch.ones(4, 3)
        torch.mm(a, torch.ones(3, 2))                   # float, batch 4
        torch.mm(a.to(torch.int32), torch.ones(3, 2, dtype=torch.int32))
        torch.mm(torch.ones(2, 3), torch.ones(3, 5))    # not batch-led
    assert p.data_path_products(4) == (1, 1)


@pytest.mark.parametrize("case", ["ring", "ulysses"])
@pytest.mark.parametrize("check", ["seq-schedule",
                                   "seq-no-all-gather-in-attention"])
def test_seq_audit_checks_pass(audit, case, check):
    """The seq audit: seq_mnist.conf at mesh = seq:2 on two ranks, one
    probed step each - the ring's hops and partials or Ulysses'
    all-to-alls as the schedule says, and no all-gather but the
    network's sequence gather (kernel-routing joins these on the
    card)."""
    hits = [c for c in audit["checks"] if c["check"] == check
            and c["target"].startswith(f"seq-audit/{case}[seq:2]/rank")]
    assert len(hits) == 2, hits
    for c in hits:
        assert c["ok"], c["detail"]
