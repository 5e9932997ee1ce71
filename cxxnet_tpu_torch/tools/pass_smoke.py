"""Graph-pass smoke: folding/pruning must change no product answer (the
port's copy of cxxnet_tpu/tools/pass_smoke.py).

    python -m cxxnet_tpu_torch.tools.pass_smoke [--out DIR] [--keep]
        [--dev DEV]

Trains a tiny fullc+batch_norm MLP once through the port's CLI, then
proves the infer-stage graph passes (docs/GRAPH_PASSES.md) at the
product surface:

- **fold parity**: `task = pred` with `graph_passes =
  fold_conv_bn,dead_layer_elim` vs passes off, at `batch_size = 96`
  so the whole pred set is ONE batch - the fold's calibration batch
  IS the inference batch, making the fold a pure contraction-order
  rewrite: identical argmax on every row (line-identical prediction
  files) and tight-allclose `task = pred_raw` logits;
- **fold engagement**: the fold leg's event stream carries the
  `graph_passes calibrate` event, and the graph audit's op trace
  (analysis/graph_audit.py) shows the folded infer runs ZERO
  batch-norm moment ops while the unfolded one runs them - the parity
  checks cannot pass vacuously with the passes silently off;
- **dead-layer elimination**: `task = extract` of the EARLY node
  fc1 produces byte-identical features with passes on vs off, and
  the pruned extract runs strictly fewer aten ops and matmuls. (The
  JAX tool also reports the lowered module's bytes; eager PyTorch
  lowers nothing, so that figure has no counterpart here.)

PR-11 legs (docs/GRAPH_PASSES.md "Pass catalog"):

- **activation-fusion parity**: a second trained MLP whose head is
  fullc -> bias -> relu, `task = pred` with
  `graph_passes = dead_layer_elim,fuse_activation` vs passes off -
  identical argmax on every row + tight-allclose raw logits (the
  bias absorption is a pure add-reassociation);
- **1x1-merge parity**: in process, trains a conv -> 1x1-conv -> relu
  net and compares fused (`merge_conv_1x1,fuse_activation`) vs
  unfolded predict_dist rows, plus the one-conv-fewer op-trace claim;
- **per-layer-plan autotune**: tools/autotune.py on a tiny budget
  writes a schema-v2 cache (the plan JSON stays in --out as a CI
  artifact), then the SAME pred task replays it twice via
  `tuning_cache =` - identical output files (plans are
  deterministic pickups, not per-run noise).

PR-12 leg (docs/GRAPH_PASSES.md "Quantization"):

- **int8 quant leg**: the SAME trained fullc+bn MLP, `task = pred`
  with `graph_passes = fold_conv_bn,dead_layer_elim,quantize_int8`
  vs passes off - argmax agreement >= 95/96 rows (int8 is an
  approximation, so the pinned threshold prices its accuracy cost
  instead of demanding identity), a calibrate event carrying
  `quant_sites` on the quant leg's stream, and an in-process
  int8-engagement proof on the op trace: every data-path product of
  the quantized infer is an int8 product (K3 on the card, its plain
  version on the CPU) with ZERO float data-path products, while the
  float forward keeps its float products (vacuity guard). The verdict
  is written to `quant_report.json`.

The CLI children run side by side (the two trainings and the autotune,
then the thirteen inference legs, at most eight at once, with the
in-process op-trace legs meanwhile): each is an independent process,
so only their inputs order them. Every leg runs on the card unless
`--dev cpu` asks for the CPU. Exit 0 iff all checks pass.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from cxxnet_tpu_torch.tools.common import cli_dev, cli_env, run_cli, smoke_main
from cxxnet_tpu_torch.tools.telemetry_smoke import write_synth_mnist

CONF = """
data = train
iter = mnist
    path_img = "{d}/train-img.gz"
    path_label = "{d}/train-lbl.gz"
    shuffle = 1
iter = end
pred = {d}/out.txt
iter = mnist
    path_img = "{d}/test-img.gz"
    path_label = "{d}/test-lbl.gz"
iter = end

netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1:bn1] = batch_norm:bn1
layer[+1:sg1] = tanh
layer[sg1->fc2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end

input_shape = 1,1,36
batch_size = 32
dev = {dev}
save_model = 1
num_round = 2
max_round = 2
eta = 0.3
metric = error
silent = 1
"""

_PASSES = "graph_passes=fold_conv_bn,dead_layer_elim"

# int8 quant leg: the fold pipeline + quantize_int8 on top
_QUANT_PASSES = "graph_passes=fold_conv_bn,dead_layer_elim," \
                "quantize_int8"
# pinned argmax-agreement floor: 95 of the 96 pred rows. int8 is an
# approximation - the threshold prices its accuracy cost instead of
# demanding identity (docs/GRAPH_PASSES.md "Quantization")
_QUANT_AGREE_MIN = 95

# activation-fusion leg: same data blocks, fullc -> bias -> relu head
CONF_ACT = CONF.replace(
    "layer[+1:bn1] = batch_norm:bn1\nlayer[+1:sg1] = tanh",
    "layer[+0] = bias:bs1\n  init_bias = 0.05\nlayer[+1:sg1] = relu")

_ACT_PASSES = "graph_passes=dead_layer_elim,fuse_activation"

# 1x1-merge leg (in-process child): conv -> 1x1 conv -> relu head
_MERGE_CONF = """
netconfig=start
layer[+1:c1] = conv:c1
  nchannel = 4
  kernel_size = 3
  pad = 1
layer[+1:c2] = conv:c2
  nchannel = 6
  kernel_size = 1
layer[+1:r1] = relu
layer[+1:fl] = flatten
layer[+1:fc] = fullc:fc
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 3,8,8
batch_size = 16
eta = 0.1
silent = 1
seed = 5
"""


def _run_cli(out_dir: str, *overrides: str,
             conf: str = "pass_smoke.conf"
             ) -> subprocess.CompletedProcess:
    return run_cli(os.path.join(out_dir, conf), *overrides)


def _side_by_side(jobs, out_dir: str, plan_json: str, device: str,
                  workers: int = 8, meanwhile=None) -> dict:
    """Run CLI children side by side, at most `workers` at once: {name:
    overrides} (a `conf=NAME` override picks the conf file in out_dir),
    or None for the autotune child writing `plan_json`; `meanwhile()`, if
    given, runs in this thread while they do. Returns {name:
    CompletedProcess}."""
    from concurrent.futures import ThreadPoolExecutor

    def run(args):
        if args is None:
            return subprocess.run(
                [sys.executable, "-m", "cxxnet_tpu_torch.tools.autotune",
                 "--out", plan_json, "--budget-secs", "5", "--serve", "1",
                 "--per-layer", "1", "--dev", cli_dev(device)],
                env=cli_env(), capture_output=True, text=True, timeout=540)
        conf = [a[5:] for a in args if a.startswith("conf=")]
        rest = [a for a in args if not a.startswith("conf=")]
        return _run_cli(out_dir, *rest,
                        conf=conf[0] if conf else "pass_smoke.conf")

    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = {name: pool.submit(run, args) for name, args in jobs.items()}
        if meanwhile is not None:
            meanwhile()
        return {name: f.result() for name, f in futs.items()}


def _lines(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().splitlines()


def _floats(lines):
    return np.asarray([[float(t) for t in ln.split()]
                       for ln in lines], np.float64)


def _net_base() -> str:
    net_conf = CONF.split("netconfig=start")[1].split("netconfig=end")[0]
    return ("netconfig=start" + net_conf + "netconfig=end\n"
            "input_shape = 1,1,36\nbatch_size = 32\n"
            "eta = 0.3\nsilent = 1\nseed = 3\n")


def _calibration_batch(seed: int):
    from cxxnet_tpu_torch.io.data import DataBatch
    rng = np.random.RandomState(seed)
    return DataBatch(
        data=rng.rand(32, 1, 1, 36).astype(np.float32),
        label=rng.randint(0, 3, (32, 1)).astype(np.float32))


def _program_sizes(device: str) -> dict:
    """In-process introspection: the op traces (analysis/graph_audit.py)
    of the extract and final-node inference with passes on vs off
    (fresh weights - the trace's SIZE is weight-independent)."""
    from cxxnet_tpu_torch.analysis import graph_audit as GA
    base = _net_base()
    off = GA._make_trainer(device, base)
    on = GA._make_trainer(device, base, _PASSES.replace("=", " = ", 1)
                          + "\n")
    early = off.net.node_index("fc1")
    final = off.net_cfg.num_nodes - 1
    on.calibrate_graph_passes(_calibration_batch(5))

    def sizes(tr, node):
        p = GA._probe_infer(tr, node, (32, 1, 1, 36), device)
        return {"ops": len(p.ops), "dots": p.count(GA.DOTS),
                "bn_moments": p.count(GA.BN_MOMENTS)}

    return {
        "extract_off": sizes(off, early),
        "extract_on": sizes(on, early),
        "final_off": sizes(off, final),
        "final_on": sizes(on, final),
    }


def _quant_engagement(device: str) -> dict:
    """In-process int8-engagement proof on the op trace (the parity
    check alone could pass vacuously with quantize_int8 silently off):
    data-path products of the quantized vs float forward, counted by
    the graph audit's own definitions."""
    from cxxnet_tpu_torch.analysis import graph_audit as GA
    base = _net_base()
    off = GA._make_trainer(device, base)
    on = GA._make_trainer(device, base,
                          _QUANT_PASSES.replace("=", " = ", 1) + "\n")
    on.calibrate_graph_passes(_calibration_batch(9))
    node = off.net_cfg.num_nodes - 1

    def products(tr):
        p = GA._probe_infer(tr, node, (32, 1, 1, 36), device)
        return GA.int8_products(p), p.data_path_products(32)[1]

    i8_on, fp_on = products(on)
    i8_off, fp_off = products(off)
    return {"int8_dots_quant": i8_on, "float_dots_quant": fp_on,
            "int8_dots_float": i8_off, "float_dots_float": fp_off}


def merge_leg(device: str) -> dict:
    """Train the conv -> 1x1-conv net a few steps, compare predict_dist
    fused (merge_conv_1x1 + fuse_activation) vs passes off, and count
    the data-path convs of the op trace."""
    from cxxnet_tpu_torch.analysis import graph_audit as GA
    from cxxnet_tpu_torch.io.data import DataBatch

    def build(extra=""):
        return GA._make_trainer(device, _MERGE_CONF, extra)

    def batch(i):
        r = np.random.RandomState(300 + i)
        return DataBatch(
            data=r.rand(16, 3, 8, 8).astype(np.float32),
            label=r.randint(0, 3, (16, 1)).astype(np.float32))

    off = build()
    on = build("graph_passes = dead_layer_elim,merge_conv_1x1,"
               "fuse_activation\n")
    for i in range(3):
        off.update(batch(i))
        on.update(batch(i))
    b = batch(90)
    po, pn = off.predict_dist(b), on.predict_dist(b)

    def convs(tr):
        node = tr.net_cfg.num_nodes - 1
        return GA._probe_infer(tr, node, (16, 3, 8, 8),
                               device).count(GA.CONVS)

    return {
        "max_diff": float(np.abs(po - pn).max()),
        "allclose": bool(np.allclose(po, pn, rtol=5e-4, atol=1e-6)),
        "argmax_equal": bool((po.argmax(1) == pn.argmax(1)).all()),
        "convs_off": convs(off),
        "convs_on": convs(on),
    }


def run_smoke(out_dir: str, device: str) -> int:
    from cxxnet_tpu_torch.telemetry.sink import read_jsonl
    write_synth_mnist(out_dir, 192, 0, "train")
    # 96 test instances + batch_size=96 on the inference legs = the
    # whole pred set is ONE batch (the fold calibration batch)
    write_synth_mnist(out_dir, 96, 1, "test")
    with open(os.path.join(out_dir, "pass_smoke.conf"), "w") as f:
        f.write(CONF.format(d=out_dir, dev=cli_dev(device)))
    mdir = os.path.join(out_dir, "models")
    model = os.path.join(mdir, "0002.model")
    p_off = os.path.join(out_dir, "pred_off.txt")
    p_on = os.path.join(out_dir, "pred_fold.txt")
    r_off = os.path.join(out_dir, "raw_off.txt")
    r_on = os.path.join(out_dir, "raw_fold.txt")
    x_off = os.path.join(out_dir, "extract_off.txt")
    x_on = os.path.join(out_dir, "extract_on.txt")
    log = os.path.join(out_dir, "pass_events.jsonl")

    # --- the CLI children: the two trainings and the autotune first,
    # then every inference leg, each stage side by side (the legs are
    # independent processes; only their inputs are ordered) ---------
    with open(os.path.join(out_dir, "pass_smoke_act.conf"), "w") as f:
        f.write(CONF_ACT.format(d=out_dir, dev=cli_dev(device)))
    mdir_a = os.path.join(out_dir, "models_act")
    model_a = os.path.join(mdir_a, "0002.model")
    a_off, a_on = (os.path.join(out_dir, n)
                   for n in ("act_off.txt", "act_on.txt"))
    ar_off, ar_on = (os.path.join(out_dir, n)
                     for n in ("act_raw_off.txt", "act_raw_on.txt"))
    q_pred = os.path.join(out_dir, "pred_quant.txt")
    q_log = os.path.join(out_dir, "quant_events.jsonl")
    plan_json = os.path.join(out_dir, "tuning_plan.json")
    t1, t2 = (os.path.join(out_dir, n)
              for n in ("tuned_pred_1.txt", "tuned_pred_2.txt"))
    common = (f"model_in={model}", "batch_size=96")
    common_a = (f"model_in={model_a}", "batch_size=96",
                "conf=pass_smoke_act.conf")
    first = _side_by_side({
        "train": (f"model_dir={mdir}",),
        "train_a": (f"model_dir={mdir_a}", "conf=pass_smoke_act.conf"),
        "autotune": None,
    }, out_dir, plan_json, device)
    train, train_a, at = first["train"], first["train_a"], first["autotune"]
    inproc = {}

    def in_process_legs():
        """The op-trace legs, in this process while the children run."""
        inproc["sizes"] = _program_sizes(device)
        try:
            inproc["merge"] = merge_leg(device)
        except Exception as e:  # noqa: BLE001 - reported as a failed check
            inproc["merge"] = {"error": f"{type(e).__name__}: {e}"}
        inproc["quant"] = _quant_engagement(device)

    runs = _side_by_side({
        "pred_off": ("task=pred", *common, f"pred={p_off}"),
        "pred_on": ("task=pred", *common, f"pred={p_on}", _PASSES,
                    f"log_file={log}"),
        "raw_off": ("task=pred_raw", *common, f"pred={r_off}"),
        "raw_on": ("task=pred_raw", *common, f"pred={r_on}", _PASSES),
        "x_off": ("task=extract", *common, "extract_node_name=fc1",
                  f"pred={x_off}"),
        "x_on": ("task=extract", *common, "extract_node_name=fc1",
                 f"pred={x_on}", _PASSES),
        "a_off": ("task=pred", *common_a, f"pred={a_off}"),
        "a_on": ("task=pred", *common_a, f"pred={a_on}", _ACT_PASSES),
        "ar_off": ("task=pred_raw", *common_a, f"pred={ar_off}"),
        "ar_on": ("task=pred_raw", *common_a, f"pred={ar_on}",
                  _ACT_PASSES),
        "quant": ("task=pred", *common, f"pred={q_pred}", _QUANT_PASSES,
                  f"log_file={q_log}"),
        "tuned_1": ("task=pred", *common, f"pred={t1}",
                    f"tuning_cache={plan_json}"),
        "tuned_2": ("task=pred", *common, f"pred={t2}",
                    f"tuning_cache={plan_json}"),
    }, out_dir, plan_json, device, meanwhile=in_process_legs)
    legs = {k: runs[k] for k in ("pred_off", "pred_on", "raw_off",
                                 "raw_on", "x_off", "x_on")}
    po, pn = _lines(p_off), _lines(p_on)
    ro, rn = _lines(r_off), _lines(r_on)
    xo, xn = _lines(x_off), _lines(x_on)
    raw_diff = float("nan")
    raw_close = False
    if ro and rn and len(ro) == len(rn):
        a, b = _floats(ro), _floats(rn)
        raw_diff = float(np.abs(a - b).max())
        # ~ULP contraction change through a %g-printed file: the
        # SERVING.md "Numerics fine print" tolerance class
        raw_close = bool(np.allclose(a, b, rtol=5e-4, atol=1e-6))
    events = ([e for e in read_jsonl(log)
               if e.get("kind") == "graph_passes"]
              if os.path.exists(log) else [])
    calibrated = any(e.get("op") == "calibrate" for e in events)
    sizes = inproc["sizes"]
    ex_off, ex_on = sizes["extract_off"], sizes["extract_on"]
    fin_off, fin_on = sizes["final_off"], sizes["final_on"]

    # --- activation-fusion parity leg (the second trained MLP) -----
    act_legs = {k: runs[k] for k in ("a_off", "a_on", "ar_off", "ar_on")}
    ao, an = _lines(a_off), _lines(a_on)
    aro, arn = _lines(ar_off), _lines(ar_on)
    act_diff, act_close = float("nan"), False
    if aro and arn and len(aro) == len(arn):
        fa, fb = _floats(aro), _floats(arn)
        act_diff = float(np.abs(fa - fb).max())
        act_close = bool(np.allclose(fa, fb, rtol=5e-4, atol=1e-6))

    # --- 1x1-merge parity leg (in process) -------------------------
    merge = inproc["merge"]

    # --- int8 quant leg: quantized pred vs float, same trained MLP -
    quant_leg = runs["quant"]
    qn = _lines(q_pred)
    q_agree = (sum(a == b for a, b in zip(po, qn))
               if po and qn and len(po) == len(qn) else 0)
    q_events = ([e for e in read_jsonl(q_log)
                 if e.get("kind") == "graph_passes"]
                if os.path.exists(q_log) else [])
    q_calibrated = any(e.get("op") == "calibrate"
                       and e.get("quant_sites") for e in q_events)
    quant = inproc["quant"]

    # --- per-layer-plan autotune leg: tiny grid, cache written then
    # replayed twice - the plan JSON stays in out_dir
    plan_blob = {}
    if os.path.exists(plan_json):
        with open(plan_json) as f:
            plan_blob = json.load(f)
    tuned_legs = [runs["tuned_1"], runs["tuned_2"]]
    to1, to2 = _lines(t1), _lines(t2)

    checks = [
        ("train run completed",
         train.returncode == 0 and os.path.exists(model)),
        ("all inference legs completed",
         all(r.returncode == 0 for r in legs.values())),
        ("fold parity: identical argmax predictions (96 lines)",
         po is not None and po == pn and len(po) == 96),
        ("fold parity: tight-allclose pred_raw logits "
         f"(max diff {raw_diff:.2e})", raw_close),
        ("fold engaged: calibrate event on the fold leg's stream",
         calibrated),
        ("fold engaged: folded infer runs no batch-norm moment op "
         f"({fin_on['bn_moments']} vs unfolded {fin_off['bn_moments']})",
         fin_on["bn_moments"] == 0 and fin_off["bn_moments"] > 0),
        ("fold: strictly smaller op trace "
         f"({fin_on['ops']} vs {fin_off['ops']} ops)",
         fin_on["ops"] < fin_off["ops"]),
        ("dle: byte-identical extract of early node fc1",
         xo is not None and xo == xn and len(xo) == 96),
        ("dle: extract runs a strictly smaller op trace "
         f"({ex_on['ops']} vs {ex_off['ops']} ops, "
         f"{ex_on['dots']} vs {ex_off['dots']} matmuls)",
         ex_on["ops"] < ex_off["ops"]
         and ex_on["dots"] < ex_off["dots"]),
        ("act-fusion legs completed",
         train_a.returncode == 0
         and all(r.returncode == 0 for r in act_legs.values())),
        ("act-fusion parity: identical argmax predictions (96 lines)",
         ao is not None and ao == an and len(ao) == 96),
        ("act-fusion parity: tight-allclose pred_raw logits "
         f"(max diff {act_diff:.2e})", act_close),
        ("1x1-merge parity: allclose rows + identical argmax "
         f"(max diff {merge.get('max_diff', float('nan')):.2e})",
         merge.get("allclose", False)
         and merge.get("argmax_equal", False)),
        ("1x1-merge: exactly one conv fewer in the op trace "
         f"({merge.get('convs_on')} vs {merge.get('convs_off')})",
         merge.get("convs_off", 0) >= 2
         and merge.get("convs_on") == merge.get("convs_off", 0) - 1),
        ("int8 leg completed", quant_leg.returncode == 0),
        (f"int8 argmax agreement >= {_QUANT_AGREE_MIN}/96 "
         f"(got {q_agree}/96)",
         qn is not None and len(qn) == 96
         and q_agree >= _QUANT_AGREE_MIN),
        ("int8 leg: calibrate event carries quant_sites",
         q_calibrated),
        ("int8 engaged: quantized forward's data-path products are "
         f"all int8 ({quant.get('int8_dots_quant')} int8, "
         f"{quant.get('float_dots_quant')} float)",
         quant.get("int8_dots_quant", 0) > 0
         and quant.get("float_dots_quant", 1) == 0),
        ("int8 vacuity guard: float forward keeps float products "
         f"({quant.get('float_dots_float')} float, "
         f"{quant.get('int8_dots_float')} int8)",
         quant.get("float_dots_float", 0) > 0
         and quant.get("int8_dots_float", 1) == 0),
        ("autotune leg: schema-v2 cache with a per-layer plan field",
         at.returncode == 0 and plan_blob.get("version") == 2
         and "layers" in plan_blob.get("platforms", {}).get(
             "cpu" if device == "cpu" else "gpu", {})),
        ("autotune leg: cache replay is deterministic "
         "(two identical tuned pred files, 96 lines)",
         all(r.returncode == 0 for r in tuned_legs)
         and to1 is not None and to1 == to2 and len(to1) == 96),
    ]
    ok = True
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
        ok = ok and bool(passed)
    if not ok:
        for tag, r in ([("train", train), ("train_act", train_a),
                        ("autotune", at), ("quant", quant_leg)]
                       + list(legs.items()) + list(act_legs.items())):
            if r.returncode != 0:
                print(f"--- {tag} stderr tail ---")
                print(r.stderr[-2000:])
        if "error" in merge:
            print(f"--- merge leg ---\n{merge['error']}")
    with open(os.path.join(out_dir, "pass_sizes.json"), "w") as f:
        json.dump(sizes, f, indent=1, sort_keys=True)
    # the quant-leg verdict rides the pass-smoke artifact upload
    with open(os.path.join(out_dir, "quant_report.json"), "w") as f:
        json.dump({"argmax_agree": q_agree, "rows": 96,
                   "agree_min": _QUANT_AGREE_MIN,
                   "calibrate_event": q_calibrated, **quant},
                  f, indent=1, sort_keys=True)
    print(f"pass_smoke: {'PASS' if ok else 'FAIL'} "
          f"(raw max diff {raw_diff:.2e}; extract op trace "
          f"{ex_off['ops']}->{ex_on['ops']} ops)")
    return 0 if ok else 1


def main(argv=None) -> int:
    return smoke_main("pass_smoke", run_smoke, argv)


if __name__ == "__main__":
    sys.exit(main())
