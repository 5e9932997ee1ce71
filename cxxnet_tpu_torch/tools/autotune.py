"""TVM-style autotuner: measure the dispatch/staging/serving knob
space and persist a per-platform tuning cache (arXiv:1802.04799; the
port's copy of cxxnet_tpu/tools/autotune.py, measuring the port; each
timed window ends in a device synchronise).

    python -m cxxnet_tpu_torch.tools.autotune
        [--out models/tuning_cache.json] [--conf workload.conf]
        [--budget-secs N] [--serve 0|1] [--per-layer 0|1] [--dev DEV]
        [--grid-k 1,2,4] [--grid-prefetch 0,1,2]

Searched knobs (nnet/tuning.py TUNABLE_KEYS):

- `steps_per_dispatch` x `prefetch_stage`: a bounded grid of fused
  dispatch depth against staging-prefetch depth, measured as e2e
  images/sec through the REAL trainer.update()/update_chunk path on
  synthetic host batches (both knobs interact: a deep prefetch feeds
  a fused chunk, a shallow one starves it);
- `serve_max_batch`: the serving bucket-ladder ceiling, measured as
  rows/sec through a real warmed `serve.Server` under a mixed-size
  request storm - and, from the storm's own request-size histogram
  (the Server's `request_sizes` telemetry), a SHAPED bucket ladder
  (`serve.ladder_from_histogram`) replacing the fixed power-of-two
  set, persisted as the v2 cache's `serve_ladder` when it measures
  at least as fast;
- `stage_dtype` (the staged-input layout axis): bf16 vs f32 H2D
  staging, measured only when the workload computes in bf16 (the
  knob is a no-op under f32 - docs/PERFORMANCE.md).

Per-layer search (`--per-layer 1`, schema-v2 `layers` plans -
nnet/tuning.py LAYER_TUNABLE_KEYS): a bounded greedy flip of
`space_to_depth` per strided conv and `layer_dtype` per conv/fullc
(bf16 + autocast workloads, feeding the autocast pass's dtype plan),
each candidate measured through the REAL cache-pickup path (a temp
tuning_cache the trainer replays), so a plan that wins the search is
by construction a plan the product applies. Workloads running the
`quantize_int8` pass additionally search `layer_quant` per eligible
conv/fullc (pin a layer back to float where int8 loses -
docs/GRAPH_PASSES.md "when int8 loses"), measured through the
INFERENCE path (calibrate once, then timed predict_dist) since
quantization never touches training.

The winners persist under `--out` keyed by the trainer's platform
("gpu" on the card, "cpu" under `--dev cpu` - what the JAX package's
backend names the same hardware, so one cache serves both packages);
`main.py` / `wrapper.Net` pick them up via `tuning_cache = <path>` with
explicit config keys always winning. The default workload is the tiny
synthetic MLP (dispatch-bound, so the fused-dispatch axis is clearly
visible); point `--conf` at a real config to tune for a real model.
`--grid-k` / `--grid-prefetch` narrow the (steps_per_dispatch,
prefetch_stage) grid. `--dev` overrides the conf's `dev` (default: the
card).

Exit 0 on success (cache written), 1 on a search failure.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

_DEFAULT_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 64
  init_sigma = 0.1
layer[+1:sg1] = tanh
layer[sg1->fc2] = fullc:fc2
  nhidden = 10
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,36
batch_size = 64
eta = 0.1
silent = 1
seed = 11
"""

# bounded candidate grids: the cache is a default, not a proof - a
# coarse grid that always finishes beats an exhaustive one that
# blows the budget (per-cell step counts are sized from a timed
# probe step, bench.py _warm_and_size style)
_K_GRID = (1, 2, 4)
_PREFETCH_GRID = (0, 1, 2)
_SERVE_GRID = (8, 16, 32)


def _make_trainer(conf_pairs: Sequence[Tuple[str, str]],
                  extra: Sequence[Tuple[str, str]] = ()):
    """A trainer on the device the pairs' last `dev` names (the card
    when none does)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                               device_from_spec)
    pairs = list(conf_pairs) + list(extra)
    devs = [v for k, v in pairs if k == "dev"]
    tr = NetTrainer(device=device_from_spec(devs[-1]) if devs
                    else DEFAULT_DEVICE)
    for k, v in pairs:
        tr.set_param(k, v)
    tr.init_model()
    return tr


def _synth_batches(tr, n: int) -> List:
    """Synthetic host batches matching the trainer's input/label
    shape (labels sized from the final node's width so loss layers
    index valid classes)."""
    from cxxnet_tpu_torch.io.data import DataBatch
    c, y, x = tr.net_cfg.input_shape
    final = tr.net.node_shapes[tr.net_cfg.num_nodes - 1]
    nclass = max(2, int(np.prod(final[1:])))
    rng = np.random.RandomState(23)
    out = []
    for _ in range(n):
        out.append(DataBatch(
            data=rng.rand(tr.batch_size, c, y, x).astype(np.float32),
            label=rng.randint(0, nclass, size=(tr.batch_size, 1))
            .astype(np.float32)))
    return out


class _Cycle:
    """Minimal DataIter serving `n` host batches from a buffer."""

    def __init__(self, batches: List, n: int):
        self._b, self.n, self.i = batches, n, -1

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < self.n

    def value(self):
        return self._b[self.i % len(self._b)]


def measure_train_ips(tr, batches: List, k: int, prefetch: int,
                      budget_s: float) -> float:
    """e2e images/sec of the real update path at one
    (steps_per_dispatch, prefetch_stage) grid cell. K applies at the
    call level (update_chunk takes any chunk length), so one trainer
    serves the whole grid."""
    nbuf = len(batches)

    def run_steps(n: int) -> None:
        if prefetch > 0:
            pf = tr.prefetch(_Cycle(batches, n), prefetch, chunk=k)
            try:
                pf.before_first()
                while pf.next():
                    tr.update(pf.value())
            finally:
                pf.close()
        elif k > 1:
            for i in range(0, n, k):
                tr.update_chunk(
                    [batches[(i + j) % nbuf]
                     for j in range(min(k, n - i))])
        else:
            for i in range(n):
                tr.update(batches[i % nbuf])

    # warm (first launches, cuDNN's choices) + size the window from
    # one timed chunk
    run_steps(k)
    tr._sync()
    t0 = time.perf_counter()
    run_steps(k)
    tr._sync()
    per_step = max((time.perf_counter() - t0) / k, 1e-6)
    n = int(min(200, max(2 * k, budget_s / per_step)))
    t0 = time.perf_counter()
    run_steps(n)
    tr._sync()
    dt = max(time.perf_counter() - t0, 1e-9)
    return n * tr.batch_size / dt


def measure_serve_rows(tr, max_batch: int, budget_s: float,
                       ladder=None):
    """(rows/sec, stats) through a warmed continuous-batching Server
    at one bucket-ladder ceiling, under a mixed-size request storm.
    `ladder` passes an explicit bucket ladder (the shaped-ladder
    measurement); the stats carry the storm's request-size histogram
    (`request_sizes`) the ladder shaping reads."""
    from cxxnet_tpu_torch.serve import Server
    c, y, x = tr.net_cfg.input_shape
    rng = np.random.RandomState(29)
    data = rng.rand(max_batch, c, y, x).astype(np.float32)
    srv = Server(tr, max_batch=max_batch, max_wait_ms=2.0, replicas=2,
                 ladder=ladder, device=str(tr.device))
    srv.warmup()
    srv.start()
    try:
        sizes = [1, max_batch // 2 or 1, max_batch, 3,
                 max_batch // 4 or 1]
        # size the storm from one timed round of the cycle
        t0 = time.perf_counter()
        for n in sizes:
            srv.submit(data[:n]).result(timeout=120)
        per_round = max(time.perf_counter() - t0, 1e-6)
        rounds = int(min(50, max(2, budget_s / per_round)))
        total = 0
        t0 = time.perf_counter()
        futs = []
        for _ in range(rounds):
            for n in sizes:
                futs.append(srv.submit(data[:n]))
                total += n
        for f in futs:
            f.result(timeout=600)
        dt = max(time.perf_counter() - t0, 1e-9)
    finally:
        stats = srv.stop()
    if stats["errors"]:
        raise RuntimeError(f"{stats['errors']} serve dispatch errors")
    return total / dt, stats


def _measure_plan_ips(conf_pairs, extra, plan, batches,
                      budget_s: float) -> float:
    """e2e images/sec of a per-layer plan candidate, measured through
    the REAL pickup path: the plan is written to a temp tuning_cache
    and a fresh trainer replays it via `tuning_cache =` - so the
    search can never win with a plan the product would not apply."""
    import tempfile

    from cxxnet_tpu_torch.nnet import tuning
    fd, path = tempfile.mkstemp(suffix=".json", prefix="cxn_tune_")
    os.close(fd)
    os.unlink(path)
    try:
        tuning.save_entry(path, _platform(conf_pairs, extra), {},
                          layers=plan)
        tr = _make_trainer(conf_pairs,
                           list(extra) + [("tuning_cache", path)])
        return measure_train_ips(tr, batches, 1, 0, budget_s)
    finally:
        if os.path.exists(path):
            os.unlink(path)


def _measure_infer_plan_ips(conf_pairs, extra, plan, batches,
                            budget_s: float) -> float:
    """Inference images/sec of a per-layer plan candidate through the
    REAL pickup path (the `layer_quant` axis: quantization only
    touches the infer executables, so its candidates must be priced
    on predict, not update): temp tuning_cache, fresh trainer,
    calibrate on the first batch (quant/fold scales freeze there,
    outside the timed window), then a timed predict_dist loop."""
    import tempfile

    from cxxnet_tpu_torch.nnet import tuning
    fd, path = tempfile.mkstemp(suffix=".json", prefix="cxn_tune_")
    os.close(fd)
    os.unlink(path)
    try:
        tuning.save_entry(path, _platform(conf_pairs, extra), {},
                          layers=plan)
        tr = _make_trainer(conf_pairs,
                           list(extra) + [("tuning_cache", path)])
        tr.predict_dist(batches[0])  # first launches + calibrate
        t0 = time.perf_counter()
        tr.predict_dist(batches[0])
        per = max(time.perf_counter() - t0, 1e-6)
        n = int(min(100, max(3, budget_s / per)))
        t0 = time.perf_counter()
        for i in range(n):
            tr.predict_dist(batches[i % len(batches)])
        dt = max(time.perf_counter() - t0, 1e-9)
        return n * tr.batch_size / dt
    finally:
        if os.path.exists(path):
            os.unlink(path)


def per_layer_search(conf_pairs: Sequence[Tuple[str, str]],
                     budget_s: float,
                     extra: Sequence[Tuple[str, str]] = (),
                     max_layers: int = 6) -> Dict:
    """Bounded greedy per-layer knob search (docs/GRAPH_PASSES.md
    "per-layer autotuner"): for each named strided conv flip
    `space_to_depth` 0/1; on bf16 workloads running the autocast
    pass flip conv/fullc layers' `layer_dtype` to f32; on workloads
    running quantize_int8 flip eligible conv/fullc layers'
    `layer_quant` to float (int8 is the pass default - the search
    pins back the layers where it loses), priced on the INFER path.
    A flip joins the plan only when it beats the incumbent by > 2%
    (hysteresis: measurement noise must not churn plans). Returns
    {"layers": plan, "grid": per-candidate ips}."""
    import torch
    base = _make_trainer(conf_pairs, extra)
    cands: List[Tuple[str, str, Tuple[str, ...]]] = []
    autocast_on = (base.compute_dtype == torch.bfloat16
                   and base._pipeline is not None
                   and base._pipeline.has("autocast"))
    quant_on = (base._pipeline is not None
                and base._pipeline.has("quantize_int8"))
    for idx, info in enumerate(base.net_cfg.layers):
        if info.is_shared or not info.name:
            continue
        explicit = {k for k, _ in (base.net_cfg.defcfg
                                   + base.net_cfg.layercfg[idx])}
        lay = base.net.layer_objs[idx]
        if (info.type_name == "conv" and lay.param.stride > 1
                and "space_to_depth" not in explicit):
            cands.append((info.name, "space_to_depth", ("0", "1")))
        if (autocast_on and info.type_name in ("conv", "fullc")
                and "layer_dtype" not in explicit):
            cands.append((info.name, "layer_dtype", ("float32",)))
        if (quant_on and info.type_name in ("conv", "fullc")
                and "layer_quant" not in explicit):
            cands.append((info.name, "layer_quant", ("float",)))
    cands = cands[:max_layers]
    grid: Dict[str, float] = {}
    if not cands:
        return {"layers": {}, "grid": grid}
    batches = _synth_batches(base, 8)
    n_meas = 1 + sum(len(c[2]) for c in cands)
    per = max(1.0, budget_s / n_meas)
    plan: Dict[str, Dict[str, str]] = {}
    # two incumbents, one per measurement path: train-path flips
    # (s2d/dtype) and infer-path flips (quant) are priced against
    # their own baseline - the two clocks are not comparable
    best = _measure_plan_ips(conf_pairs, extra, {}, batches, per)
    grid["plan_default"] = round(best, 2)
    best_infer = None
    if any(key == "layer_quant" for _ln, key, _a in cands):
        best_infer = _measure_infer_plan_ips(conf_pairs, extra, {},
                                             batches, per)
        grid["plan_infer_default"] = round(best_infer, 2)
    infer_stale = False
    for lname, key, alts in cands:
        infer_axis = key == "layer_quant"
        for v in alts:
            if infer_axis and infer_stale:
                # a train-axis flip (s2d/dtype) joined the shared
                # plan since the infer incumbent was measured; those
                # flips change inference speed too, so re-base it or
                # the quant trial would be priced against the other
                # axis's infer-side gain. (The reverse never stales:
                # layer_quant only touches the infer executables.)
                best_infer = _measure_infer_plan_ips(
                    conf_pairs, extra, plan, batches, per)
                grid["plan_infer_rebase"] = round(best_infer, 2)
                infer_stale = False
            trial = {ln: dict(kv) for ln, kv in plan.items()}
            trial.setdefault(lname, {})[key] = v
            measure = (_measure_infer_plan_ips if infer_axis
                       else _measure_plan_ips)
            ips = measure(conf_pairs, extra, trial, batches, per)
            grid[f"{lname}.{key}={v}"] = round(ips, 2)
            if infer_axis:
                if ips > best_infer * 1.02:
                    best_infer = ips
                    plan = trial
            elif ips > best * 1.02:
                best = ips
                plan = trial
                infer_stale = True
    out = {"layers": plan, "grid": grid,
           "plan_best_ips": round(best, 2)}
    if best_infer is not None:
        out["plan_infer_best_ips"] = round(best_infer, 2)
    return out


def search(conf_pairs: Sequence[Tuple[str, str]], budget_s: float,
           serve: bool = True, per_layer: bool = True,
           extra: Sequence[Tuple[str, str]] = (),
           k_grid: Sequence[int] = _K_GRID,
           prefetch_grid: Sequence[int] = _PREFETCH_GRID) -> Dict:
    """Run the bounded knob search; returns {knobs, measured, layers,
    serve_ladder}. The `default_ips` cell (K=1, prefetch_stage=1 -
    the shipped defaults) is always measured first so
    `tuned_over_default` is an in-window ratio, never a cross-run
    comparison."""
    tr = _make_trainer(conf_pairs, extra)
    batches = _synth_batches(tr, 8)
    cells = [(k, p) for k in k_grid for p in prefetch_grid]
    knob_share = 0.7 - (0.2 if per_layer else 0.0)
    per_cell = max(1.0, budget_s * knob_share / len(cells))
    measured: Dict[str, float] = {}
    grid: Dict[str, float] = {}
    best = (None, -1.0)
    for k, p in cells:
        ips = measure_train_ips(tr, batches, k, p, per_cell)
        grid[f"k{k}_p{p}"] = round(ips, 2)
        if k == 1 and p == 1:
            measured["default_ips"] = round(ips, 2)
        if ips > best[1]:
            best = ((k, p), ips)
    (bk, bp), best_ips = best
    measured["best_ips"] = round(best_ips, 2)
    knobs: Dict[str, object] = {"steps_per_dispatch": bk,
                                "prefetch_stage": bp}
    layers: Dict[str, Dict[str, str]] = {}
    serve_ladder = None
    if per_layer:
        pl = per_layer_search(conf_pairs, budget_s * 0.2, extra)
        layers = pl["layers"]
        grid.update(pl["grid"])
        if "plan_best_ips" in pl:
            measured["plan_best_ips"] = pl["plan_best_ips"]
        if "plan_infer_best_ips" in pl:
            measured["plan_infer_best_ips"] = pl["plan_infer_best_ips"]
    if serve:
        from cxxnet_tpu_torch.serve import ladder_from_histogram
        sbest = (None, -1.0)
        hist: Dict[int, int] = {}
        per_mb = max(1.0, budget_s * 0.25 / (len(_SERVE_GRID) + 1))
        for mb in _SERVE_GRID:
            rows, stats = measure_serve_rows(tr, mb, per_mb)
            grid[f"serve_mb{mb}"] = round(rows, 2)
            for s, c in stats.get("request_sizes", {}).items():
                hist[int(s)] = hist.get(int(s), 0) + int(c)
            if rows > sbest[1]:
                sbest = (mb, rows)
        knobs["serve_max_batch"] = sbest[0]
        measured["serve_rows_per_s"] = round(sbest[1], 2)
        # ladder shaped from the storm's own request-size telemetry
        # (docs/SERVING.md "bucket ladder"): adopted only when it does
        # not lose to the power-of-two set at the winning ceiling;
        # rungs ceil to the trainer's data axis so the measured ladder
        # is the persisted one
        shaped = ladder_from_histogram(hist, sbest[0], tr.serve_data_axis)
        rows2, _st = measure_serve_rows(tr, sbest[0], per_mb,
                                        ladder=shaped)
        grid["serve_shaped_ladder"] = round(rows2, 2)
        if rows2 >= 0.98 * sbest[1]:
            serve_ladder = list(shaped)
            measured["serve_ladder_rows_per_s"] = round(rows2, 2)
    import torch
    if tr.compute_dtype == torch.bfloat16:
        # the staged-input layout axis: bf16 host cast vs f32 bytes
        ips_by_layout = {}
        for layout in ("", "float32"):
            trl = _make_trainer(conf_pairs,
                                list(extra)
                                + [("stage_dtype", layout)])
            ips_by_layout[layout] = measure_train_ips(
                trl, _synth_batches(trl, 8), bk, bp,
                max(1.0, budget_s * 0.1))
        knobs["stage_dtype"] = max(ips_by_layout,
                                   key=ips_by_layout.get)
        grid["stage_dtype_ips"] = {
            k or "bfloat16": round(v, 2)
            for k, v in ips_by_layout.items()}
    measured["grid"] = grid
    return {"knobs": knobs, "measured": measured, "layers": layers,
            "serve_ladder": serve_ladder}


def _platform(conf_pairs, extra) -> str:
    """The cache's platform key of the trainer the pairs build."""
    from cxxnet_tpu_torch.nnet import tuning
    from cxxnet_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                               device_from_spec)
    devs = [v for k, v in list(conf_pairs) + list(extra) if k == "dev"]
    return tuning.platform_name(device_from_spec(devs[-1]) if devs
                                else DEFAULT_DEVICE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=os.path.join("models",
                                         "tuning_cache.json"))
    ap.add_argument("--conf", default="",
                    help="workload config (default: builtin tiny MLP)")
    ap.add_argument("--budget-secs", type=float, default=60.0)
    ap.add_argument("--serve", type=int, default=1)
    ap.add_argument("--per-layer", type=int, default=1,
                    help="greedy per-layer s2d/dtype plan search "
                    "(schema-v2 'layers' cache entries)")
    ap.add_argument("--dev", default="",
                    help="device (default: the conf's dev, the card)")
    ap.add_argument("--grid-k", default=",".join(map(str, _K_GRID)))
    ap.add_argument("--grid-prefetch",
                    default=",".join(map(str, _PREFETCH_GRID)))
    args = ap.parse_args(argv)
    from cxxnet_tpu_torch.nnet import tuning
    from cxxnet_tpu_torch.utils.config import (parse_config_file,
                                               parse_config_string)
    pairs = (parse_config_file(args.conf) if args.conf
             else parse_config_string(_DEFAULT_CONF))
    extra = [("dev", args.dev)] if args.dev else []
    platform = _platform(pairs, extra)
    kind = "cpu"
    if platform == "gpu":
        import torch
        kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    try:
        result = search(
            pairs, args.budget_secs, serve=bool(args.serve),
            per_layer=bool(args.per_layer), extra=extra,
            k_grid=[int(v) for v in args.grid_k.split(",")],
            prefetch_grid=[int(v) for v in args.grid_prefetch.split(",")])
    except Exception as e:  # noqa: BLE001 - CLI surface: say what broke
        print(f"autotune: search failed: {type(e).__name__}: {e}")
        return 1
    tuning.save_entry(args.out, platform, result["knobs"],
                      result["measured"], device_kind=kind,
                      layers=result.get("layers") or {},
                      serve_ladder=result.get("serve_ladder"))
    dt = time.perf_counter() - t0
    m = result["measured"]
    speedup = (m["best_ips"] / m["default_ips"]
               if m.get("default_ips") else float("nan"))
    print(f"autotune[{platform}]: best {result['knobs']} "
          f"({m['best_ips']} img/s, {speedup:.2f}x over default) "
          f"in {dt:.1f}s -> {args.out}")
    if result.get("layers"):
        print(f"  per-layer plan: {result['layers']}")
    if result.get("serve_ladder"):
        print(f"  serve ladder: {result['serve_ladder']}")
    print("  use it with: tuning_cache = " + args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
