"""Summarize telemetry metrics JSONL stream(s) into per-round tables.
The port's copy of cxxnet_tpu/tools/metrics_report.py: the same output on the
same input.

    python -m cxxnet_tpu_torch.tools.metrics_report metrics.jsonl
    python -m cxxnet_tpu_torch.tools.metrics_report host0.jsonl host1.jsonl
    python -m cxxnet_tpu_torch.tools.metrics_report metrics.jsonl --json

Input is the ``metrics_file=`` stream a training run emits
(docs/OBSERVABILITY.md): per-round ``round`` records carrying step/data
timing stats plus a full registry snapshot, and a terminal ``final``
snapshot. Several files - a pod run's per-host streams - merge on
their ``ts`` + process tags (every record carries host/pid/proc), so
no manual ``cat | sort`` is needed and the per-process counter deltas
stay correct across the interleave. Output is a per-round
throughput/latency table (with a proc column once more than one
process appears), per-round deltas of the interesting counters
(checkpoint saves, retries, NaN rollbacks), and a final-counter
summary per process. ``--json`` renders the same aggregation as one
JSON object for scripting.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence, Union

from cxxnet_tpu_torch.telemetry.sink import read_jsonl

# counters reported as per-round deltas in the table footer columns
DELTA_COUNTERS = [
    ("checkpoint.saves", "saves"),
    ("fault.retry", "retries"),
    ("fault.nan_rollback", "nan_rb"),
    ("io.prefetch.stalls", "stalls"),
]


def _counter(metrics: Dict, name: str) -> int:
    v = metrics.get(name, 0)
    return int(v) if isinstance(v, (int, float)) else 0


def _hist_stat(metrics: Dict, name: str, stat: str) -> Optional[float]:
    h = metrics.get(name)
    if isinstance(h, dict):
        v = h.get(stat)
        return float(v) if v is not None else None
    return None


def _read_merged(paths: Sequence[str]) -> List[Dict]:
    """All records of all streams, merged on ts (stable: same-ts
    records keep their file order). Per-host pod streams each carry a
    monotone-nondecreasing ts, so a plain sort IS the timeline merge;
    the proc tags on each record keep per-process accounting apart
    downstream."""
    recs: List[Dict] = []
    for p in paths:
        recs.extend(read_jsonl(p))
    recs.sort(key=lambda r: (r.get("ts")
                             if isinstance(r.get("ts"), (int, float))
                             else 0.0))
    return recs


def aggregate(paths: Union[str, Sequence[str]]) -> Dict:
    """Parse metrics JSONL stream(s) into {rounds: [...], finals:
    {...}}. A single path or a list of per-host paths (merged on
    ts+proc tags).

    `finals` is keyed by "host/pid": counters are per-process, so on a
    merged multi-process stream one last-record-wins snapshot would
    silently report a single process's totals as the run's."""
    if isinstance(paths, str):
        paths = [paths]
    rounds: List[Dict] = []
    finals: Dict[str, Dict] = {}
    # counters are PER-PROCESS (the registry dies with the process) and
    # the streams are append-mode, so a resumed run restarts every
    # counter at zero mid-file; deltas must be tracked per (host, pid)
    # or a post-resume record would mis-subtract the dead process's
    # totals (under- or over-counting depending on magnitudes)
    prev_by_proc: Dict[str, Dict[str, int]] = {}
    for rec in _read_merged(paths):
        kind = rec.get("kind")
        metrics = rec.get("metrics") or {}
        if kind == "round":
            proc_key = f"{rec.get('host')}/{rec.get('pid')}"
            prev_counters = prev_by_proc.setdefault(proc_key, {})
            row = {
                "proc": proc_key,
                "round": rec.get("round"),
                "steps": rec.get("steps"),
                "examples": rec.get("examples"),
                "images_per_sec": rec.get("images_per_sec"),
                "step_p50_ms": rec.get("step_p50_ms"),
                "step_p99_ms": rec.get("step_p99_ms"),
                "data_total_ms": rec.get("data_total_ms"),
                "ckpt_save_s": _hist_stat(metrics, "checkpoint.save_s",
                                          "p50"),
            }
            for cname, label in DELTA_COUNTERS:
                cur = _counter(metrics, cname)
                row[label] = cur - prev_counters.get(cname, 0)
                prev_counters[cname] = cur
            rounds.append(row)
        elif kind in ("final", "heartbeat", "metrics"):
            # newest snapshot wins PER PROCESS (the `final` record on a
            # clean close; the last heartbeat after a preemption)
            if metrics:
                finals[f"{rec.get('host')}/{rec.get('pid')}"] = metrics
    return {"rounds": rounds, "finals": finals}


def _fmt(v, width: int, prec: int = 1) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.{prec}f}".rjust(width)
    return str(v).rjust(width)


def render(agg: Dict) -> str:
    lines: List[str] = []
    multi_proc = len({r["proc"] for r in agg["rounds"]}) > 1 \
        or len(agg["finals"]) > 1
    cols = ([("proc", 16)] if multi_proc else []) + \
           [("round", 5), ("steps", 6), ("examples", 8),
            ("img/s", 9), ("p50ms", 8), ("p99ms", 8),
            ("data_ms", 8), ("save_s", 7)] + \
           [(label, 7) for _, label in DELTA_COUNTERS]
    if agg["rounds"]:
        lines.append("per-round summary:")
        lines.append("  " + " ".join(name.rjust(w) for name, w in cols))
        for row in agg["rounds"]:
            vals = ([row["proc"].rjust(16)] if multi_proc else []) + [
                _fmt(row["round"], 5), _fmt(row["steps"], 6),
                _fmt(row["examples"], 8),
                _fmt(row["images_per_sec"], 9),
                _fmt(row["step_p50_ms"], 8, 2),
                _fmt(row["step_p99_ms"], 8, 2),
                _fmt(row["data_total_ms"], 8),
                _fmt(row["ckpt_save_s"], 7, 3),
            ] + [_fmt(row[label], 7) for _, label in DELTA_COUNTERS]
            lines.append("  " + " ".join(vals))
    else:
        lines.append("no per-round records found")
    for proc_key in sorted(agg["finals"]):
        final = agg["finals"][proc_key]
        lines.append("")
        lines.append("final counters/gauges"
                     + (f" [{proc_key}]" if multi_proc else "") + ":")
        for name in sorted(final):
            v = final[name]
            if isinstance(v, dict):
                p50 = v.get("p50")
                p99 = v.get("p99")
                lines.append(
                    f"  {name}: count={v.get('count')} "
                    f"sum={_fmt(v.get('sum'), 1, 4).strip()} "
                    f"p50={_fmt(p50, 1, 4).strip()} "
                    f"p99={_fmt(p99, 1, 4).strip()}")
            else:
                lines.append(f"  {name}: {v}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    as_json = "--json" in argv
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print(__doc__)
        return 1
    agg = aggregate(paths)
    if as_json:
        print(json.dumps(agg, indent=2, default=str))
    else:
        print(render(agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
