"""Render request-trace telemetry to Chrome trace-event JSON (the port's
copy of cxxnet_tpu/tools/trace_export.py: the same JSON on the same
events).

    python -m cxxnet_tpu_torch.tools.trace_export run.events.jsonl \
        -o trace.json [--summary-json summary.json]

The serving layer's end-to-end request tracing
(docs/OBSERVABILITY.md "Request tracing") emits one ``trace`` event
per resolved request part on the event stream (``log_file=``): the
trace id minted at ``Server.submit``, the part/parts split indices of
an oversize request, the bucket + executable fingerprint it
dispatched under, and the monotonic ``t_submit`` / ``t_collect`` /
``t_dispatch`` / ``t_done`` stamps that cut each request into its
**queue** phase (submit -> dispatch, incl. the fill-or-timeout
coalesce wait) and **device** phase (dispatch -> result). This
tool renders those records into the Chrome trace-event format
(``{"traceEvents": [...]}``) loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

- one timeline lane per in-flight request slot (requests reuse freed
  lanes, so a storm renders as a compact band instead of 10k rows);
- per request part a parent ``request <id>`` span with nested
  ``queue`` and ``device`` child spans, args carrying rows / bucket /
  fingerprint / part indices;
- ``watchdog`` stall-dump and ``serve`` warmup/summary events as
  instant markers, so a hang investigation sees the dump next to the
  requests it interrupted.

A latency summary (count, queue/device/total p50+p99 ms, per-bucket
dispatch counts) prints to stdout and optionally lands in
``--summary-json`` - the p99-decomposes-into-queue-vs-device number
the serving SLO story wants. Timestamps are normalized to the first
record so the monotonic clock's epoch never leaks into the trace.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

from cxxnet_tpu_torch.telemetry.registry import _percentile
from cxxnet_tpu_torch.telemetry.sink import read_jsonl


def collect_traces(records) -> Tuple[List[Dict[str, Any]],
                                     List[Dict[str, Any]]]:
    """(trace part records, marker records) out of an event stream."""
    parts: List[Dict[str, Any]] = []
    markers: List[Dict[str, Any]] = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "trace" and "t_submit" in rec and "t_done" in rec:
            parts.append(rec)
        elif kind == "watchdog" and rec.get("op") == "stall_dump":
            markers.append(rec)
        elif kind == "serve" and rec.get("op") in ("warmup", "summary"):
            markers.append(rec)
    return parts, markers


def _lane_assign(parts: List[Dict[str, Any]]) -> Dict[Tuple, int]:
    """Greedy interval-graph coloring: each request part gets the
    lowest lane free over its [t_submit, t_done) interval, so
    concurrent requests stack and sequential ones reuse lanes."""
    order = sorted(parts, key=lambda r: float(r["t_submit"]))
    lane_free_at: List[float] = []
    lanes: Dict[Tuple, int] = {}
    for rec in order:
        t0 = float(rec["t_submit"])
        t1 = float(rec["t_done"])
        for i, free in enumerate(lane_free_at):
            if free <= t0:
                lane_free_at[i] = t1
                lanes[(rec.get("trace"), rec.get("part", 0))] = i
                break
        else:
            lane_free_at.append(t1)
            lanes[(rec.get("trace"), rec.get("part", 0))] = (
                len(lane_free_at) - 1)
    return lanes


def build_chrome_trace(parts: List[Dict[str, Any]],
                       markers: List[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Chrome trace-event JSON ({"traceEvents": [...]}) from trace
    part records: "X" complete events (ts/dur in microseconds) on one
    process, one lane (tid) per concurrent request slot."""
    events: List[Dict[str, Any]] = []
    if not parts and not markers:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    # markers carry WALL ts while trace spans carry monotonic stamps.
    # Every part record carries BOTH (its record-level `ts` is stamped
    # at emission, within ~the event-write latency of its monotonic
    # t_done), so the wall->monotonic offset is derivable and the two
    # populations share ONE timeline - a stall dump renders next to
    # the requests it actually interrupted, not shifted by the
    # process-start gap. With no parts, markers anchor to their own
    # minimum (nothing to align against).
    offsets = sorted(float(r["ts"]) - float(r["t_done"])
                     for r in parts if "ts" in r)
    mono_base = min((float(r["t_submit"]) for r in parts),
                    default=0.0)
    if offsets:
        wall_off = offsets[len(offsets) // 2]
        marker_mono = [(float(r.get("ts", 0)) - wall_off, r)
                       for r in markers]
        mono_base = min([mono_base]
                        + [t for t, _ in marker_mono])
    else:
        wall_base = min((float(r.get("ts", 0)) for r in markers),
                        default=0.0)
        marker_mono = [(float(r.get("ts", 0)) - wall_base, r)
                       for r in markers]
        mono_base = 0.0
    lanes = _lane_assign(parts)
    pids = {rec.get("pid", 0) for rec in parts} or {0}
    for pid in sorted(pids):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"cxxnet serve (pid {pid})"}})
    for rec in parts:
        pid = rec.get("pid", 0)
        tid = lanes[(rec.get("trace"), rec.get("part", 0))]
        t_submit = float(rec["t_submit"]) - mono_base
        # the queue/device cut is the DISPATCH stamp (older streams
        # without it fall back to the coalesce stamp)
        cut = rec.get("t_dispatch",
                      rec.get("t_collect", rec["t_submit"]))
        t_cut = float(cut) - mono_base
        t_done = float(rec["t_done"]) - mono_base
        trace_id = rec.get("trace", "?")
        label = (f"request {trace_id}"
                 + (f" [{rec.get('part', 0) + 1}/{rec['parts']}]"
                    if rec.get("parts", 1) > 1 else ""))
        args = {"trace": trace_id, "rows": rec.get("rows"),
                "bucket": rec.get("bucket"), "fp": rec.get("fp"),
                "part": rec.get("part", 0),
                "parts": rec.get("parts", 1),
                "queue_ms": rec.get("queue_ms"),
                "device_ms": rec.get("device_ms")}
        events.append({"ph": "X", "name": label, "cat": "request",
                       "pid": pid, "tid": tid,
                       "ts": round(t_submit * 1e6, 3),
                       "dur": round((t_done - t_submit) * 1e6, 3),
                       "args": args})
        events.append({"ph": "X", "name": "queue", "cat": "queue",
                       "pid": pid, "tid": tid,
                       "ts": round(t_submit * 1e6, 3),
                       "dur": round((t_cut - t_submit) * 1e6, 3),
                       "args": {"trace": trace_id}})
        events.append({"ph": "X", "name": "device", "cat": "device",
                       "pid": pid, "tid": tid,
                       "ts": round(t_cut * 1e6, 3),
                       "dur": round((t_done - t_cut) * 1e6, 3),
                       "args": {"trace": trace_id,
                                "fp": rec.get("fp"),
                                "bucket": rec.get("bucket")}})
    for mono, rec in marker_mono:
        pid = rec.get("pid", 0)
        ts = (mono - mono_base) * 1e6
        name = ("watchdog stall_dump"
                if rec.get("kind") == "watchdog"
                else f"serve {rec.get('op')}")
        events.append({"ph": "i", "name": name, "cat": "marker",
                       "pid": pid, "tid": 0, "ts": round(ts, 3),
                       "s": "p"})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def summarize(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Queue-vs-device latency decomposition over the traced parts."""
    queue = [float(r.get("queue_ms", 0.0)) for r in parts]
    device = [float(r.get("device_ms", 0.0)) for r in parts]
    total = [(float(r["t_done"]) - float(r["t_submit"])) * 1e3
             for r in parts]
    by_bucket: Dict[str, int] = {}
    traces = set()
    complete = 0
    by_trace: Dict[str, set] = {}
    want_parts: Dict[str, int] = {}
    for r in parts:
        b = str(r.get("bucket"))
        by_bucket[b] = by_bucket.get(b, 0) + 1
        t = r.get("trace")
        traces.add(t)
        by_trace.setdefault(t, set()).add(r.get("part", 0))
        want_parts[t] = int(r.get("parts", 1))
    for t, seen in by_trace.items():
        if len(seen) == want_parts.get(t, 1):
            complete += 1
    out = {"parts": len(parts), "requests": len(traces),
           "complete_requests": complete,
           "dispatches_by_bucket": dict(sorted(by_bucket.items()))}
    for name, vals in (("queue", queue), ("device", device),
                       ("total", total)):
        if vals:
            # registry._percentile is THE percentile definition
            # (numpy's linear interpolation) - the summary's p99 must
            # match the Histogram p99 the registry reports for the
            # same stream; it takes pre-sorted values
            vals = sorted(vals)
            out[f"{name}_p50_ms"] = round(_percentile(vals, 50), 3)
            out[f"{name}_p99_ms"] = round(_percentile(vals, 99), 3)
    return out


def export(events_path: str, out_path: str,
           summary_path: str = "") -> Dict[str, Any]:
    parts, markers = collect_traces(read_jsonl(events_path))
    trace = build_chrome_trace(parts, markers)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    summary = summarize(parts)
    if summary_path:
        with open(summary_path, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render request-trace events to Chrome "
                    "trace-event JSON (Perfetto-loadable)")
    ap.add_argument("events", help="telemetry event JSONL (log_file=)")
    ap.add_argument("-o", "--out", default="trace.json",
                    help="output Chrome trace path")
    ap.add_argument("--summary-json", default="",
                    help="also write the latency summary JSON here")
    args = ap.parse_args(argv)
    summary = export(args.events, args.out, args.summary_json)
    if not summary["parts"]:
        print(f"trace_export: no trace events in {args.events} "
              "(serve with log_file= armed to record request traces)")
        return 1
    print(f"trace_export: {summary['parts']} part span(s) over "
          f"{summary['requests']} request(s) "
          f"({summary['complete_requests']} complete) -> {args.out}")
    for stem in ("queue", "device", "total"):
        if f"{stem}_p50_ms" in summary:
            print(f"  {stem:>6}: p50 {summary[f'{stem}_p50_ms']} ms, "
                  f"p99 {summary[f'{stem}_p99_ms']} ms")
    print(f"  dispatches by bucket: {summary['dispatches_by_bucket']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
