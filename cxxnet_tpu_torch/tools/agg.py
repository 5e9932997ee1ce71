"""Live cross-host telemetry aggregation (docs/OBSERVABILITY.md).
The port's copy of cxxnet_tpu/tools/agg.py: the same output on the
same input.

    python -m cxxnet_tpu_torch.tools.agg host0.metrics.jsonl host1.metrics.jsonl
    python -m cxxnet_tpu_torch.tools.agg http://tpu-a:9100 http://tpu-b:9100 --follow
    python -m cxxnet_tpu_torch.tools.agg run*.jsonl --json

Before this tool, a multi-host run's telemetry story was OFFLINE:
per-host JSONL streams merged by ``sort -k ts`` after the fact (the
ROADMAP pod item's open end). This tool is the live view: each source
is either a per-host metrics JSONL (tailed incrementally - ``--follow``
keeps reading as the run appends) or a live process's ``/varz``
endpoint (scraped per poll; same record schema by construction), and
every poll renders ONE merged cluster table:

- one row per process (host/pid): record age, round, steps, step
  p50/p99 ms, images/sec, loss, NaN rollbacks, serve queue depth;
- a **step-time spread** line: max/min of per-host step p50 and the
  ratio between them - the straggler signal (arXiv:2004.13336
  multi-controller training runs at the speed of its slowest host);
- hosts whose p50 exceeds ``--straggler-factor`` x the cluster median
  are flagged ``STRAGGLER``; hosts silent past ``--stale-secs`` are
  flagged ``STALE`` (preempted / wedged / partitioned).

``--follow`` re-polls every ``--interval`` seconds and reprints;
``--json`` emits the merged state as one JSON object for scripting.

``--verdict-json`` is the detection-to-DECISION surface (the elastic
supervisor's conviction input, parallel/elastic.py): one JSON object
whose ``restart`` list names every process the aggregation convicts -
``stale`` (silent past ``--stale-secs``: preempted / wedged /
partitioned) or ``straggler`` (step p50 past ``--straggler-factor`` x
the cluster median). Exit status 3 when a restart is recommended, 0
when the pod is healthy - scriptable both ways.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

STALE_SECS = 60.0
STRAGGLER_FACTOR = 1.5


class _JsonlSource:
    """Incremental tail of one per-host metrics JSONL: every poll
    parses only the bytes appended since the last one, and a torn
    last line (writer mid-record) stays unconsumed until its newline
    arrives."""

    def __init__(self, path: str) -> None:
        self.name = path
        self.path = path
        self.errors = 0
        self._pos = 0
        self._buf = ""

    def poll(self) -> List[Dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                f.seek(self._pos)
                chunk = f.read()
                self._pos = f.tell()
        except OSError:
            self.errors += 1
            return []
        self._buf += chunk
        out: List[Dict] = []
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # corrupt line: skip, like read_jsonl
            if isinstance(rec, dict):
                out.append(rec)
        return out


class _VarzSource:
    """One live process's /varz endpoint; each poll yields one
    metrics-stream-schema record (http.py builds it that way, so file
    tails and live scrapes feed the same ingest)."""

    def __init__(self, url: str) -> None:
        base = url if "://" in url else f"http://{url}"
        if not base.rstrip("/").endswith("/varz"):
            base = base.rstrip("/") + "/varz"
        self.name = base
        self.url = base
        self.errors = 0

    def poll(self) -> List[Dict]:
        try:
            with urllib.request.urlopen(self.url, timeout=2.0) as r:
                rec = json.load(r)
        except (OSError, ValueError, urllib.error.URLError):
            self.errors += 1
            return []
        return [rec] if isinstance(rec, dict) else []


def make_source(spec: str):
    """`http://...` / `host:port` scrape /varz; anything else tails a
    JSONL file."""
    if "://" in spec:
        return _VarzSource(spec)
    head, _, tail = spec.rpartition(":")
    if head and tail.isdigit():
        return _VarzSource(spec)
    return _JsonlSource(spec)


def _hist(metrics: Dict, name: str, stat: str) -> Optional[float]:
    h = metrics.get(name)
    if isinstance(h, dict):
        v = h.get(stat)
        return float(v) if v is not None else None
    return None


def _num(metrics: Dict, name: str) -> Optional[float]:
    v = metrics.get(name)
    return float(v) if isinstance(v, (int, float)) else None


class HostState:
    """Latest view of one process, merged from its records on
    ts+proc tags (key = host/pid, the stream's process identity)."""

    def __init__(self, key: str) -> None:
        self.key = key
        self.proc: object = "?"
        self.last_ts = 0.0
        self.round: Optional[int] = None
        self.steps: Optional[int] = None
        self.step_p50_ms: Optional[float] = None
        self.step_p99_ms: Optional[float] = None
        self.images_per_sec: Optional[float] = None
        self.loss: Optional[float] = None
        self.nan_rollbacks: Optional[int] = None
        self.queue_depth: Optional[float] = None
        # counter-delta rate fallback for varz scrapes (no per-round
        # images_per_sec field on a bare registry snapshot)
        self._prev_images: Optional[float] = None
        self._prev_ts: Optional[float] = None

    def ingest(self, rec: Dict) -> None:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)) or ts < self.last_ts:
            # merge discipline: records apply in ts order; a late
            # cross-source replay of older state must not regress the
            # live row
            return
        self.last_ts = float(ts)
        if "proc" in rec:
            self.proc = rec.get("proc")
        if rec.get("kind") == "round":
            if rec.get("round") is not None:
                self.round = rec.get("round")
            if rec.get("images_per_sec") is not None:
                self.images_per_sec = rec.get("images_per_sec")
        metrics = rec.get("metrics")
        if not isinstance(metrics, dict):
            return
        h = metrics.get("train.step_s")
        if isinstance(h, dict):
            if h.get("count") is not None:
                self.steps = int(h["count"])
            p50 = _hist(metrics, "train.step_s", "p50")
            p99 = _hist(metrics, "train.step_s", "p99")
            self.step_p50_ms = p50 * 1e3 if p50 is not None else None
            self.step_p99_ms = p99 * 1e3 if p99 is not None else None
        if _num(metrics, "train.loss") is not None:
            self.loss = _num(metrics, "train.loss")
        if _num(metrics, "fault.nan_rollback") is not None:
            self.nan_rollbacks = int(_num(metrics, "fault.nan_rollback"))
        if _num(metrics, "serve.queue_depth") is not None:
            self.queue_depth = _num(metrics, "serve.queue_depth")
        images = _num(metrics, "train.images")
        if images is not None:
            if (self._prev_images is not None
                    and self._prev_ts is not None
                    and self.last_ts > self._prev_ts
                    and images > self._prev_images):
                self.images_per_sec = round(
                    (images - self._prev_images)
                    / (self.last_ts - self._prev_ts), 1)
            self._prev_images, self._prev_ts = images, self.last_ts


class Aggregator:
    def __init__(self, sources, stale_secs: float = STALE_SECS,
                 straggler_factor: float = STRAGGLER_FACTOR) -> None:
        self.sources = sources
        self.hosts: Dict[str, HostState] = {}
        self.stale_secs = stale_secs
        self.straggler_factor = straggler_factor

    def poll(self) -> int:
        n = 0
        for src in self.sources:
            for rec in src.poll():
                self.ingest(rec)
                n += 1
        return n

    def ingest(self, rec: Dict) -> None:
        key = f"{rec.get('host')}/{rec.get('pid')}"
        st = self.hosts.get(key)
        if st is None:
            st = self.hosts[key] = HostState(key)
        st.ingest(rec)

    # -- analysis ----------------------------------------------------------
    def spread(self) -> Optional[Dict[str, float]]:
        """Per-host step-p50 spread: {min, max, median, ratio}."""
        vals = sorted(h.step_p50_ms for h in self.hosts.values()
                      if h.step_p50_ms is not None)
        if not vals:
            return None
        mid = vals[len(vals) // 2] if len(vals) % 2 else \
            0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
        return {"min_ms": vals[0], "max_ms": vals[-1], "median_ms": mid,
                "ratio": vals[-1] / vals[0] if vals[0] > 0
                else float("inf")}

    def flags(self, host: HostState, now: float) -> List[str]:
        out = []
        if host.last_ts and now - host.last_ts > self.stale_secs:
            out.append("STALE")
        sp = self.spread()
        if (sp is not None and host.step_p50_ms is not None
                and len(self.hosts) > 1
                and host.step_p50_ms
                > self.straggler_factor * sp["median_ms"]):
            out.append("STRAGGLER")
        return out

    def to_dict(self, now: Optional[float] = None) -> Dict:
        # graftlint: disable=GL004 record ages compare against the streams' wall-clock ts tags
        now = time.time() if now is None else now
        hosts = {}
        for key in sorted(self.hosts):
            h = self.hosts[key]
            hosts[key] = {
                "proc": h.proc,
                "age_s": round(now - h.last_ts, 1) if h.last_ts else None,
                "round": h.round, "steps": h.steps,
                "step_p50_ms": h.step_p50_ms,
                "step_p99_ms": h.step_p99_ms,
                "images_per_sec": h.images_per_sec,
                "loss": h.loss, "nan_rollbacks": h.nan_rollbacks,
                "queue_depth": h.queue_depth,
                "flags": self.flags(h, now),
            }
        return {"hosts": hosts, "spread": self.spread(),
                "source_errors": {s.name: s.errors
                                  for s in self.sources if s.errors}}

    def verdict(self, now: Optional[float] = None) -> Dict:
        """Machine-readable restart recommendation: the cluster state
        (to_dict) plus a ``restart`` list - one entry per process the
        flags convict, with the evidence (record age for STALE, p50
        ratio vs the cluster median for STRAGGLER). Deterministic in
        ``now`` so tests pin it with a fake clock."""
        d = self.to_dict(now)
        sp = d["spread"]
        restart = []
        for key, h in d["hosts"].items():
            if "STALE" in h["flags"]:
                restart.append({
                    "host": key, "reason": "stale",
                    "age_s": h["age_s"],
                    "stale_secs": self.stale_secs})
            elif "STRAGGLER" in h["flags"]:
                ratio = (h["step_p50_ms"] / sp["median_ms"]
                         if sp and sp["median_ms"] else None)
                restart.append({
                    "host": key, "reason": "straggler",
                    "step_p50_ms": h["step_p50_ms"],
                    "median_ms": sp["median_ms"] if sp else None,
                    "ratio": round(ratio, 2) if ratio else None,
                    "straggler_factor": self.straggler_factor})
        d["restart"] = restart
        return d

    # -- rendering ---------------------------------------------------------
    def render(self, now: Optional[float] = None) -> str:
        d = self.to_dict(now)
        if not d["hosts"]:
            return "no records yet"
        cols = [("host/pid", 22), ("proc", 4), ("age_s", 6),
                ("round", 5), ("steps", 7), ("p50ms", 8), ("p99ms", 8),
                ("img/s", 8), ("loss", 8), ("nan_rb", 6), ("queue", 6)]
        lines = ["  " + " ".join(n.rjust(w) for n, w in cols)]

        def fmt(v, w, prec=1):
            if v is None:
                return "-".rjust(w)
            if isinstance(v, float):
                return f"{v:.{prec}f}".rjust(w)
            return str(v).rjust(w)

        for key, h in d["hosts"].items():
            flags = (" " + ",".join(h["flags"])) if h["flags"] else ""
            lines.append("  " + " ".join([
                key[-22:].rjust(22), fmt(h["proc"], 4),
                fmt(h["age_s"], 6), fmt(h["round"], 5),
                fmt(h["steps"], 7), fmt(h["step_p50_ms"], 8, 2),
                fmt(h["step_p99_ms"], 8, 2),
                fmt(h["images_per_sec"], 8),
                fmt(h["loss"], 8, 4), fmt(h["nan_rollbacks"], 6),
                fmt(h["queue_depth"], 6, 0)]) + flags)
        sp = d["spread"]
        if sp is not None and len(d["hosts"]) > 1:
            lines.append(
                f"  step p50 spread: {sp['min_ms']:.2f}-"
                f"{sp['max_ms']:.2f} ms (median {sp['median_ms']:.2f},"
                f" max/min {sp['ratio']:.2f}x)")
        for name, n in d["source_errors"].items():
            lines.append(f"  source {name}: {n} poll error(s)")
        return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    follow = "--follow" in argv
    as_json = "--json" in argv
    as_verdict = "--verdict-json" in argv
    interval = 2.0
    stale = STALE_SECS
    factor = STRAGGLER_FACTOR
    paths: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--interval":
            interval = float(argv[i + 1])
            i += 2
        elif a == "--stale-secs":
            stale = float(argv[i + 1])
            i += 2
        elif a == "--straggler-factor":
            factor = float(argv[i + 1])
            i += 2
        elif a in ("--follow", "--json", "--verdict-json"):
            i += 1
        elif a.startswith("--"):
            print(f"agg: unknown flag {a}")
            print(__doc__)
            return 2
        else:
            paths.append(a)
            i += 1
    if not paths:
        print(__doc__)
        return 1
    agg = Aggregator([make_source(p) for p in paths],
                     stale_secs=stale, straggler_factor=factor)
    if as_verdict:
        agg.poll()
        v = agg.verdict()
        print(json.dumps(v, indent=2, default=str))
        return 3 if v["restart"] else 0
    try:
        while True:
            agg.poll()
            if as_json:
                print(json.dumps(agg.to_dict(), indent=2, default=str))
            else:
                if follow:
                    # graftlint: disable=GL004 header shows the wall-clock poll time next to record ages
                    now_ts = time.time()
                    stamp = time.strftime("%H:%M:%S",
                                          time.localtime(now_ts))
                    print(f"=== {stamp} "
                          f"({len(agg.hosts)} processes) ===")
                print(agg.render())
            if not follow:
                return 0
            sys.stdout.flush()
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
