"""Structured sinks for telemetry events and metric snapshots (counterpart of
cxxnet_tpu/telemetry/sink.py).

One record per line. ``json`` format emits canonical JSONL (the
machine-readable stream docs/OBSERVABILITY.md specifies; multi-process
runs tag every record with host/pid/proc so streams merge with a plain
``sort -k ts``); ``text`` format renders the same record as a
``ts kind k=v ...`` line for eyeballing. Writes are line-atomic under a
lock and the file is opened append-mode, so a resumed run extends the
same stream instead of truncating the preempted run's history.
"""

from __future__ import annotations

import json
import math
import sys
import threading
from typing import Dict, Optional


def _json_default(o):
    """Serialize numpy scalars/arrays and anything else foreign: try
    the numeric value first, fall back to repr text (a telemetry write
    must never raise into the training loop). Non-finite numerics
    become null - see _sanitize."""
    try:
        v = float(o)
    except (TypeError, ValueError):
        return str(o)
    return v if math.isfinite(v) else None


def _sanitize(o):
    """Replace non-finite floats with null, recursively. json.dumps
    would emit bare NaN/Infinity tokens (invalid per RFC 8259, rejected
    by jq/JS) - and the NaN paths are exactly the fault events
    telemetry exists to record (a diverging run's loss gauge goes NaN
    and would poison every later snapshot)."""
    if isinstance(o, float):
        return o if math.isfinite(o) else None
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_sanitize(v) for v in o]
    return o


def format_record(record: Dict[str, object], fmt: str = "json") -> str:
    if fmt == "json":
        return json.dumps(_sanitize(record), separators=(",", ":"),
                          default=_json_default)
    # text: ts + kind first, remaining fields as k=v
    parts = []
    ts = record.get("ts")
    if ts is not None:
        parts.append(f"{ts:.3f}" if isinstance(ts, float) else str(ts))
    kind = record.get("kind")
    if kind is not None:
        parts.append(str(kind))
    for k in sorted(record):
        if k in ("ts", "kind"):
            continue
        v = record[k]
        if isinstance(v, dict):
            v = json.dumps(v, separators=(",", ":"),
                           default=_json_default)
        parts.append(f"{k}={v}")
    return " ".join(parts)


class LineSink:
    """Append-mode line writer with locked, flushed writes.

    Flushing every record is deliberate: telemetry exists to explain
    crashes and preemptions, so the stream must be complete up to the
    last event before the process died (buffered tails would vanish
    with exactly the records that matter)."""

    def __init__(self, path: str, fmt: str = "json"):
        if fmt not in ("json", "text"):
            raise ValueError(f"log_format must be json or text, got {fmt!r}")
        self.path = path
        self.fmt = fmt
        self._lock = threading.Lock()
        self._f: Optional[object] = open(path, "a", encoding="utf-8")

    def _drop(self, exc: BaseException) -> None:
        """Disable the sink after an IO failure: telemetry must never
        take training down (ENOSPC / NFS blip on the stream file is
        not a training error), and a raise from the run-teardown emit
        would mask the real exception. Noted once on stderr."""
        try:
            self._f.close()
        except (OSError, ValueError):
            pass
        self._f = None
        sys.stderr.write(
            f"telemetry: disabling sink {self.path}: "
            f"{type(exc).__name__}: {exc}\n")

    def write(self, record: Dict[str, object]) -> None:
        line = format_record(record, self.fmt)
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(line + "\n")
                self._f.flush()
            except (OSError, ValueError) as e:
                self._drop(e)

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except (OSError, ValueError) as e:
                    self._drop(e)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except (OSError, ValueError):
                    pass
                self._f = None


def read_jsonl(path: str):
    """Parse a JSONL telemetry stream, skipping blank/corrupt lines
    (a run killed mid-write may leave a torn last line; the readable
    prefix is still the whole point of the stream). Yields dicts."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                yield rec
