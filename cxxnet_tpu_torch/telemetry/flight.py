"""Dispatch flight recorder + executable introspection registry
(counterpart of cxxnet_tpu/telemetry/flight.py).

- the **flight recorder**: a lock-light ring buffer of recent
  dispatches (train / eval / infer / serve). Each entry records the
  program fingerprint, bucket (batch rows), argument bytes, device,
  thread, optional request trace id, and monotonic start/end. An entry
  whose end is still unset IS the in-flight dispatch - a hung device
  blocks inside the dispatch or its readback, so the watchdog stall
  dump and ``/varz`` tail name the wedged program. Recording is a slot
  store + two clock reads, no device sync, and is armed only with the
  observability plane (sinks / ``metrics_port`` / watchdog /
  ``flight_recorder = 1``) - the unarmed path costs one attribute
  check, preserving the CLI byte-parity contract.

- the **executable registry**: one entry per program shape, keyed by
  the same fingerprint the flight entries carry - registered once per
  shape at the trainer's train/eval/infer sites and for the Server's
  warmed bucket set. Entries accumulate dispatch counts and, where the
  site naturally blocks (Server.warmup), the first-run wall time;
  arming the plane additionally enriches serve entries with what torch
  can tell about a bucket (``enrich``: the forward's FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode`` and the output
  footprint). The JAX package's ``cost_bytes`` (XLA's "bytes
  accessed") has no counterpart and stays None. Exposed live as the
  ``/executables`` HTTP endpoint and per-executable Prometheus series
  (http.py).

Ring and registry writes are slot/dict stores behind one short lock
each; no lock is ever held across a device call. Request tracing
(trace ids minted at ``Server.submit``) rides the same ring
(docs/OBSERVABILITY.md "Request tracing").
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

# dispatches kept in the ring: enough to cover every in-flight replica
# plus a meaningful "what ran last" window without unbounded growth
FLIGHT_RING = 256
# entries included in a tail unless the caller asks otherwise
TAIL_DEFAULT = 16


def fingerprint(*parts) -> str:
    """Stable short id of one compiled program shape: hash of the
    site name + the shape/dtype/epoch parts the site keys its jit
    cache by. 12 hex chars - long enough to never collide across the
    handful of executables one process compiles, short enough to read
    in a stall dump."""
    h = hashlib.sha1("|".join(str(p) for p in parts).encode())
    return h.hexdigest()[:12]


class Flight:
    """One recorded dispatch. Mutable so finish() is a single slot
    store; snapshot() turns it into a plain dict."""

    __slots__ = ("seq", "kind", "fp", "bucket", "nbytes", "device",
                 "trace", "tid", "t0", "t1", "ts0", "fields")

    def __init__(self, seq: int, kind: str, fp: str, bucket: int,
                 nbytes: int, device: str, trace: Optional[str],
                 fields: Optional[Dict[str, Any]]) -> None:
        self.seq = seq
        self.kind = kind
        self.fp = fp
        self.bucket = bucket
        self.nbytes = nbytes
        self.device = device
        self.trace = trace
        self.tid = threading.current_thread().name
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.ts0 = time.time()
        self.fields = fields

    def as_dict(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        t1 = self.t1
        out: Dict[str, Any] = {
            "seq": self.seq, "kind": self.kind, "fp": self.fp,
            "bucket": self.bucket, "bytes": self.nbytes,
            "device": self.device, "thread": self.tid,
            "ts": round(self.ts0, 6),
            "secs": (round(t1 - self.t0, 6) if t1 is not None
                     else None),
            "in_flight": t1 is None,
        }
        if t1 is None:
            out["age_s"] = round(now - self.t0, 6)
        if self.trace is not None:
            out["trace"] = self.trace
        if self.fields:
            out.update(self.fields)
        return out


class FlightRecorder:
    """Lock-light dispatch ring. Sequence allocation is one
    ``next(itertools.count)`` (GIL-atomic) and the entry lands with a
    single list-slot store, so concurrent serve replicas never
    serialize on a recorder lock; a reader may see a slot torn by a
    wrap-around race, which forensics tolerates by construction (the
    snapshot orders by seq and drops None)."""

    def __init__(self, size: int = FLIGHT_RING) -> None:
        self.size = int(size)
        self._ring: List[Optional[Flight]] = [None] * self.size
        self._seq = itertools.count()
        # open (un-finished) dispatches, keyed by seq: the ring evicts
        # by age, but a WEDGED dispatch is exactly the entry that must
        # survive any number of later dispatches (a partial hang - one
        # serve replica stuck while the others keep the ring churning)
        # - so in-flight entries are held here until finish()/fail().
        # Bounded by size as a leak backstop (a site that loses its
        # handle without finishing must not grow this forever).
        self._open: Dict[int, Flight] = {}
        # armed with the observability plane (telemetry._refresh_flight)
        # or explicitly (flight_recorder = 1); unarmed recording costs
        # one attribute check at each dispatch site
        self.enabled = False
        self._explicit = False

    def arm(self, explicit: bool = True) -> None:
        self._explicit = bool(explicit)
        if explicit:
            self.enabled = True

    @property
    def explicit(self) -> bool:
        return self._explicit

    # -- recording ---------------------------------------------------------
    def start(self, kind: str, fp: str = "", bucket: int = 0,
              nbytes: int = 0, device: str = "",
              trace: Optional[str] = None,
              fields: Optional[Dict[str, Any]] = None
              ) -> Optional[Flight]:
        """Open one dispatch record; returns None when disarmed (the
        zero-overhead path - callers guard on .enabled before building
        arguments). The entry stays marked in-flight until finish()."""
        if not self.enabled:
            return None
        fl = Flight(next(self._seq), kind, fp, int(bucket),
                    int(nbytes), device, trace, fields)
        self._ring[fl.seq % self.size] = fl
        self._open[fl.seq] = fl
        if len(self._open) > self.size:
            # leak backstop: a site that lost its handle can never
            # grow the open table past one ring's worth
            self._open.pop(min(self._open), None)
        return fl

    def finish(self, fl: Optional[Flight]) -> None:
        if fl is not None:
            fl.t1 = time.monotonic()
            self._open.pop(fl.seq, None)

    def fail(self, fl: Optional[Flight], error: str) -> None:
        """Close a dispatch that RAISED: it must not read as a hung
        one (the caller survived and continues), so the entry finishes
        carrying the error - only a dispatch that never returns stays
        in-flight."""
        if fl is None:
            return
        if fl.fields is None:
            fl.fields = {}
        fl.fields["error"] = error
        self.finish(fl)

    # -- reading -----------------------------------------------------------
    def _entries(self) -> List[Flight]:
        # ring entries + any open dispatch the ring already evicted
        # (a long-wedged entry outlives arbitrarily many later
        # dispatches - see _open above); dedupe by seq
        got = {fl.seq: fl for fl in self._ring if fl is not None}
        got.update(dict(self._open))
        return [got[s] for s in sorted(got)]

    def snapshot(self) -> List[Dict[str, Any]]:
        """Every live ring entry, oldest-first."""
        now = time.monotonic()
        return [fl.as_dict(now) for fl in self._entries()]

    def tail(self, n: int = TAIL_DEFAULT) -> List[Dict[str, Any]]:
        """The newest n entries, oldest-first (newest LAST - the
        watchdog/varz convention recent_spans uses) - plus ANY older
        in-flight entry: the wedged dispatch is the one record a
        bounded window must never scroll away."""
        now = time.monotonic()
        entries = self._entries()
        window = entries[-n:] if n > 0 else []
        older = entries[:-n] if n > 0 else entries
        keep = [fl for fl in older if fl.t1 is None]
        return [fl.as_dict(now) for fl in keep + window]

    def in_flight(self) -> List[Dict[str, Any]]:
        """Dispatches started but not finished - during a hang these
        name the wedged executable(s). Read from the open table, so a
        wedged entry survives any amount of ring churn."""
        now = time.monotonic()
        # snapshot the dict once: a dispatch thread finish()-popping
        # between a key scan and a per-key lookup must not KeyError a
        # concurrent scrape
        open_now = dict(self._open)
        return [fl.as_dict(now)
                for _, fl in sorted(open_now.items())
                if fl.t1 is None]

    def format_tail(self, n: int = TAIL_DEFAULT,
                    rows: Optional[List[Dict[str, Any]]] = None) -> str:
        """Human-readable tail block for the watchdog stall dump;
        pass `rows` (a tail() result) to render an already-taken
        snapshot instead of taking a second one."""
        if rows is None:
            rows = self.tail(n)
        if not rows:
            return "  (no dispatches recorded)\n"
        out = []
        for r in rows:
            if r["in_flight"]:
                lead = f"  IN-FLIGHT {r['age_s']:9.3f}s"
            else:
                lead = f"  done      {r['secs']:9.4f}s"
            out.append(
                f"{lead} {r['kind']}"
                f" fp={r['fp'] or '-'} bucket={r['bucket']}"
                f" bytes={r['bytes']}"
                + (f" trace={r['trace']}" if "trace" in r else "")
                + f" thread={r['thread']}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        self._ring = [None] * self.size
        self._open = {}
        self._seq = itertools.count()
        self.enabled = False
        self._explicit = False


class ExecutableRegistry:
    """fingerprint -> executable facts. Registration happens once per
    compiled program shape at the jit-cache sites (cheap enough to run
    unconditionally); per-dispatch counting is one dict
    hit + increment under a short lock never held across a dispatch."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._entries: Dict[str, Dict[str, Any]] = {}

    def register(self, fp: str, name: str, kind: str,
                 shape: str = "", arg_bytes: int = 0,
                 device: str = "", donated: int = 0,
                 compile_s: Optional[float] = None) -> None:
        """Idempotent per fingerprint; the first registration wins
        (re-deriving the same program shape must not reset counts)."""
        with self._lock:
            if fp in self._entries:
                e = self._entries[fp]
                if compile_s is not None and e.get("compile_s") is None:
                    e["compile_s"] = round(compile_s, 6)
                return
            self._entries[fp] = {
                "fingerprint": fp, "name": name, "kind": kind,
                "shape": shape, "arg_bytes": int(arg_bytes),
                "device": device, "donated": int(donated),
                "compile_s": (round(compile_s, 6)
                              if compile_s is not None else None),
                "flops": None, "cost_bytes": None, "out_bytes": None,
                "dispatches": 0, "dispatch_s": 0.0,
                "last_used_ts": None,
            }

    def count_dispatch(self, fp: str,
                       secs: Optional[float] = None) -> None:
        with self._lock:
            e = self._entries.get(fp)
            if e is None:
                return
            e["dispatches"] += 1
            if secs is not None:
                e["dispatch_s"] = round(e["dispatch_s"] + secs, 6)
            e["last_used_ts"] = round(time.time(), 3)

    def enrich(self, fp: str, fn, args) -> None:
        """Attach what torch can tell about one bucket program: the
        FLOPs of one ``fn(*args)`` counted by FlopCounterMode (the
        matmul/convolution work; a hand-written kernel launched outside
        the dispatcher counts nothing) and the byte size of its output.
        Runs one extra forward, so only where a warmup window is
        sanctioned - Server.warmup with the plane armed. Best-effort: a
        forensics feature must never take serving down."""
        try:
            import torch
            from torch.utils.flop_counter import FlopCounterMode
            with torch.inference_mode():
                counter = FlopCounterMode(display=False)
                with counter:
                    out = fn(*args)
            flops = float(counter.get_total_flops())
            out_bytes = None
            if isinstance(out, torch.Tensor):
                out_bytes = int(out.numel() * out.element_size())
            with self._lock:
                e = self._entries.get(fp)
                if e is None:
                    return
                e["flops"] = flops
                if out_bytes is not None:
                    e["out_bytes"] = out_bytes
        except Exception:  # noqa: BLE001 - introspection never kills serving
            pass

    def seen(self, fp: str) -> bool:
        with self._lock:
            return fp in self._entries

    def snapshot(self) -> List[Dict[str, Any]]:
        """Sorted (by name, then fingerprint) entry copies - the
        ``/executables`` body and the Prometheus series source."""
        with self._lock:
            got = [dict(e) for e in self._entries.values()]
        got.sort(key=lambda e: (e["name"], e["fingerprint"]))
        return got

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def reset(self) -> None:
        with self._lock:
            self._entries = {}
