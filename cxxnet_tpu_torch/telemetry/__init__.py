"""Telemetry: structured event log, metrics registry, span timers
(counterpart of cxxnet_tpu/telemetry/__init__.py; stdlib-only and
device-free, a process-wide singleton of its own).

The central observability layer the reference lacks (its only signal
is a wall-clock round print, cxxnet_main.cpp:376-387). Three pieces:

- a process-wide **metrics registry** (`counter` / `gauge` /
  `histogram` with p50/p99). Rare-event counts (fault/retry/rollback,
  checkpoint) accumulate regardless of sinks and are always queryable
  in-process; per-step/per-batch instruments (train.*, io.prefetch.*)
  are recorded only while a sink is armed - their timing costs a
  device sync the disabled path must not pay;
- **span timers**: ``with span("train.step"): ...`` observes the
  duration into a histogram of the same name and, when an event sink
  is configured, emits a ``span`` event. Spans nest - the recorded
  name is the "/"-joined path of the enclosing spans on this thread.
  With no sink configured ``span()`` returns a shared no-op context,
  so the disabled path costs one attribute check;
- a **central logger** with JSONL event/metric sinks (``log_file=`` /
  ``metrics_file=`` config keys, ``log_format=json|text``, periodic
  ``heartbeat_secs=`` snapshots). ``stdout()`` / ``stderr()`` write
  the EXACT text the pre-telemetry code printed - byte-for-byte stderr
  parity when no sink is configured is a hard contract (tests pin it)
  - while mirroring a structured event when a sink is armed.

Every record carries {ts, host, pid, proc, device} tags so
multi-process runs produce mergeable streams. Config plumbing lives in
main.py; the full schema is docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from cxxnet_tpu_torch.telemetry.flight import (
    ExecutableRegistry, FlightRecorder)
from cxxnet_tpu_torch.telemetry.health import HealthState
from cxxnet_tpu_torch.telemetry.registry import (
    BucketHistogram, Counter, Gauge, Histogram, MetricsRegistry)
from cxxnet_tpu_torch.telemetry.sink import LineSink, read_jsonl

__all__ = [
    "Telemetry", "Counter", "Gauge", "Histogram", "BucketHistogram",
    "MetricsRegistry", "FlightRecorder", "ExecutableRegistry",
    "HealthState", "LineSink", "read_jsonl", "get", "configure",
    "close", "enabled", "metrics_enabled", "counter", "gauge",
    "histogram", "inc", "set_gauge", "observe", "span", "event",
    "emit_metrics", "stdout", "stderr", "set_tags", "beacon",
    "beacons", "recent_spans", "flight", "executables",
    "arm_observability", "disarm_observability", "health",
    "reset_for_tests",
]

# completed spans kept for the watchdog's stall dump ("what ran last")
RECENT_SPANS = 64


class _NullSpan:
    """Reusable no-op context manager: the disabled span path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Timed span: pushes its name on the thread's span stack so
    nested spans record "outer/inner" paths."""

    __slots__ = ("_tel", "_name", "_fields", "_path", "_t0")

    def __init__(self, tel: "Telemetry", name: str, fields: Dict):
        self._tel = tel
        self._name = name
        self._fields = fields
        self._path = name
        self._t0 = 0.0

    def __enter__(self):
        stack = self._tel._span_stack()
        self._path = ("/".join(stack) + "/" + self._name if stack
                      else self._name)
        stack.append(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        secs = time.perf_counter() - self._t0
        stack = self._tel._span_stack()
        if stack:
            stack.pop()
        self._tel.observe(self._path, secs)
        # event() also records the span into the recent-span ring
        self._tel.event("span", name=self._path, secs=secs,
                        **self._fields)
        return False


class Telemetry:
    """One logger + registry + sinks bundle. A process normally uses
    the module-level singleton (`telemetry.get()`); separate instances
    exist for tests."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.health = HealthState()
        self._log: Optional[LineSink] = None
        self._metrics: Optional[LineSink] = None
        self.heartbeat_secs = 0.0
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        # test hook: a fake-clock wait fn (signature of Event.wait)
        # injected by the heartbeat-hardening tests; None = real clock
        self._hb_waiter = None
        self._emit_lock = threading.Lock()
        # `final` snapshot emitted: the heartbeat must never write a
        # trailing snapshot after it (the stream's terminal record);
        # the flag is checked-and-written under _emit_lock
        # guarded-by: self._emit_lock
        self._finalized = False
        self._local = threading.local()
        # progress beacons (watchdog.py / absence alert rules):
        # name -> (count, monotonic ts of the newest mark); locked -
        # serve replicas mark the same beacon concurrently and an
        # unlocked read-modify-write would drop counts
        self._beacon_lock = threading.Lock()
        # guarded-by: self._beacon_lock
        self._beacons: Dict[str, Tuple[int, float]] = {}
        self._recent_spans: collections.deque = collections.deque(
            maxlen=RECENT_SPANS)
        # live observability plane handles (armed via
        # arm_observability; None = the zero-overhead default)
        self._http = None
        self._alerts = None
        self._watchdog = None
        # dispatch flight recorder + executable registry (flight.py):
        # the recorder arms with the plane (any sink / http / watchdog
        # / alerts, or flight_recorder=1) - unarmed dispatch sites pay
        # one attribute check; the registry registers unconditionally
        # (once per compiled program shape, no output)
        self.flight = FlightRecorder()
        self.executables = ExecutableRegistry()
        self._tags: Dict[str, object] = {
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "proc": 0,
        }

    # -- configuration -----------------------------------------------------
    def configure(self, log_file: str = "", metrics_file: str = "",
                  log_format: str = "json", heartbeat_secs: float = 0.0,
                  tags: Optional[Dict[str, object]] = None) -> None:
        """(Re)arm the sinks. Idempotent and terminal for the previous
        configuration: earlier sinks are flushed and closed first, so a
        CLI process that runs several tasks back-to-back (the test
        suite does) never leaks file handles or cross-writes streams.
        Empty paths disarm - configure() with no arguments returns the
        process to the zero-overhead disabled state."""
        self._stop_heartbeat()
        if self._log is not None:
            self._log.close()
        if self._metrics is not None:
            self._metrics.close()
        self._log = LineSink(log_file, log_format) if log_file else None
        self._metrics = (LineSink(metrics_file, "json")
                         if metrics_file else None)
        if tags:
            self._tags.update(tags)
        with self._emit_lock:
            # under the lock: a heartbeat that outlived its bounded
            # join (blocked on a slow disk) could still be inside
            # emit_metrics when the next run re-arms
            self._finalized = False
        self.heartbeat_secs = float(heartbeat_secs or 0.0)
        if self.heartbeat_secs > 0 and (self._log or self._metrics):
            self._start_heartbeat()
        self._refresh_flight()

    def _refresh_flight(self) -> None:
        """Re-derive the flight recorder's armed state: any consumer
        of its ring (a sink to mirror trace events into, the /varz
        and /executables endpoints, the watchdog's stall dump, an
        alert engine's forensics) arms it; an explicit
        ``flight_recorder = 1`` keeps it armed with everything else
        off. With no consumer the recorder stays disabled and every
        dispatch site pays one attribute check - the byte-parity
        contract's zero-overhead path."""
        self.flight.enabled = bool(
            self._log is not None or self._metrics is not None
            or self._http is not None or self._watchdog is not None
            or self._alerts is not None or self.flight.explicit)

    def set_tags(self, **tags) -> None:
        """Late tag refinement (e.g. `proc` once the process rank
        is known after distributed init)."""
        self._tags.update(tags)

    def tags(self) -> Dict[str, object]:
        return dict(self._tags)

    # -- progress beacons --------------------------------------------------
    def beacon(self, name: str, n: int = 1) -> None:
        """Mark progress (one dict store + a monotonic read - no
        device sync, safe on every step). The watchdog and absence
        alert rules judge liveness by beacon age; the instrumented
        sites are train.step / eval.step / serve.batch /
        checkpoint.save."""
        with self._beacon_lock:
            prev = self._beacons.get(name)
            self._beacons[name] = (
                (prev[0] if prev else 0) + n, time.monotonic())

    def beacons(self) -> Dict[str, Tuple[int, float]]:
        """{name: (count, monotonic ts of newest mark)} snapshot."""
        with self._beacon_lock:
            return dict(self._beacons)

    def recent_spans(self):
        """Newest-last list of recently completed spans
        ({ts, name, secs}) - the watchdog's "what ran last" evidence."""
        return list(self._recent_spans)

    # -- live observability plane ------------------------------------------
    def arm_observability(self, metrics_port: Optional[int] = None,
                          alert_rules: str = "", alert_cmd: str = "",
                          watchdog_secs: float = 0.0,
                          metrics_host: str = ""):
        """Bring up the live plane: the hang watchdog
        (``watchdog_secs>0``), the alert engine (``alert_rules`` file,
        optional ``alert_cmd`` shell hook) and the HTTP exposition
        server (``metrics_port`` - 0 binds an ephemeral port; None =
        no server). With every knob off this returns without
        importing anything: no thread, no socket, no import-time side
        effects - the byte-parity contract's disabled path.

        Returns the ObservabilityServer (or None), whose ``.port`` is
        the resolved bind."""
        if (metrics_port is None and not alert_rules
                and not (watchdog_secs and watchdog_secs > 0)):
            return None
        self.disarm_observability()
        if watchdog_secs and watchdog_secs > 0:
            from cxxnet_tpu_torch.telemetry.watchdog import Watchdog
            self._watchdog = Watchdog(self, float(watchdog_secs))
            self._watchdog.start()
        if alert_rules:
            from cxxnet_tpu_torch.telemetry.alerts import (
                AlertEngine, load_rules)
            self._alerts = AlertEngine(self, load_rules(alert_rules),
                                       alert_cmd=alert_cmd)
            self._alerts.start()
        if metrics_port is not None:
            from cxxnet_tpu_torch.telemetry.http import ObservabilityServer
            # default bind is all interfaces (cross-host scraping is
            # the point); metrics_host=127.0.0.1 restricts to
            # loopback - the endpoints are unauthenticated, see the
            # exposure note in docs/OBSERVABILITY.md
            self._http = ObservabilityServer(
                self, int(metrics_port),
                host=metrics_host or "0.0.0.0")
            self._http.start()
            self.event("observability", op="http_start",
                       port=self._http.port, host=self._http.host)
        self._refresh_flight()
        return self._http

    def disarm_observability(self) -> None:
        """Stop watchdog/alerts/http (reverse arm order: detectors
        first so a final scrape cannot observe a half-closed plane).
        Idempotent; firing detectors clear their health sources."""
        if self._watchdog is not None:
            self._watchdog.close()
            self._watchdog = None
        if self._alerts is not None:
            self._alerts.close()
            self._alerts = None
        if self._http is not None:
            self._http.close()
            self._http = None
        self._refresh_flight()

    def close(self) -> None:
        """Tear down the observability plane (watchdog/alerts/http),
        flush + close sinks and stop the heartbeat; the registry keeps
        accumulating (counters outlive any one sink's life)."""
        self.disarm_observability()
        self._stop_heartbeat()
        if self._log is not None:
            self._log.close()
            self._log = None
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None
        self._refresh_flight()

    @property
    def enabled(self) -> bool:
        """True when a consumer of the FULL instrumentation is armed:
        a JSONL sink, or the /metrics HTTP server (a scraper wants the
        per-step histograms - arming metrics_port opts into the same
        per-step device-sync cost a metrics_file does;
        telemetry_steps=0 still opts back out). Deliberately NOT the
        watchdog or alert engine alone: forensics and counter/beacon
        rules must not silently serialize async dispatch with
        per-step syncs - the diagnostic would perturb the thing it
        diagnoses. Rules over train.* step histograms need a sink or
        metrics_port armed too (docs/OBSERVABILITY.md)."""
        return (self._log is not None or self._metrics is not None
                or self._http is not None)

    @property
    def metrics_enabled(self) -> bool:
        return self._metrics is not None

    # -- registry sugar ----------------------------------------------------
    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    def inc(self, name: str, n: int = 1) -> None:
        self.registry.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.registry.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.registry.histogram(name).observe(v)

    # -- spans -------------------------------------------------------------
    def _span_stack(self):
        stack = getattr(self._local, "spans", None)
        if stack is None:
            stack = self._local.spans = []
        return stack

    def span(self, name: str, **fields):
        """Timed context manager; no-op singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, fields)

    # -- events ------------------------------------------------------------
    def _record(self, kind: str, fields: Dict) -> Dict[str, object]:
        # graftlint: disable=GL004 `ts` is a wall-clock TIMESTAMP by design - multi-host streams merge by absolute time
        rec: Dict[str, object] = {"ts": time.time(), "kind": kind}
        rec.update(self._tags)
        rec.update(fields)
        return rec

    def event(self, kind: str, **fields) -> None:
        """Emit a structured event to the event log (no-op unarmed).
        ``span`` events also feed the recent-span ring: the trainer
        emits its per-step/per-chunk span records directly as events
        (not via span() contexts), and the watchdog's stall dump
        wants exactly those as its "what ran last" evidence."""
        if kind == "span" and "name" in fields:
            # graftlint: disable=GL004 ring keeps wall TIMESTAMPS like the streams
            ts = time.time()
            self._recent_spans.append(
                {"ts": ts, "name": fields["name"],
                 "secs": round(float(fields.get("secs") or 0.0), 6)})
        log = self._log
        if log is not None:
            log.write(self._record(kind, fields))

    def emit_metrics(self, kind: str = "metrics", **fields) -> None:
        """Emit a full registry snapshot record to the metrics stream
        (no-op when metrics_file is unarmed). Extra fields ride on the
        record - per-round emitters attach round/step/throughput.
        ``kind="final"`` marks the stream terminal: a heartbeat racing
        the shutdown must not append a trailing snapshot after it."""
        sink = self._metrics
        if sink is None:
            return
        # check-and-write under one lock: a heartbeat that passed an
        # unlocked check could be descheduled, lose the race to the
        # `final` write, and still append after the terminal record
        with self._emit_lock:
            if kind == "final":
                self._finalized = True
            elif kind == "heartbeat" and self._finalized:
                return
            fields = dict(fields)
            fields["metrics"] = self.registry.snapshot()
            sink.write(self._record(kind, fields))

    def snapshot_record(self, kind: str = "varz") -> Dict[str, object]:
        """One metrics-stream-schema record ({ts, tags..., kind,
        metrics}) without writing it anywhere - the `/varz` body, so
        live scrapes and file tails parse identically."""
        return self._record(kind, {"metrics": self.registry.snapshot()})

    def flush(self) -> None:
        if self._log is not None:
            self._log.flush()
        if self._metrics is not None:
            self._metrics.flush()

    # -- the central logger ------------------------------------------------
    def stdout(self, text: str) -> None:
        """Exactly `print(text)` - THE sanctioned stdout path for
        cxxnet_tpu_torch outside tools/ (CI lints bare print() away). When an
        event sink is armed the line is mirrored as a `log` event."""
        print(text)  # noqa: T201 - the one sanctioned print
        log = self._log
        if log is not None:
            log.write(self._record("log", {"stream": "stdout",
                                           "text": text}))

    def stderr(self, text: str, event_kind: str = "", **fields) -> None:
        """Write `text` to sys.stderr byte-for-byte (stderr parity with
        the pre-telemetry CLI is a pinned contract), mirroring a
        structured event when a sink is armed: `event_kind` + fields if
        given, else a plain `log` record."""
        sys.stderr.write(text)
        log = self._log
        if log is not None:
            if event_kind:
                log.write(self._record(event_kind, fields))
            else:
                log.write(self._record("log", {"stream": "stderr",
                                               "text": text}))

    # -- heartbeat ---------------------------------------------------------
    def _start_heartbeat(self) -> None:
        # the thread binds ITS stop event + interval at spawn: a thread
        # that outlives _stop_heartbeat's bounded join (blocked on a
        # slow disk) must see its own, already-set event when it wakes
        # - re-reading self._hb_stop would pick up the NEXT config's
        # fresh event and loop forever as a duplicate-emitting zombie
        stop = self._hb_stop = threading.Event()
        interval = self.heartbeat_secs
        # test hook: a fake clock replaces the Event.wait sleep so the
        # hardening contract (prompt close(), no post-`final` beat) is
        # pinned without real time
        waiter = self._hb_waiter or stop.wait

        def run():
            while not waiter(interval):
                # re-check AFTER waking: a tick that raced close() or
                # the terminal `final` snapshot must emit nothing -
                # close() returns with the stream already terminal
                if stop.is_set() or self._finalized:
                    return
                with contextlib.suppress(Exception):
                    # a dying heartbeat must never take training down
                    self.emit_metrics(kind="heartbeat")
                    self.event("heartbeat")
                    self.flush()

        self._hb_thread = threading.Thread(
            target=run, name="telemetry-heartbeat", daemon=True)
        self._hb_thread.start()

    def _stop_heartbeat(self) -> None:
        if self._hb_thread is None:
            return
        self._hb_stop.set()
        self._hb_thread.join(timeout=2.0)
        self._hb_thread = None


# ---------------------------------------------------------------------------
# process-wide singleton + module-level convenience API (the registry is
# process state, like utils/fault's registry)
# ---------------------------------------------------------------------------
_TEL = Telemetry()


def get() -> Telemetry:
    return _TEL


def configure(**kwargs) -> None:
    _TEL.configure(**kwargs)


def close() -> None:
    _TEL.close()


def enabled() -> bool:
    return _TEL.enabled


def metrics_enabled() -> bool:
    return _TEL.metrics_enabled


def counter(name: str) -> Counter:
    return _TEL.counter(name)


def gauge(name: str) -> Gauge:
    return _TEL.gauge(name)


def histogram(name: str) -> Histogram:
    return _TEL.histogram(name)


def inc(name: str, n: int = 1) -> None:
    _TEL.inc(name, n)


def set_gauge(name: str, v: float) -> None:
    _TEL.set_gauge(name, v)


def observe(name: str, v: float) -> None:
    _TEL.observe(name, v)


def span(name: str, **fields):
    return _TEL.span(name, **fields)


def event(kind: str, **fields) -> None:
    _TEL.event(kind, **fields)


def emit_metrics(kind: str = "metrics", **fields) -> None:
    _TEL.emit_metrics(kind, **fields)


def stdout(text: str) -> None:
    _TEL.stdout(text)


def stderr(text: str, event_kind: str = "", **fields) -> None:
    _TEL.stderr(text, event_kind, **fields)


def set_tags(**tags) -> None:
    _TEL.set_tags(**tags)


def beacon(name: str, n: int = 1) -> None:
    _TEL.beacon(name, n)


def beacons() -> Dict[str, Tuple[int, float]]:
    return _TEL.beacons()


def recent_spans():
    return _TEL.recent_spans()


def flight() -> FlightRecorder:
    return _TEL.flight


def executables() -> ExecutableRegistry:
    return _TEL.executables


def arm_observability(**kwargs):
    return _TEL.arm_observability(**kwargs)


def disarm_observability() -> None:
    _TEL.disarm_observability()


def health() -> HealthState:
    return _TEL.health


def reset_for_tests() -> None:
    """Close sinks + the observability plane, wipe the registry,
    beacons, span ring and health state, and restore default tags -
    test isolation only (configure()/set_tags mutate the process-wide
    tag dict, which must not leak across tests)."""
    _TEL.close()
    _TEL.registry.reset()
    _TEL.health.reset()
    with _TEL._beacon_lock:
        _TEL._beacons = {}
    _TEL._recent_spans.clear()
    _TEL.flight.reset()
    _TEL.executables.reset()
    with _TEL._emit_lock:
        _TEL._finalized = False
    _TEL._hb_waiter = None
    _TEL._tags = {"host": socket.gethostname(), "pid": os.getpid(),
                  "proc": 0}
