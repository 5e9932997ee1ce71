"""HTTP exposition: `/metrics` (Prometheus), `/healthz`, `/varz` (counterpart of
cxxnet_tpu/telemetry/http.py).

The registry and JSONL streams (registry.py / sink.py) are complete
but *offline* - nothing could watch a live run without tailing files.
This module is the live side: a stdlib-only background HTTP server
(the repo's first real network transport - a stepping stone for the
serving-transport roadmap item) exposing

- ``/metrics``: Prometheus text exposition (version 0.0.4) of the
  full registry - counters as ``cxxnet_<name>_total``, gauges as
  ``cxxnet_<name>``, histograms as summaries with ``quantile="0.5"``
  / ``quantile="0.99"`` series plus ``_sum``/``_count`` (the same
  count/sum/p50/p99 the JSONL snapshots carry). Dots become
  underscores; a process-tag info metric (``cxxnet_process_info``)
  carries the {host, pid, proc, device} tags as escaped labels so a
  multi-host scrape stays attributable.
- ``/healthz``: 200 while the process is healthy, 503 with the
  reasons JSON once the watchdog or an alert rule flags it
  (health.py); scrape-friendly liveness for load balancers and the
  obs-smoke CI job.
- ``/varz``: one JSON object, byte-compatible with a metrics-stream
  record (``{ts, host, pid, proc, ..., kind: "varz", metrics: {...}}``)
  so ``tools/agg.py`` can scrape live processes and file tails with
  the same parser; with the flight recorder armed the record
  additionally carries a ``flight`` tail (recent + in-flight
  dispatches - docs/OBSERVABILITY.md "Flight recorder").
- ``/executables``: the executable introspection plane (flight.py
  registry): one JSON entry per compiled program shape - fingerprint,
  site name/kind, first-run wall time, forward FLOPs,
  output footprint and dispatch counts - plus the currently
  in-flight dispatches. The same facts export as labeled Prometheus
  series (``cxxnet_executable_*{fingerprint=...}``) on ``/metrics``.

With a serving backend attached (``Server(http_port=...)`` / the CLI
``serve_port=`` key) the same listener additionally routes ``POST
/predict`` - the serving request path (docs/SERVING.md "Serving over
HTTP"); the protocol mapping (429 + Retry-After on shed, 504 on
deadline expiry) lives on the Server, this module is transport only.

Connection-level ingress hardening (docs/SERVING.md "Connection
limits & drain") arms with ``serve_conn_timeout_ms`` /
``serve_max_conns`` / ``serve_max_body_bytes``: per-connection
header/body read deadlines (a slow-loris client is cut, not
serviced), a max-body gate (413 before the body is read), and an
accept gate answering an immediate raw 503 + Retry-After when
``max_conns`` handler threads are live - with its own ``serve_conns``
health source and the same hysteretic recovery as load shedding.
With the keys unset the plain ``ThreadingHTTPServer`` path is used
unchanged (byte parity).

Armed only by ``metrics_port=`` / ``serve_port=`` (or
``Server(metrics_port=...)``); with the keys unset this module is
never imported - the CLI byte-parity contract costs nothing.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from cxxnet_tpu_torch.telemetry.registry import (
    BucketHistogram, Counter, Gauge, Histogram)
from cxxnet_tpu_torch.telemetry.sink import _sanitize
from cxxnet_tpu_torch.utils import fault

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Prometheus metric-name alphabet; everything else becomes "_"
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "cxxnet_"


def prom_name(name: str) -> str:
    """Registry name -> Prometheus name: dotted-lowercase grammar
    (GL008) maps onto the prom alphabet by replacing dots; anything
    foreign is flattened to underscores and a leading digit is
    shielded (prom names must not start with one)."""
    out = _BAD_CHARS.sub("_", name.replace(".", "_"))
    if out and out[0].isdigit():
        out = "_" + out
    return _PREFIX + out


def prom_label_escape(v: object) -> str:
    """Label-value escaping per the text exposition spec: backslash,
    double quote and newline."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v) -> str:
    """One sample value: prom accepts NaN/+Inf/-Inf tokens (which the
    JSONL sinks must NOT emit - different consumers, different
    specs)."""
    if v is None:
        return "NaN"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(tel) -> str:
    """The full registry as Prometheus text exposition, sorted by
    name so consecutive scrapes diff cleanly."""
    lines: List[str] = []
    tags = tel.tags()
    labels = ",".join(f'{k}="{prom_label_escape(v)}"'
                      for k, v in sorted(tags.items()))
    lines.append("# TYPE cxxnet_process_info gauge")
    lines.append("cxxnet_process_info{%s} 1" % labels)
    for name, inst in sorted(tel.registry.instruments().items()):
        pname = prom_name(name)
        if isinstance(inst, Counter):
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_fmt_value(inst.value)}")
        elif isinstance(inst, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt_value(inst.value)}")
        elif isinstance(inst, BucketHistogram):
            snap = inst.snapshot()
            lines.append(f"# TYPE {pname} histogram")
            for le, cum in snap["buckets"].items():
                lines.append(f'{pname}_bucket{{le="{le}"}} '
                             f"{_fmt_value(cum)}")
            lines.append(f"{pname}_sum {_fmt_value(snap['sum'])}")
            lines.append(f"{pname}_count {_fmt_value(snap['count'])}")
        elif isinstance(inst, Histogram):
            snap = inst.snapshot()
            lines.append(f"# TYPE {pname} summary")
            lines.append(f'{pname}{{quantile="0.5"}} '
                         f'{_fmt_value(snap["p50"])}')
            lines.append(f'{pname}{{quantile="0.99"}} '
                         f'{_fmt_value(snap["p99"])}')
            lines.append(f"{pname}_sum {_fmt_value(snap['sum'])}")
            lines.append(f"{pname}_count {_fmt_value(snap['count'])}")
    lines.extend(_render_executables(tel))
    return "\n".join(lines) + "\n"


def _render_executables(tel) -> List[str]:
    """Per-executable introspection series (flight.py registry) plus
    the flight-recorder liveness gauges. Labeled by fingerprint so a
    multi-bucket serving process exports one series per warmed
    program shape - the Grafana twin of `/executables`."""
    execs = tel.executables.snapshot()
    lines: List[str] = []
    if execs:
        lines.append("# TYPE cxxnet_executable_dispatches_total counter")
        for e in execs:
            lab = (f'fingerprint="{prom_label_escape(e["fingerprint"])}"'
                   f',name="{prom_label_escape(e["name"])}"'
                   f',kind="{prom_label_escape(e["kind"])}"')
            lines.append("cxxnet_executable_dispatches_total{%s} %s"
                         % (lab, _fmt_value(e["dispatches"])))
        for field, pname in (("compile_s",
                              "cxxnet_executable_compile_seconds"),
                             ("flops", "cxxnet_executable_flops"),
                             ("cost_bytes",
                              "cxxnet_executable_cost_bytes")):
            rows = [e for e in execs if e.get(field) is not None]
            if not rows:
                continue
            lines.append(f"# TYPE {pname} gauge")
            for e in rows:
                lab = (f'fingerprint='
                       f'"{prom_label_escape(e["fingerprint"])}"'
                       f',name="{prom_label_escape(e["name"])}"')
                lines.append("%s{%s} %s"
                             % (pname, lab, _fmt_value(e[field])))
    if tel.flight.enabled:
        lines.append("# TYPE cxxnet_flight_inflight gauge")
        lines.append("cxxnet_flight_inflight "
                     + _fmt_value(len(tel.flight.in_flight())))
    return lines


# one exposition line: comment, or `name[{labels}] value` where value
# is a float or a NaN/+Inf/-Inf token (promtool's line grammar, the
# check the obs-smoke job and the tests run over real scrapes)
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r" (NaN|[+-]Inf|[+-]?[0-9]*\.?[0-9]+([eE][+-]?[0-9]+)?)$")
_COMMENT_RE = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+$")


def validate_exposition(text: str) -> List[str]:
    """Promtool-style line check of a `/metrics` body; returns the
    list of malformed lines (empty = valid)."""
    bad = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            if not _COMMENT_RE.match(line):
                bad.append(line)
        elif not _SAMPLE_RE.match(line):
            bad.append(line)
    return bad


class IngressLimits:
    """Connection-level ingress protection shared by the accept gate
    and the request handlers. One instance per ObservabilityServer;
    built only when at least one of the serve_conn_timeout_ms /
    serve_max_conns / serve_max_body_bytes keys is armed, so the
    unarmed listener carries zero extra state."""

    def __init__(self, tel, max_conns: int = 0,
                 conn_timeout_ms: float = 0.0,
                 max_body_bytes: int = 0, clear_ms: float = 1000.0):
        self._tel = tel
        self.max_conns = int(max_conns or 0)
        t = float(conn_timeout_ms or 0.0)
        self.conn_timeout_s = t / 1e3 if t > 0 else 0.0
        self.max_body_bytes = int(max_body_bytes or 0)
        self.clear_s = max(float(clear_ms or 0.0), 0.0) / 1e3
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._active = 0
        # guarded-by: self._lock
        self._n_rejected = 0
        # guarded-by: self._lock
        self._n_timeouts = 0
        # guarded-by: self._lock
        self._n_oversized = 0
        # guarded-by: self._lock
        self._last_reject_t = 0.0
        # guarded-by: self._lock
        self._gate_health = False

    def try_enter(self) -> bool:
        """Accept gate: called on the accept path before a handler
        thread is spawned. False = saturated; the caller answers an
        immediate 503 + Retry-After and closes the socket."""
        flip = False
        rejected = 0
        with self._lock:
            if 0 < self.max_conns <= self._active:
                self._n_rejected += 1
                self._last_reject_t = time.monotonic()
                if not self._gate_health:
                    self._gate_health = True
                    flip = True
                rejected = self._n_rejected
                ok = False
            else:
                self._active += 1
                ok = True
        if not ok:
            # telemetry strictly OUTSIDE the lock (the repo's lock
            # idiom: no I/O or cross-lock calls while held)
            self._tel.inc("serve.conn_rejected")
            if flip:
                self._tel.health.set_unhealthy(
                    "serve_conns",
                    f"connection limit saturated "
                    f"(serve_max_conns={self.max_conns})")
                self._tel.event("serve", op="conn_saturated",
                                max_conns=self.max_conns,
                                rejected=rejected)
        return ok

    def leave(self) -> None:
        with self._lock:
            self._active -= 1
        self._maybe_recover()

    def _maybe_recover(self) -> None:
        """Hysteretic gate recovery (the serve_shed pattern): clear
        the serve_conns health verdict only once occupancy fell below
        HALF the limit AND clear_ms passed since the last rejection -
        a gate oscillating at the limit must not flap /healthz."""
        clear = False
        with self._lock:
            if (self._gate_health
                    and self._active * 2 < max(self.max_conns, 1)
                    and (time.monotonic() - self._last_reject_t
                         >= self.clear_s)):
                self._gate_health = False
                clear = True
        if clear:
            self._tel.health.clear("serve_conns")
            self._tel.event("serve", op="conn_recovered",
                            max_conns=self.max_conns)

    def note_timeout(self, phase: str) -> None:
        """A connection was cut at the read deadline (phase: headers
        held open vs body dribbled - the two slow-loris shapes)."""
        with self._lock:
            self._n_timeouts += 1
        self._tel.inc("serve.conn_timeouts")
        self._tel.event("serve", op="conn_timeout", phase=phase,
                        timeout_ms=round(self.conn_timeout_s * 1e3, 1))

    def note_oversized(self, n: int) -> None:
        with self._lock:
            self._n_oversized += 1
        self._tel.inc("serve.conn_oversized")
        self._tel.event("serve", op="conn_oversized", bytes=int(n),
                        max_body_bytes=self.max_body_bytes)

    def release_health(self) -> None:
        """Listener closing: a dead socket is not 'saturated'."""
        with self._lock:
            held = self._gate_health
            self._gate_health = False
        if held:
            self._tel.health.clear("serve_conns")

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "conn_active": self._active,
                "conn_rejected": self._n_rejected,
                "conn_timeouts": self._n_timeouts,
                "conn_oversized": self._n_oversized,
            }


class _IngressServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with the accept gate: when max_conns
    handler threads are live, a new connection gets a raw 503 +
    Retry-After ON THE ACCEPT PATH - no handler thread is spawned
    for it, so a connection flood cannot grow the thread pool past
    the limit."""

    daemon_threads = True

    def __init__(self, addr, handler, limits: IngressLimits):
        self._limits = limits
        super().__init__(addr, handler)

    def process_request(self, request, client_address):
        if not self._limits.try_enter():
            body = b'{"error": "connection limit reached"}'
            try:
                # bounded write: the reject path must never block on
                # a client that won't read
                request.settimeout(1.0)
                request.sendall(
                    b"HTTP/1.0 503 Service Unavailable\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Retry-After: 1\r\n"
                    b"Content-Length: " + str(len(body)).encode()
                    + b"\r\n\r\n" + body)
            except OSError:
                pass  # client gone; the rejection still counted
            self.shutdown_request(request)
            return
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._limits.leave()


def _make_handler(tel, predict_backend=None, limits=None):
    conn_timeout = (limits.conn_timeout_s
                    if limits is not None and limits.conn_timeout_s > 0
                    else None)

    class _Handler(BaseHTTPRequestHandler):
        # one scrape per GET; no keep-alive state worth protocol 1.1
        protocol_version = "HTTP/1.0"
        # StreamRequestHandler.setup() applies this to the accepted
        # socket: EVERY blocking read (header line, body chunk) gets
        # the per-connection deadline, so a client holding its
        # headers open is cut at serve_conn_timeout_ms (None = the
        # unarmed, wait-forever stdlib default)
        timeout = conn_timeout

        def _send(self, code: int, body: bytes, ctype: str,
                  headers=None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self) -> None:  # noqa: N802 - stdlib handler API
            # the serving request path (docs/SERVING.md "Serving over
            # HTTP"): present only when a Server attached with
            # serve_port/http_port; all protocol mapping (429 +
            # Retry-After, 504 deadline, 400/500) lives in
            # Server.handle_predict - this handler is pure transport
            path = self.path.split("?", 1)[0]
            try:
                if path != "/predict" or predict_backend is None:
                    self._send(404, b"not found\n", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    n = 0
                if (limits is not None
                        and 0 < limits.max_body_bytes < n):
                    # rejected BEFORE the body is read: a bloated
                    # client pays for its own upload, not us
                    limits.note_oversized(n)
                    self.close_connection = True
                    self._send(413, json.dumps({
                        "error": "request body too large",
                        "bytes": n,
                        "max_body_bytes": limits.max_body_bytes,
                    }).encode(), "application/json")
                    return
                if limits is None:
                    body = self.rfile.read(n) if n > 0 else b""
                else:
                    body = self._read_body(n)
                    if body is None:
                        return  # cut at the deadline; 408 sent
                code, headers, out = predict_backend.handle_predict(
                    body)
                self._send(code, out, "application/json",
                           headers=headers)
            except (BrokenPipeError, ConnectionResetError):
                pass  # caller went away mid-write; nothing to save

        def _read_body(self, n: int) -> Optional[bytes]:
            """Read the request body against the per-connection
            deadline: chunked, so a slow-loris client dribbling
            bytes cannot extend its stay - the ABSOLUTE deadline
            (set when the body read starts) cuts it regardless of
            per-read progress. Returns None when the connection was
            cut (408 already sent, socket closing)."""
            if n <= 0:
                return b""
            deadline = (time.monotonic() + limits.conn_timeout_s
                        if limits.conn_timeout_s > 0 else None)
            chunks: List[bytes] = []
            got = 0
            try:
                while got < n:
                    # serve_slow_client fault point (CXXNET_FAULT):
                    # delay mode stalls this loop exactly like a
                    # dribbling client, so the deadline cut is
                    # testable without a real slow socket
                    fault.fault_point("serve_slow_client")
                    if (deadline is not None
                            and time.monotonic() >= deadline):
                        raise TimeoutError("body read deadline")
                    chunk = self.rfile.read(min(n - got, 65536))
                    if not chunk:
                        break  # short body; json decode will 400 it
                    chunks.append(chunk)
                    got += len(chunk)
            except (TimeoutError, OSError):
                limits.note_timeout("body")
                self.close_connection = True
                try:
                    self._send(408, json.dumps({
                        "error": "request body read timed out",
                        "timeout_ms": round(
                            limits.conn_timeout_s * 1e3, 1),
                    }).encode(), "application/json")
                except OSError:
                    pass  # client gone; the cut still counted
                return None
            return b"".join(chunks)

        def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    self._send(200, render_prometheus(tel).encode(),
                               PROM_CONTENT_TYPE)
                elif path == "/varz":
                    rec = tel.snapshot_record(kind="varz")
                    if tel.flight.enabled:
                        # flight-recorder tail rides the varz record
                        # (extra key; the metrics-stream schema's
                        # parsers read known keys): a remote operator
                        # sees the in-flight dispatch of a hung host
                        # without shell access to it
                        rec["flight"] = tel.flight.tail(32)
                    self._send(200, json.dumps(
                        _sanitize(rec), separators=(",", ":"),
                        default=str).encode(), "application/json")
                elif path == "/executables":
                    rec = tel._record("executables", {
                        "executables": tel.executables.snapshot(),
                        "in_flight": tel.flight.in_flight()})
                    self._send(200, json.dumps(
                        _sanitize(rec), separators=(",", ":"),
                        default=str).encode(), "application/json")
                elif path in ("/healthz", "/health"):
                    ok, reasons = tel.health.status()
                    body = json.dumps(
                        {"ok": ok, "reasons": reasons}).encode()
                    self._send(200 if ok else 503, body,
                               "application/json")
                else:
                    self._send(404, b"not found\n", "text/plain")
            except (BrokenPipeError, ConnectionResetError):
                pass  # scraper went away mid-write; nothing to save

        def log_message(self, *args) -> None:
            # BaseHTTPRequestHandler logs every request to stderr by
            # default - scrape traffic must never touch the CLI's
            # stderr (byte-parity applies to the ARMED run's normal
            # lines too; scrapes are not run output)
            pass

        def log_error(self, fmt, *args) -> None:
            # the parent's handle_one_request absorbs a HEADER-phase
            # socket timeout (the classic slow-loris: connect, never
            # finish the request line) and reports it only here
            # ("Request timed out: ..."), so this override is where
            # that cut becomes a counted serve.conn_timeouts event
            if limits is not None and "timed out" in str(fmt):
                limits.note_timeout("headers")

    return _Handler


class ObservabilityServer:
    """Background exposition server. Binds at construction (so the
    resolved port - meaningful with port=0 ephemeral binds in tests -
    is immediately readable), serves on a daemon thread after
    ``start()``, and ``close()`` shuts the socket down and joins."""

    def __init__(self, tel, port: int = 0, host: str = "0.0.0.0",
                 predict_backend=None, conn_timeout_ms: float = 0.0,
                 max_conns: int = 0, max_body_bytes: int = 0,
                 conn_clear_ms: float = 1000.0):
        limits = None
        if ((conn_timeout_ms or 0) > 0 or (max_conns or 0) > 0
                or (max_body_bytes or 0) > 0):
            limits = IngressLimits(
                tel, max_conns=max_conns,
                conn_timeout_ms=conn_timeout_ms,
                max_body_bytes=max_body_bytes,
                clear_ms=conn_clear_ms)
        self._limits = limits
        handler = _make_handler(tel, predict_backend=predict_backend,
                                limits=limits)
        if limits is not None:
            self._srv = _IngressServer((host, int(port)), handler,
                                       limits)
        else:
            # unarmed parity: the exact pre-hardening server class
            self._srv = ThreadingHTTPServer((host, int(port)), handler)
            self._srv.daemon_threads = True
        self.port: int = self._srv.server_address[1]
        self.host = host
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObservabilityServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._srv.serve_forever,
                name="telemetry-http", daemon=True)
            self._thread.start()
        return self

    def ingress_stats(self) -> Dict[str, int]:
        """Connection-gate counters (empty dict when the ingress
        limits are unarmed); merged into Server.stats()."""
        return self._limits.stats() if self._limits is not None else {}

    def close(self) -> None:
        if self._thread is not None:
            self._srv.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._srv.server_close()
        if self._limits is not None:
            self._limits.release_health()
