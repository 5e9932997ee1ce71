"""Continuous-batching inference server and its production front
(counterpart of cxxnet_tpu/serve/server.py, docs/SERVING.md).

- a **shared request queue**: `submit()` is thread-safe and returns a
  future; requests larger than the biggest bucket split internally and
  re-join on `result()`;
- **continuous/dynamic batching into padded buckets**: dispatchers
  coalesce queued requests up to `max_batch` rows and run the smallest
  bucket (powers of two up to `max_batch`, plus `max_batch`, or an
  explicit `serve_bucket_ladder`) that covers them, padding the tail
  with zero rows that never reach a caller;
- **warmed buckets**: `warmup()` runs every bucket once on every
  replica's lane, so cuDNN's per-shape setup and the kernels' first-use
  build happen before traffic, and registers each bucket program in the
  executable registry (telemetry/flight.py). `executable_cache_size()`
  is the number of registered bucket programs: it equals len(buckets)
  after warmup and stays flat over any request mix and across a swap;
- **replica lanes** (the port's form of what jax's async dispatch gives
  the JAX Server): `replicas` dispatcher threads drain the shared queue.
  On the card each works on its OWN CUDA stream: it stages its bucket
  from its own pinned host buffer (one per replica, sized to the
  largest bucket), issues the forward on that stream and reads the
  rows back with a non-blocking copy into pinned memory plus an event,
  so one replica's copies overlap another's compute. The event is
  waited on before the futures resolve, so a replica holds one batch
  at a time. `torch.inference_mode` and the
  current stream are thread-local, so each replica thread sets both;
- **weight slots**: a dispatch binds one slot (master params + the
  compute params made from them by the InferGraph) at dispatch time
  and calls the graph with them directly. `swap_to` builds a new slot
  outside every lock, on a staging stream whose event is waited on
  before the slot is published; in-flight batches finish on the slot
  they bound, and no tensor of a live slot is ever written in place;
- an **admission/flush policy**: a dispatcher waits up to
  `max_wait_ms` for the bucket to fill, then flushes what it has
  (fill-or-timeout), so p99 latency stays bounded under low load.

The production front (docs/SERVING.md "Serving over HTTP", "Hot-swap
runbook", "Canary runbook", "Connection limits & drain"):

- **HTTP request path**: `Server(http_port=N)` (CLI `serve_port=`)
  attaches a `/predict` POST endpoint to the same stdlib listener that
  serves `/metrics`/`/healthz` (telemetry/http.py);
- **backpressure + load shedding**: a hard `queue_limit` (rows) above
  which `submit()` raises QueueFullError and `/predict` answers 429
  with a Retry-After from the queue depth over the measured drain rate;
  shedding flips `/healthz` to 503 (`serve_shed`) until the queue
  drains below half the limit for `serve_shed_clear_ms`;
- **per-request deadlines**: `deadline_ms` expires queued requests
  BEFORE dispatch (DeadlineExpiredError in process, 504 over HTTP);
- **zero-downtime hot-swap**: `swap_to(path)` (or the `swap_watch=`
  poller) validates the checkpoint's crc32 trailer, loads it, checks
  the param tree, stages the new slot and switches between batches
  under `_swap_lock`; a torn or mismatched file is rejected and the old
  weights keep serving;
- **canaried rollout with automatic rollback** (`swap_canary_frac=`):
  a validated checkpoint is staged as a CANDIDATE slot; a deterministic
  fraction of requests (crc32 of the trace id) binds it, a judge
  thread scores it over `swap_canary_window` seconds (error/deadline
  rates, shadow pairs) and promotes it or rolls it back, leaving the
  incumbent untouched;
- **hardened ingress + graceful drain**: `serve_conn_timeout_ms` /
  `serve_max_conns` / `serve_max_body_bytes` plumb to the listener;
  `drain()` (SIGTERM in `task=serve`) stops admission, flips /healthz
  to a draining 503, resolves everything queued, then stops.

Extra inputs (`extra_data_num`) are not ported: a request carrying any
is refused (400 over HTTP). Every device call runs outside the locks.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cxxnet_tpu_torch import telemetry
from cxxnet_tpu_torch.telemetry.flight import fingerprint as exec_fingerprint
from cxxnet_tpu_torch.utils import fault
from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# Retry-After advice when the drain-rate EWMA has no samples yet (a
# cold or just-restarted Server has dispatched nothing): the
# documented default the 429 header carries instead of an estimate
# derived from uninitialized state (docs/SERVING.md)
RETRY_AFTER_COLD_S = 1.0


def _trace_side(trace: str, frac: float) -> int:
    """Deterministic canary routing: hash of the request trace id
    against the traffic fraction - 1 = candidate, 0 = incumbent. Keyed
    on the trace so every split part of an oversize request lands on
    the same weight generation."""
    return 1 if zlib.crc32(trace.encode()) % 10000 < frac * 10000 else 0


class QueueFullError(RuntimeError):
    """submit() rejected: the queue is at `queue_limit` rows (load
    shedding). Carries the advice an HTTP 429 turns into a Retry-After
    header: `retry_after_s` and the `queue_depth` at rejection."""

    def __init__(self, msg: str, retry_after_s: float,
                 queue_depth: int) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth


class DeadlineExpiredError(RuntimeError):
    """The request's deadline passed while it was still queued; it was
    dropped before dispatch. HTTP callers see 504."""


def _check_max_batch(max_batch: int) -> None:
    if max_batch < 1:
        raise ValueError("serve_max_batch must be >= 1")


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """The padded-batch bucket set: powers of two up to `max_batch`,
    plus `max_batch` itself."""
    _check_max_batch(max_batch)
    out = set()
    b = 1
    while b <= max_batch:
        out.add(b)
        b *= 2
    out.add(max_batch)
    return tuple(sorted(out))


def ladder_buckets(ladder: Sequence[int], max_batch: int) -> Tuple[int, ...]:
    """An explicit bucket ladder (`serve_bucket_ladder =`) folded into a
    valid bucket set: rungs outside [1, max_batch] are dropped, and
    `max_batch` closes the ladder."""
    _check_max_batch(max_batch)
    out = {int(b) for b in ladder if 1 <= int(b) <= max_batch}
    out.add(max_batch)
    return tuple(sorted(out))


def ladder_from_histogram(hist, max_batch: int,
                          rungs: int = 4) -> Tuple[int, ...]:
    """Shape a bucket ladder from an observed request-size histogram
    ({size: count}, the Server's `request_sizes` stat): one rung at
    each 1/rungs quantile of the size distribution, closed by
    `max_batch`. Falls back to bucket_sizes on an empty histogram."""
    sizes = sorted((int(s), int(c)) for s, c in dict(hist).items()
                   if int(c) > 0 and int(s) >= 1)
    if not sizes:
        return bucket_sizes(max_batch)
    total = sum(c for _, c in sizes)
    ladder = []
    for r in range(1, max(rungs, 1) + 1):
        target = r * total / max(rungs, 1)
        acc = 0
        for s, c in sizes:
            acc += c
            if acc >= target:
                ladder.append(s)
                break
    return ladder_buckets(ladder, max_batch)


def predictions_from_rows(rows: np.ndarray) -> np.ndarray:
    """The TransformPred rule (trainer.predict) applied to raw final-
    node rows: single-column output passes through as scalars, wider
    output argmaxes - so a serve result file is comparable line for
    line with a `task = pred` file."""
    rows = np.asarray(rows)
    flat = rows.reshape(rows.shape[0], -1)
    if flat.shape[1] == 1:
        return flat[:, 0]
    return np.argmax(flat, axis=1).astype(np.float32)


class _Future:
    """Minimal one-shot result future carrying its request trace id."""

    __slots__ = ("_ev", "_value", "_error", "trace")

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.trace = ""

    def _set(self, value) -> None:
        self._value = value
        self._ev.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("serve request still pending")
        if self._error is not None:
            raise self._error
        return self._value


class _JoinedFuture:
    """A request that split into several work items: result() is the
    row-concatenation of the parts, in submission order."""

    __slots__ = ("_parts",)

    def __init__(self, parts: List[_Future]) -> None:
        self._parts = parts

    @property
    def trace(self) -> str:
        return self._parts[0].trace if self._parts else ""

    def done(self) -> bool:
        return all(p.done() for p in self._parts)

    def result(self, timeout: Optional[float] = None):
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        out = []
        for p in self._parts:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            out.append(p.result(left))
        return np.concatenate(out, axis=0)


class _Slot:
    """One weight generation: the float32 master params and the compute
    params the serving graph reads, made from them once. Immutable once
    published."""

    __slots__ = ("master", "cparams", "epoch")

    def __init__(self, master, cparams, epoch: int) -> None:
        self.master = master
        self.cparams = cparams
        self.epoch = epoch


class _Canary:
    """A staged candidate weight generation under judgment. Every
    mutable field moves under the owning Server's `_swap_lock`; the
    judge thread snapshots under the lock and dispatches shadow pairs
    outside it."""

    __slots__ = ("slot", "path", "epoch", "frac", "t0", "n_req",
                 "n_err", "n_exp", "shadow", "shadow_done",
                 "provenance")

    def __init__(self, slot: _Slot, path: str, epoch: int,
                 frac: float) -> None:
        self.slot = slot
        self.path = path
        self.epoch = epoch
        self.frac = frac
        self.t0 = time.monotonic()
        # per-side accounting over the judging window, indexed
        # [incumbent, candidate]
        self.n_req = [0, 0]
        self.n_err = [0, 0]
        self.n_exp = [0, 0]
        # sampled incumbent request rows pending a shadow comparison
        self.shadow: List[np.ndarray] = []
        self.shadow_done = 0
        self.provenance: Dict[str, Any] = {}


class _WorkItem:
    __slots__ = ("data", "n", "t_submit", "future", "trace", "part",
                 "nparts", "t_collect", "deadline", "side")

    def __init__(self, data, t_submit, trace="", part=0, nparts=1,
                 deadline=0.0) -> None:
        self.data = data
        self.n = data.shape[0]
        self.t_submit = t_submit
        self.future = _Future()
        # absolute monotonic expiry (0 = none), checked at queue-pop
        self.deadline = deadline
        self.trace = trace
        self.part = part
        self.nparts = nparts
        self.t_collect = 0.0
        # canary routing side (0 = incumbent, 1 = candidate)
        self.side = 0


class _Lane:
    """One replica's device lane. On the card: its own CUDA stream, one
    pinned input buffer (rows in the staged dtype) and one pinned
    output buffer (float32 rows), each sized to the largest bucket. A
    batch is copied into the pinned input, crosses with a non-blocking
    copy on the lane's stream, runs there, and its rows come back with
    a non-blocking copy into the pinned output; the event recorded
    after that copy is waited on before the rows are copied out and
    handed on. So a lane holds one batch at a time: replicas overlap
    one another (one stream each), a lane does not overlap its own
    batches. On the CPU: rows are staged and read back inline."""

    def __init__(self, trainer, max_rows: int, in_dims) -> None:
        self.trainer = trainer
        self.device = trainer.device
        self.cuda = self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(self.device) if self.cuda
                       else None)
        self.max_rows = max_rows
        self.in_dims = tuple(in_dims)
        self._in: Dict[torch.dtype, torch.Tensor] = {}
        self._out: Optional[torch.Tensor] = None

    def run(self, graph, cparams, data: np.ndarray) -> np.ndarray:
        """(n, width) float32 rows of `graph` on `data` with `cparams`."""
        tr = self.trainer
        n = data.shape[0]
        if not self.cuda:
            out = graph.run(cparams, tr.stage_infer_rows(data))
            return out.reshape(n, -1).numpy()
        arr = tr._host_rows(data)
        dt = tr._staged_dtype(arr)
        pin = self._in.get(dt)
        if pin is None:
            pin = self._in[dt] = torch.empty(
                (self.max_rows,) + self.in_dims, dtype=dt,
                pin_memory=True)
        host = pin[:n]
        # the host-side cast of stage_infer_rows (round to nearest
        # even into the staged dtype), written straight into pinned
        # memory; the previous batch's event was waited on, so its
        # copy out of this buffer is complete
        host.copy_(torch.from_numpy(arr))
        with torch.cuda.stream(self.stream):
            gdata = tr._on_device(host.to(self.device, non_blocking=True))
            out = graph.run(cparams, gdata).reshape(n, -1)
            pout = self._out
            if pout is None or pout.shape[1] != out.shape[1]:
                pout = self._out = torch.empty(
                    (self.max_rows, out.shape[1]), dtype=torch.float32,
                    pin_memory=True)
            pout[:n].copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        ready.synchronize()
        # copied out: the next batch reuses the buffer
        return pout[:n].numpy().copy()


class Server:
    """Continuous-batching server over a trainer's inference graph. The
    trainer must hold a model (init_model or load_model) and live on
    `device` - `cuda:0` unless the caller asks for the CPU; with no
    card the default raises.

    start() spawns the dispatcher replicas (warmup() first, so the
    first requests do not pay the setup); submit() from any thread;
    stop() drains the queue, joins the replicas and returns stats().
    Usable as a context manager."""

    def __init__(self, trainer, max_batch: int = 0,
                 max_wait_ms: Optional[float] = None,
                 replicas: Optional[int] = None,
                 node: int = -1,
                 metrics_port: Optional[int] = None,
                 metrics_host: str = "0.0.0.0",
                 ladder: Optional[Sequence[int]] = None,
                 http_port: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 swap_watch: Optional[str] = None,
                 swap_poll_ms: Optional[float] = None,
                 canary_frac: Optional[float] = None,
                 canary_window: Optional[float] = None,
                 conn_timeout_ms: Optional[float] = None,
                 max_conns: Optional[int] = None,
                 max_body_bytes: Optional[int] = None,
                 device: str = DEFAULT_DEVICE) -> None:
        dev = resolve_device(device)
        if trainer.state is None:
            raise RuntimeError(
                "Server needs an initialized trainer (init_model or "
                "load_model first)")
        if trainer.device != dev:
            raise ValueError(
                f"Server(device={device!r}) but the trainer lives on "
                f"{trainer.device}; build both on one device")
        self.trainer = trainer
        self.device = dev
        self.max_batch = int(max_batch or trainer.serve_max_batch
                             or trainer.batch_size)
        self.max_wait_ms = float(trainer.serve_max_wait_ms
                                 if max_wait_ms is None else max_wait_ms)
        self.replicas = int(trainer.serve_replicas if replicas is None
                            else replicas)
        if self.replicas < 1:
            raise ValueError("serve_replicas must be >= 1")
        self.node = node if node >= 0 else trainer.net_cfg.num_nodes - 1
        lad = (ladder if ladder is not None
               else getattr(trainer, "serve_ladder", None))
        self.buckets = (ladder_buckets(lad, self.max_batch) if lad
                        else bucket_sizes(self.max_batch))
        if trainer.passes_need_calibration():
            # the Server serves the graph of the calibration epoch it
            # is built at: warmup rows of zeros must never become the
            # calibration batch
            telemetry.stderr(
                "serve: graph passes (fold_conv_bn/quantize_int8) have "
                "no calibration stats; serving the unoptimized float "
                "graph (calibrate before Server creation to "
                "fold/quantize)\n",
                event_kind="serve", op="fold_uncalibrated")
        self._graph = trainer.infer_graph(self.node)
        self._input_dims = tuple(trainer.net_cfg.input_shape)
        # the HTTP listener (serve_port = metrics_port: one socket)
        if http_port is None:
            cfg_port = int(getattr(trainer, "serve_port", 0) or 0)
            if cfg_port > 0:
                http_port = cfg_port
        if (http_port is not None and metrics_port is not None
                and int(http_port) != int(metrics_port)):
            raise ValueError(
                "serve_port and metrics_port attach ONE listener; "
                f"set them equal or drop one (got {http_port} vs "
                f"{metrics_port})")
        self.http_port = http_port
        self.metrics_port = (metrics_port if metrics_port is not None
                             else http_port)
        self.metrics_host = metrics_host
        self.metrics_server = None
        if self.metrics_port is not None:
            # the attached endpoint is a flight-recorder consumer
            # (/varz tail, /executables): armed here so warmup()'s
            # enrichment sees it
            telemetry.get().flight.enabled = True
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        # guarded-by: self._cond
        self._queued_rows = 0
        self._threads: List[threading.Thread] = []
        # guarded-by: self._cond
        self._draining = False
        self._started = False
        self.warmup_s = 0.0
        self.queue_limit = int(trainer.serve_queue_limit
                               if queue_limit is None else queue_limit)
        self.deadline_ms = float(trainer.serve_deadline_ms
                                 if deadline_ms is None else deadline_ms)
        self.shed_clear_ms = float(trainer.serve_shed_clear_ms)
        # guarded-by: self._cond
        self._last_shed_t = 0.0
        # guarded-by: self._cond
        self._shed_health = False
        # _swap_lock orders the slot switch against dispatch snapshots;
        # only attribute reads/writes happen under it - staging and
        # warmup stay outside
        self._swap_lock = threading.Lock()
        self.swap_watch = (swap_watch if swap_watch is not None
                           else trainer.swap_watch) or ""
        self.swap_poll_ms = float(trainer.swap_poll_ms
                                  if swap_poll_ms is None else swap_poll_ms)
        self._swap_thread: Optional[threading.Thread] = None
        self._swap_stop = threading.Event()
        self.canary_frac = float(trainer.swap_canary_frac
                                 if canary_frac is None else canary_frac)
        if not 0.0 <= self.canary_frac <= 1.0:
            raise ValueError("swap_canary_frac must be in [0, 1]")
        self.canary_window = float(trainer.swap_canary_window
                                   if canary_window is None
                                   else canary_window)
        if self.canary_window <= 0:
            raise ValueError("swap_canary_window must be > 0")
        # guarded-by: self._swap_lock
        self._canary: Optional[_Canary] = None
        self._canary_thread: Optional[threading.Thread] = None
        self._canary_stop = threading.Event()
        self.conn_timeout_ms = float(trainer.serve_conn_timeout_ms
                                     if conn_timeout_ms is None
                                     else conn_timeout_ms)
        self.max_conns = int(trainer.serve_max_conns
                             if max_conns is None else max_conns)
        self.max_body_bytes = int(trainer.serve_max_body_bytes
                                  if max_body_bytes is None
                                  else max_body_bytes)
        # guarded-by: self._swap_lock
        self._swap_seen: Optional[Tuple[int, int]] = None
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._n_requests = 0
        self._n_rows = 0
        self._n_batches = 0
        self._n_padding = 0
        self._n_errors = 0
        self._n_shed = 0
        self._n_shed_rows = 0
        self._n_expired = 0
        self._n_swaps = 0
        self._n_swap_rejected = 0
        self._n_canary_req = 0
        self._n_canary_promoted = 0
        self._n_canary_rolled_back = 0
        # measured drain rate (rows/s, EWMA over dispatched batches):
        # what Retry-After is derived from
        self._drain_rate = 0.0
        self._last_drain_t = 0.0
        self._bucket_hits: Dict[int, int] = {b: 0 for b in self.buckets}
        self._size_hist: Dict[int, int] = {}
        self._lat = telemetry.Histogram()
        # per-request queue-vs-device decomposition: queue = submit ->
        # dispatch (incl. the fill-or-timeout wait), device = dispatch
        # -> rows read back
        self._qlat = telemetry.Histogram()
        self._dlat = telemetry.Histogram()
        self._req_hist = telemetry.get().registry.bucket_histogram(
            "serve.request_rows", bounds=self.buckets)
        self._trace_seq = itertools.count(1)
        self._exec_fp: Dict[int, str] = {}
        # every bucket program fingerprint this Server registered
        self._programs: set = set()
        # one lane per replica, plus the canary judge's own
        self._lanes = [_Lane(trainer, self.buckets[-1], self._input_dims)
                       for _ in range(self.replicas)]
        self._judge_lane = _Lane(trainer, self.buckets[-1],
                                 self._input_dims)
        # guarded-by: self._swap_lock
        self._slot = self._make_slot(trainer.state["params"],
                                     trainer.epoch)

    # -- weight slots ------------------------------------------------------
    def _make_slot(self, master, epoch: int, graph=None) -> _Slot:
        """A slot around `master`: the graph's compute params made on a
        staging stream (on the card), whose event is waited on before
        the slot is returned - a slot is complete before any replica
        stream can read it. Runs outside every lock."""
        graph = graph or self._graph
        if self.device.type != "cuda":
            return _Slot(master, graph.bind(master), epoch)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            cparams = graph.bind(master)
            ready = torch.cuda.Event()
            ready.record(stream)
        ready.synchronize()
        return _Slot(master, cparams, epoch)

    # -- lifecycle ---------------------------------------------------------
    def warmup(self) -> float:
        """Run every bucket once on zero rows on every replica's lane,
        register each bucket program, and (plane armed) enrich it with
        its forward FLOPs. Returns the wall seconds spent; also
        recorded as `serve.warmup_s`. On a running Server (a swap that
        retired frozen calibration) the replicas own their lanes, so
        the buckets run on a lane of the warmup's own."""
        t0 = time.perf_counter()
        tel = telemetry.get()
        with self._swap_lock:
            graph, slot = self._graph, self._slot
        lanes = (self._lanes if not self._started else
                 [_Lane(self.trainer, self.buckets[-1], self._input_dims)])
        epoch = self.trainer._fold_epoch
        with torch.inference_mode():
            for b in self.buckets:
                data = np.zeros((b,) + self._input_dims, np.float32)
                tb = time.perf_counter()
                for lane in lanes:
                    lane.run(graph, slot.cparams, data)
                first_s = time.perf_counter() - tb
                fp = exec_fingerprint("serve.infer", self.node, b,
                                      self._input_dims, epoch)
                self._exec_fp[b] = fp
                self._programs.add(fp)
                tel.executables.register(
                    fp, name=f"serve.infer:b{b}", kind="serve",
                    shape=str((b,) + self._input_dims),
                    arg_bytes=int(data.nbytes),
                    device=str(self.device), donated=0,
                    compile_s=first_s)
                if tel.flight.enabled:
                    gdata = self.trainer.stage_infer_rows(data)
                    tel.executables.enrich(fp, graph.run,
                                           (slot.cparams, gdata))
        self.warmup_s = time.perf_counter() - t0
        telemetry.observe("serve.warmup_s", self.warmup_s)
        telemetry.event("serve", op="warmup", buckets=list(self.buckets),
                        secs=self.warmup_s)
        return self.warmup_s

    def executable_cache_size(self) -> int:
        """Number of bucket programs this Server registered: len(buckets)
        after warmup, flat under any request mix and across a plain
        swap (a swap binds a new slot, not a new program)."""
        return len(self._programs)

    def start(self) -> "Server":
        if self._started:
            return self
        if self.metrics_port is not None and self.metrics_server is None:
            from cxxnet_tpu_torch.telemetry.http import ObservabilityServer
            self.metrics_server = ObservabilityServer(
                telemetry.get(), int(self.metrics_port),
                host=self.metrics_host,
                predict_backend=(self if self.http_port is not None
                                 else None),
                conn_timeout_ms=self.conn_timeout_ms,
                max_conns=self.max_conns,
                max_body_bytes=self.max_body_bytes,
                conn_clear_ms=self.shed_clear_ms)
            self.metrics_server.start()
            telemetry.event("observability", op="http_start",
                            port=self.metrics_server.port,
                            host=self.metrics_host,
                            predict=self.http_port is not None)
        with self._cond:
            self._draining = False
        with self._lock:
            # a restarted Server serves a fresh traffic mix: the old
            # drain-rate EWMA is stale advice
            self._drain_rate = 0.0
            self._last_drain_t = 0.0
        self._started = True
        for i, lane in enumerate(self._lanes):
            t = threading.Thread(target=self._replica_loop, args=(lane,),
                                 name=f"serve-replica-{i}", daemon=True)
            self._threads.append(t)
            t.start()
        if self.swap_watch and self._swap_thread is None:
            # the file's CURRENT state counts as already served; only a
            # later publish triggers a swap
            with self._swap_lock:
                self._swap_seen = self._swap_stat()
            self._swap_stop.clear()
            self._swap_thread = threading.Thread(
                target=self._swap_watch_loop, name="serve-swap-watch",
                daemon=True)
            self._swap_thread.start()
        return self

    def stop(self, drain: bool = True) -> Dict[str, Any]:
        """Stop the replicas - after draining the queue (default), or
        immediately failing queued requests (drain=False) - and return
        stats(). Idempotent."""
        if self._swap_thread is not None:
            self._swap_stop.set()
            self._swap_thread.join(timeout=10.0)
            self._swap_thread = None
        if self._canary_thread is not None:
            # an undecided canary fails safe at shutdown: rolled back
            self._canary_stop.set()
            self._canary_thread.join(timeout=15.0)
            self._canary_thread = None
        with self._cond:
            self._draining = True
            if not drain:
                while self._queue:
                    it = self._queue.popleft()
                    self._queued_rows -= it.n
                    it.future._set_error(
                        RuntimeError("server stopped before dispatch"))
            self._cond.notify_all()
            shed_held = self._shed_health
            self._shed_health = False
        if shed_held:
            telemetry.get().health.clear("serve_shed")
        for t in self._threads:
            t.join(timeout=60.0)
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not stop within 60 s")
        self._threads = []
        self._started = False
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        if self.metrics_port is not None:
            telemetry.get()._refresh_flight()
        telemetry.set_gauge("serve.queue_depth", 0.0)
        stats = self.stats()
        telemetry.event("serve", op="stop", **{
            k: v for k, v in stats.items() if not isinstance(v, dict)})
        return stats

    def drain(self) -> Dict[str, Any]:
        """Graceful shutdown (`task=serve` runs this on SIGTERM): stop
        admitting - new submits raise and /predict answers 503 - flip
        /healthz to a `serve_drain` 503, resolve EVERYTHING already
        queued, then stop. Returns the final stats()."""
        with self._cond:
            depth = self._queued_rows
            self._draining = True
            self._cond.notify_all()
        telemetry.get().health.set_unhealthy(
            "serve_drain", "draining: shutdown in progress")
        telemetry.event("serve", op="drain_start", queue_rows=depth)
        try:
            stats = self.stop(drain=True)
        finally:
            telemetry.get().health.clear("serve_drain")
        telemetry.event("serve", op="drain_done", queue_rows=depth,
                        errors=stats.get("errors"))
        return stats

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- submission --------------------------------------------------------
    def submit(self, data: np.ndarray, extras: Sequence = (),
               deadline_ms: Optional[float] = None):
        """Enqueue one request: (n, c, y, x) rows or a single (c, y, x)
        instance. Returns a future whose result() is the raw final-node
        rows, (n, width) float32 - predictions_from_rows turns them into
        predict()-style labels. Thread-safe; requests wider than the
        largest bucket split transparently.

        `deadline_ms` overrides the server default (serve_deadline_ms;
        0 = none). With `queue_limit` set, a submit that would push the
        queue past the limit raises QueueFullError instead. `extras`
        must be empty: extra inputs are not ported."""
        if not self._started:
            raise RuntimeError("Server not started (call start())")
        data = np.ascontiguousarray(data)
        if data.ndim == 3:
            data = data[None]
        if data.ndim != 4 or data.shape[1:] != self._input_dims:
            c, y, x = self._input_dims
            raise ValueError(
                f"serve request must be (n, {c}, {y}, {x}) or a single "
                f"instance; got {data.shape}")
        if data.shape[0] < 1:
            raise ValueError("serve request needs at least one row")
        if len(extras):
            raise ValueError(
                f"net declares 0 extra inputs but the request carries "
                f"{len(extras)}")
        t_submit = time.monotonic()
        trace = f"{os.getpid():x}-{next(self._trace_seq):06d}"
        eff_ms = (self.deadline_ms if deadline_ms is None
                  else float(deadline_ms))
        deadline = t_submit + eff_ms / 1e3 if eff_ms > 0 else 0.0
        nparts = -(-data.shape[0] // self.max_batch)
        items = [_WorkItem(data[lo:lo + self.max_batch], t_submit,
                           trace=trace, part=part, nparts=nparts,
                           deadline=deadline)
                 for part, lo in enumerate(
                     range(0, data.shape[0], self.max_batch))]
        items[0].future.trace = trace
        shed_depth = -1
        with self._cond:
            if self._draining:
                raise RuntimeError("server is stopping")
            if (self.queue_limit > 0 and self._queued_rows
                    + data.shape[0] > self.queue_limit):
                # hard admission bound: reject, do NOT enqueue
                shed_depth = self._queued_rows
                self._last_shed_t = t_submit
                flip = not self._shed_health
                self._shed_health = True
            else:
                for it in items:
                    self._queue.append(it)
                    self._queued_rows += it.n
                depth = self._queued_rows
                self._cond.notify_all()
        if shed_depth >= 0:
            retry_s = self._retry_after(shed_depth + data.shape[0])
            with self._lock:
                self._n_shed += 1
                self._n_shed_rows += data.shape[0]
            telemetry.inc("serve.shed_total")
            telemetry.inc("serve.shed_rows", data.shape[0])
            if flip:
                reason = (f"load shed: queue {shed_depth} rows + "
                          f"{data.shape[0]} > limit {self.queue_limit}")
                telemetry.get().health.set_unhealthy("serve_shed", reason)
                telemetry.event("serve", op="shed",
                                queue_depth=shed_depth,
                                limit=self.queue_limit)
            raise QueueFullError(
                f"serve queue full ({shed_depth} rows >= limit "
                f"{self.queue_limit}); retry in {retry_s:.2f}s",
                retry_after_s=retry_s, queue_depth=shed_depth)
        with self._lock:
            self._n_requests += 1
            self._n_rows += data.shape[0]
            for it in items:
                self._size_hist[it.n] = self._size_hist.get(it.n, 0) + 1
        for it in items:
            self._req_hist.observe(it.n)
        telemetry.inc("serve.requests")
        telemetry.inc("serve.rows", data.shape[0])
        telemetry.set_gauge("serve.queue_depth", depth)
        if len(items) == 1:
            return items[0].future
        return _JoinedFuture([it.future for it in items])

    # -- backpressure helpers ----------------------------------------------
    def _retry_after(self, backlog_rows: int) -> float:
        """Retry-After advice for a shed request: the backlog over the
        measured drain rate, clamped to [0.1 s, 60 s]; with no sample
        yet (cold or restarted Server) RETRY_AFTER_COLD_S."""
        with self._lock:
            rate = self._drain_rate
        if not (rate > 0.0) or not np.isfinite(rate):
            return RETRY_AFTER_COLD_S
        adv = backlog_rows / rate
        if not np.isfinite(adv):
            return RETRY_AFTER_COLD_S
        return min(60.0, max(0.1, adv))

    def _maybe_recover(self) -> None:
        """Shed->healthy hysteresis: clear `serve_shed` once the queue
        is below HALF the limit AND no shed happened for
        shed_clear_ms."""
        now = time.monotonic()
        cleared = False
        with self._cond:
            if (self._shed_health
                    and self._queued_rows * 2 < max(self.queue_limit, 1)
                    and (now - self._last_shed_t)
                    >= self.shed_clear_ms / 1e3):
                self._shed_health = False
                cleared = True
        if cleared:
            telemetry.get().health.clear("serve_shed")
            telemetry.event("serve", op="shed_recovered",
                            limit=self.queue_limit)

    def _fail_expired(self, it: _WorkItem, now: float) -> None:
        """Resolve a deadline-expired item (called outside _cond)."""
        with self._lock:
            self._n_expired += 1
        if self.canary_frac > 0:
            with self._swap_lock:
                can = self._canary
                if can is not None:
                    can.n_exp[_trace_side(it.trace, can.frac)] += 1
        telemetry.inc("serve.deadline_expired")
        waited_ms = (now - it.t_submit) * 1e3
        it.future._set_error(DeadlineExpiredError(
            f"request deadline expired after {waited_ms:.1f} ms in "
            "queue (dropped before dispatch)"))
        telemetry.event("serve", op="deadline_expired", trace=it.trace,
                        part=it.part, rows=it.n,
                        waited_ms=round(waited_ms, 3))

    # -- dispatchers -------------------------------------------------------
    def _collect(self) -> Optional[List[_WorkItem]]:
        """Admission policy: block for work, then coalesce queued items
        up to max_batch rows, waiting at most max_wait_ms past the
        FIRST item's submit time (fill-or-timeout). Deadline-expired
        items drop here. Returns None when stopping and drained; an
        empty list means nothing live this round."""
        expired: List[_WorkItem] = []
        frac = 0.0
        if self.canary_frac > 0:
            with self._swap_lock:
                if self._canary is not None:
                    frac = self._canary.frac
        items = self._collect_locked(expired, frac)
        if expired:
            now = time.monotonic()
            for it in expired:
                self._fail_expired(it, now)
        if items is not None:
            self._maybe_recover()
        return items

    def _collect_locked(self, expired: List[_WorkItem],
                        frac: float = 0.0) -> Optional[List[_WorkItem]]:
        with self._cond:
            first = None
            while first is None:
                if not self._queue:
                    if self._draining:
                        return None
                    if expired:
                        break
                    if (self._shed_health and self._queued_rows * 2
                            < max(self.queue_limit, 1)
                            and time.monotonic() - self._last_shed_t
                            >= self.shed_clear_ms / 1e3):
                        # storm over, traffic gone: surface so the
                        # caller can clear the shed 503
                        break
                    self._cond.wait(0.05)
                    continue
                now = time.monotonic()
                while self._queue:
                    it = self._queue.popleft()
                    self._queued_rows -= it.n
                    if it.deadline and now > it.deadline:
                        expired.append(it)
                        continue
                    first = it
                    break
            if first is None:
                telemetry.set_gauge("serve.queue_depth", self._queued_rows)
                return []
            first.t_collect = time.monotonic()
            if frac > 0.0:
                first.side = _trace_side(first.trace, frac)
            items = [first]
            total = first.n
            deadline = first.t_submit + self.max_wait_ms / 1e3
            while total < self.max_batch:
                if self._queue:
                    head = self._queue[0]
                    if head.deadline and time.monotonic() > head.deadline:
                        self._queue.popleft()
                        self._queued_rows -= head.n
                        expired.append(head)
                        continue
                    if frac > 0.0:
                        head.side = _trace_side(head.trace, frac)
                        if head.side != first.side:
                            # a batch binds ONE weight generation
                            break
                    if head.n <= self.max_batch - total:
                        it = self._queue.popleft()
                        self._queued_rows -= it.n
                        it.t_collect = time.monotonic()
                        items.append(it)
                        total += it.n
                        continue
                    break  # head doesn't fit: ship what we have
                wait = deadline - time.monotonic()
                if wait <= 0 or self._draining:
                    break
                self._cond.wait(min(wait, 0.05))
            telemetry.set_gauge("serve.queue_depth", self._queued_rows)
            return items

    def _run_batch(self, items: List[_WorkItem], lane: _Lane) -> None:
        total = sum(it.n for it in items)
        bucket = next(b for b in self.buckets if b >= total)
        data = np.concatenate([it.data for it in items], axis=0)
        if bucket > total:
            data = np.concatenate(
                [data, np.zeros((bucket - total,) + data.shape[1:],
                                data.dtype)], axis=0)
        tel = telemetry.get()
        fp = self._exec_fp.get(bucket, "")
        fl = None
        if tel.flight.enabled:
            # opened before staging: a hung device leaves this entry
            # in flight with the program fingerprint and trace on it
            fl = tel.flight.start(
                "serve", fp=fp, bucket=bucket, nbytes=int(data.nbytes),
                trace=items[0].trace,
                fields={"rows": total, "requests": len(items)})
        t_dispatch = time.monotonic()
        try:
            fault.fault_point("serve_dispatch_delay")
            fault.fault_point("serve_dispatch_error")
            # bind ONE weight generation under the swap lock; the
            # device work runs outside it. A canary batch (side 1)
            # binds the candidate slot through the same graph.
            side = items[0].side
            routed = 0
            with self._swap_lock:
                graph = self._graph
                can = self._canary
                if can is not None and side == 1:
                    slot = can.slot
                    routed = len(items)
                else:
                    side = 0
                    slot = self._slot
                if can is not None:
                    can.n_req[side] += len(items)
                    if side == 0 and len(can.shadow) < 4:
                        can.shadow.append(items[0].data.copy())
            if routed:
                with self._lock:
                    self._n_canary_req += routed
                telemetry.inc("serve.canary_requests", routed)
            rows = lane.run(graph, slot.cparams, data)
        except BaseException as e:
            # a failed dispatch must not read as a hung one
            tel.flight.fail(fl, f"{type(e).__name__}: {e}")
            raise
        t_done = time.monotonic()
        tel.flight.finish(fl)
        if fp:
            tel.executables.count_dispatch(fp, secs=t_done - t_dispatch)
        off = 0
        for it in items:
            it.future._set(rows[off:off + it.n])
            off += it.n
            self._lat.observe(t_done - it.t_submit)
            telemetry.observe("serve.latency_s", t_done - it.t_submit)
            queue_s = max(t_dispatch - it.t_submit, 0.0)
            device_s = max(t_done - t_dispatch, 0.0)
            self._qlat.observe(queue_s)
            self._dlat.observe(device_s)
            telemetry.observe("serve.queue_s", queue_s)
            telemetry.observe("serve.device_s", device_s)
            tel.event("trace", trace=it.trace, part=it.part,
                      parts=it.nparts, rows=it.n, bucket=bucket,
                      fp=fp, t_submit=round(it.t_submit, 6),
                      t_collect=round(it.t_collect, 6),
                      t_dispatch=round(t_dispatch, 6),
                      t_done=round(t_done, 6),
                      queue_ms=round(queue_s * 1e3, 3),
                      device_ms=round(device_s * 1e3, 3))
        with self._lock:
            self._n_batches += 1
            self._n_padding += bucket - total
            self._bucket_hits[bucket] += 1
            # drain-rate EWMA over inter-completion gaps (rows/s across
            # all replicas)
            if self._last_drain_t > 0:
                gap = t_done - self._last_drain_t
                if gap > 1e-6:
                    inst = total / gap
                    self._drain_rate = (
                        inst if self._drain_rate <= 0
                        else 0.7 * self._drain_rate + 0.3 * inst)
            self._last_drain_t = t_done
        telemetry.inc("serve.batches")
        telemetry.inc("serve.padding_rows", bucket - total)
        telemetry.beacon("serve.batch")

    def _replica_loop(self, lane: _Lane) -> None:
        # inference mode and the current stream are thread-local: set
        # here, in the replica's own thread
        with torch.inference_mode():
            while True:
                items = self._collect()
                if items is None:
                    return
                if not items:
                    continue
                try:
                    self._run_batch(items, lane)
                except BaseException as e:  # noqa: BLE001 - delivered via futures
                    with self._lock:
                        self._n_errors += 1
                    if self.canary_frac > 0:
                        with self._swap_lock:
                            can = self._canary
                            if can is not None:
                                can.n_err[items[0].side] += 1
                    telemetry.inc("serve.errors")
                    telemetry.stderr(
                        f"serve: dispatch failed: {type(e).__name__}: "
                        f"{e}\n", event_kind="serve", op="error",
                        error=f"{type(e).__name__}: {e}")
                    for it in items:
                        if not it.future.done():
                            it.future._set_error(e)

    # -- checkpoint hot-swap -----------------------------------------------
    def _swap_stat(self) -> Optional[Tuple[int, int]]:
        try:
            st = os.stat(self.swap_watch)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _swap_watch_loop(self) -> None:
        """Poll the published-checkpoint path every swap_poll_ms and
        swap on any (mtime, size) change. The stat is recorded before
        the attempt, so a rejected file is skipped once."""
        poll_s = max(self.swap_poll_ms, 10.0) / 1e3
        while not self._swap_stop.wait(poll_s):
            cur = self._swap_stat()
            with self._swap_lock:
                if cur is None or cur == self._swap_seen:
                    continue
                self._swap_seen = cur
            try:
                self.swap_to(self.swap_watch)
            except BaseException as e:  # noqa: BLE001 - keep serving
                telemetry.stderr(
                    f"serve: swap attempt failed: "
                    f"{type(e).__name__}: {e}\n",
                    event_kind="swap", op="error",
                    error=f"{type(e).__name__}: {e}")

    def _params_mismatch(self, cur, new) -> Optional[str]:
        """A swap must be weight-compatible with the warmed buckets:
        identical param tree and leaf shapes. Returns the first
        mismatch as a reason string."""
        for lk in cur:
            if lk not in new:
                return f"checkpoint missing layer {lk!r}"
            for pn in cur[lk]:
                if pn not in new[lk]:
                    return f"checkpoint missing param {lk}/{pn}"
                want = tuple(cur[lk][pn].shape)
                got = tuple(np.shape(new[lk][pn]))
                if want != got:
                    return (f"shape mismatch at {lk}/{pn}: "
                            f"checkpoint {got} vs serving {want}")
        extra = [f"{lk}/{pn}" for lk in new for pn in new[lk]
                 if lk not in cur or pn not in cur[lk]]
        if extra:
            return f"checkpoint has unknown params: {extra[:3]}"
        return None

    def swap_to(self, path: str) -> bool:
        """Zero-downtime weight swap from an atomic checksummed
        checkpoint: validate the crc32 trailer, load, verify the param
        tree, stage the new slot (all outside any lock), then switch
        between batches under _swap_lock. Returns True on an applied
        swap (or a started canary); a torn/corrupt/mismatched file
        emits `swap` op=rejected and the old weights keep serving."""
        from cxxnet_tpu_torch.nnet import checkpoint
        t0 = time.perf_counter()
        blob = None
        reason = checkpoint.validate_file(path)
        if reason is None:
            try:
                with open(path, "rb") as fi:
                    blob = checkpoint.load_model(fi)
            except (OSError, ValueError) as e:
                reason = f"{type(e).__name__}: {e}"
        if reason is None:
            with self._swap_lock:
                cur = self._slot.master
            reason = self._params_mismatch(cur, blob["params"])
        if reason is not None:
            with self._lock:
                self._n_swap_rejected += 1
            telemetry.inc("serve.swap_rejected")
            telemetry.stderr(
                f"serve: checkpoint swap rejected ({path}): {reason}\n",
                event_kind="swap", op="rejected", path=path,
                reason=reason)
            return False
        epoch = int(blob.get("epoch", self.trainer.epoch))
        tr = self.trainer
        if self.canary_frac > 0:
            if tr._fold_stats is not None or tr._quant_stats is not None:
                # frozen calibration describes the OLD weights: the
                # candidate could not share the incumbent's graph
                telemetry.stderr(
                    f"serve: canary bypassed for {path}: calibrated "
                    f"passes force a rewarm, applying directly\n",
                    event_kind="swap", op="canary_bypassed", path=path)
            else:
                with self._swap_lock:
                    busy = self._canary is not None
                if busy:
                    with self._lock:
                        self._n_swap_rejected += 1
                    telemetry.inc("serve.swap_rejected")
                    telemetry.stderr(
                        f"serve: checkpoint swap rejected ({path}): "
                        f"canary already in progress\n",
                        event_kind="swap", op="rejected", path=path,
                        reason="canary already in progress")
                    return False
                slot = self._make_slot(self._stage_master(blob), epoch)
                return self._start_canary(slot, path, epoch)
        master = self._stage_master(blob)
        old_fold = tr._fold_epoch
        # frozen fold/quant calibration described the OLD weights:
        # retire it (a new graph, re-warmed); with no calibrating pass
        # this is a no-op and the swap is a plain slot switch
        tr._retire_calibration_state()
        rewarmed = tr._fold_epoch != old_fold
        graph = tr.infer_graph(self.node) if rewarmed else None
        slot = self._make_slot(master, epoch, graph)
        with self._swap_lock:
            if rewarmed:
                self._graph = graph
            self._slot = slot
            tr.state["params"] = master
            tr.epoch = epoch
        tr._weights_changed()
        if rewarmed:
            self.warmup()
        with self._lock:
            self._n_swaps += 1
        telemetry.inc("serve.swaps")
        telemetry.event("swap", op="applied", path=path, epoch=epoch,
                        rewarmed=rewarmed,
                        secs=round(time.perf_counter() - t0, 4))
        return True

    def _stage_master(self, blob: Dict[str, Any]):
        """A validated checkpoint's params as new float32 tensors on the
        device (never the live slot's). Runs outside any lock."""
        from cxxnet_tpu_torch import convert
        return convert.params_from_numpy(
            blob["params"], self.trainer.net.param_shapes(), self.device)

    # -- canaried rollout --------------------------------------------------
    def _start_canary(self, slot: _Slot, path: str, epoch: int) -> bool:
        """Install a validated, staged candidate slot as the canary and
        start its judge."""
        from cxxnet_tpu_torch.nnet import checkpoint
        can = _Canary(slot, path, epoch, self.canary_frac)
        can.provenance = checkpoint.read_publish_meta(path) or {}
        with self._swap_lock:
            if self._canary is not None:
                return False
            self._canary = can
        if self._canary_thread is not None:
            self._canary_thread.join(timeout=15.0)
        self._canary_stop.clear()
        self._canary_thread = threading.Thread(
            target=self._canary_judge_loop, args=(can,),
            name="serve-canary-judge", daemon=True)
        self._canary_thread.start()
        telemetry.event(
            "swap", op="canary_started", path=path, epoch=epoch,
            frac=can.frac, window_s=self.canary_window,
            src=str(can.provenance.get("src", "")))
        return True

    def _canary_judge_loop(self, can: _Canary) -> None:
        """Judge thread: score the canary until the window closes, then
        promote or roll back. ANY judge failure rolls back."""
        try:
            with torch.inference_mode():
                fault.fault_point("canary_judge_error")
                deadline = can.t0 + self.canary_window
                while True:
                    wait_s = min(0.05,
                                 max(0.0, deadline - time.monotonic()))
                    if self._canary_stop.wait(wait_s):
                        self._canary_rollback(
                            can, "server stopping before verdict")
                        return
                    verdict = self._canary_check(can)
                    if verdict is not None:
                        self._canary_rollback(can, verdict)
                        return
                    if time.monotonic() >= deadline:
                        break
                verdict = self._canary_check(can, final=True)
            if verdict is not None:
                self._canary_rollback(can, verdict)
            else:
                self._canary_promote(can)
        except BaseException as e:  # noqa: BLE001 - fail safe to incumbent
            self._canary_rollback(
                can, f"judge error: {type(e).__name__}: {e}")

    def _canary_check(self, can: _Canary,
                      final: bool = False) -> Optional[str]:
        """One judge round: a rollback reason, or None while the canary
        looks healthy (shadow pairs, then error/deadline rates; on the
        final round with no organic evidence, a zeros batch must at
        least come out finite)."""
        with self._swap_lock:
            if self._canary is not can:
                return None
            graph = self._graph
            inc = self._slot
            sample = can.shadow.pop() if can.shadow else None
            shadow_done = can.shadow_done
            n_req = list(can.n_req)
            bad = [can.n_err[0] + can.n_exp[0],
                   can.n_err[1] + can.n_exp[1]]
        if sample is not None:
            reason = self._shadow_divergence(graph, inc, can.slot, sample)
            with self._swap_lock:
                can.shadow_done += 1
            if reason is not None:
                return reason
        elif final and shadow_done == 0:
            data = np.zeros((1,) + self._input_dims, np.float32)
            reason = self._shadow_divergence(graph, inc, can.slot, data,
                                             check_agree=False)
            if reason is not None:
                return reason
        if bad[1] > 0:
            rate = [bad[s] / max(n_req[s], 1) for s in (0, 1)]
            if rate[1] > rate[0]:
                return (f"candidate error/deadline rate "
                        f"{rate[1]:.4f} > incumbent {rate[0]:.4f} "
                        f"({bad[1]}/{n_req[1]} vs "
                        f"{bad[0]}/{n_req[0]})")
        return None

    def _shadow_divergence(self, graph, inc: _Slot, cand: _Slot, data,
                           check_agree: bool = True) -> Optional[str]:
        """The same rows through incumbent and candidate (padded to a
        covering bucket, on the judge's lane) and compared."""
        n = int(data.shape[0])
        bucket = next((b for b in self.buckets if b >= n),
                      self.buckets[-1])
        if n > bucket:
            data, n = data[:bucket], bucket
        if bucket > n:
            data = np.concatenate(
                [data, np.zeros((bucket - n,) + data.shape[1:],
                                data.dtype)], axis=0)
        lane = self._judge_lane
        out_inc = lane.run(graph, inc.cparams, data)[:n]
        out_cand = lane.run(graph, cand.cparams, data)[:n]
        if fault.fault_point("canary_divergence") == "corrupt":
            # sabotage: poison the candidate's answers (rollback drill)
            out_cand = out_cand + np.nan
        cand_bad = ~np.isfinite(out_cand)
        if bool(np.any(cand_bad & np.isfinite(out_inc))):
            return ("candidate produced non-finite outputs where "
                    "the incumbent was finite")
        agree = None
        if check_agree:
            agree = float(np.mean(predictions_from_rows(out_cand)
                                  == predictions_from_rows(out_inc)))
        telemetry.event(
            "swap", op="canary_shadow", rows=n,
            agree=(None if agree is None else round(agree, 4)),
            allclose=bool(np.allclose(out_cand, out_inc,
                                      rtol=1e-3, atol=1e-5)))
        if agree is not None and agree < 0.5:
            return (f"candidate argmax agreement {agree:.2f} < 0.5 "
                    f"on {n} shadow rows")
        return None

    def _canary_promote(self, can: _Canary) -> None:
        """The window closed clean: the candidate slot becomes the
        incumbent between batches."""
        with self._swap_lock:
            if self._canary is not can:
                return
            self._slot = can.slot
            self.trainer.state["params"] = can.slot.master
            self.trainer.epoch = can.epoch
            self._canary = None
        self.trainer._weights_changed()
        with self._lock:
            self._n_swaps += 1
            self._n_canary_promoted += 1
        telemetry.inc("serve.swaps")
        telemetry.inc("serve.canary_promoted")
        telemetry.event(
            "swap", op="promoted", path=can.path, epoch=can.epoch,
            canary_requests=can.n_req[1], shadow_pairs=can.shadow_done,
            window_s=self.canary_window,
            src=str(can.provenance.get("src", "")))

    def _canary_rollback(self, can: _Canary, reason: str) -> None:
        """Drop the candidate; the incumbent slot was never touched."""
        with self._swap_lock:
            if self._canary is not can:
                return
            self._canary = None
        with self._lock:
            self._n_canary_rolled_back += 1
        telemetry.inc("serve.canary_rolled_back")
        telemetry.stderr(
            f"serve: canary rolled back ({can.path}): {reason}\n",
            event_kind="swap", op="rolled_back", path=can.path,
            reason=reason, canary_requests=can.n_req[1],
            shadow_pairs=can.shadow_done,
            src=str(can.provenance.get("src", "")))

    # -- HTTP request path -------------------------------------------------
    def handle_predict(self, body: bytes):
        """The /predict POST backend: JSON {"data": rows, "deadline_ms":
        N, "raw": bool} in; {"predictions": [...], "rows": n, "trace":
        id, "latency_ms": t} (+ "outputs" with raw) out. data is
        (n,c,y,x) nested, flat (n, c*y*x), or one instance. Maps
        QueueFullError -> 429 + Retry-After, deadline expiry/timeout ->
        504, validation (and any "extras") -> 400, a stopping server ->
        503, dispatch failure -> 500. Returns (status, headers, body)."""
        def err(code: int, msg: str, **extra):
            payload = {"error": msg}
            payload.update(extra)
            return code, {}, json.dumps(payload).encode()

        t0 = time.monotonic()
        try:
            req = json.loads(body.decode("utf-8")) if body else {}
        except (ValueError, UnicodeDecodeError):
            return err(400, "request body must be a JSON object")
        if not isinstance(req, dict) or "data" not in req:
            return err(400, 'request JSON needs a "data" field '
                            '(rows to predict)')
        try:
            data = np.asarray(req["data"], dtype=np.float32)
        except (ValueError, TypeError):
            return err(400, '"data" must be a numeric array')
        c, y, x = self._input_dims
        width = c * y * x
        if data.ndim == 1 and data.size == width:
            data = data.reshape(1, c, y, x)
        elif data.ndim == 2 and data.shape[-1] == width:
            data = data.reshape(-1, c, y, x)
        deadline_ms = req.get("deadline_ms")
        try:
            extras = [np.asarray(e, dtype=np.float32)
                      for e in req.get("extras", ())]
            fut = self.submit(data, extras, deadline_ms=deadline_ms)
        except QueueFullError as e:
            # ceil seconds for the header, exact advice in the body
            secs = max(1, min(60, int(-(-e.retry_after_s // 1))))
            return (429, {"Retry-After": str(secs)},
                    json.dumps({
                        "error": "queue full (load shed)",
                        "retry_after_s": round(e.retry_after_s, 3),
                        "queue_depth": e.queue_depth}).encode())
        except (ValueError, TypeError) as e:
            return err(400, str(e))
        except RuntimeError as e:
            return err(503, str(e))
        eff_ms = (self.deadline_ms if deadline_ms is None
                  else float(deadline_ms))
        timeout = eff_ms / 1e3 + 5.0 if eff_ms > 0 else 300.0
        try:
            rows = fut.result(timeout=timeout)
        except DeadlineExpiredError as e:
            return err(504, str(e), trace=fut.trace)
        except TimeoutError:
            return err(504, "timed out waiting for the result",
                       trace=fut.trace)
        except BaseException as e:  # noqa: BLE001 - dispatch error -> 500
            return err(500, f"{type(e).__name__}: {e}", trace=fut.trace)
        rows = np.asarray(rows)
        out = {
            "predictions": [float(v)
                            for v in predictions_from_rows(rows)],
            "rows": int(rows.shape[0]),
            "trace": fut.trace,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
        }
        if req.get("raw"):
            out["outputs"] = rows.reshape(rows.shape[0], -1).tolist()
        return 200, {}, json.dumps(out).encode()

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Request/row/batch/padding counts, shed / deadline / swap /
        canary counts, per-bucket dispatch counts, the request-size
        histogram, and p50/p99 latency (ms): end to end, queue and
        device."""
        with self._lock:
            out: Dict[str, Any] = {
                "requests": self._n_requests,
                "rows": self._n_rows,
                "batches": self._n_batches,
                "padding_rows": self._n_padding,
                "errors": self._n_errors,
                "shed_requests": self._n_shed,
                "shed_rows": self._n_shed_rows,
                "deadline_expired": self._n_expired,
                "swaps": self._n_swaps,
                "swap_rejected": self._n_swap_rejected,
                "canary_requests": self._n_canary_req,
                "canary_promoted": self._n_canary_promoted,
                "canary_rolled_back": self._n_canary_rolled_back,
                "drain_rows_per_s": round(self._drain_rate, 2),
                "buckets": dict(self._bucket_hits),
                "request_sizes": dict(self._size_hist),
            }
        with self._swap_lock:
            out["canary_active"] = self._canary is not None
        if self.metrics_server is not None:
            out.update(self.metrics_server.ingress_stats())
        out["queue_limit"] = self.queue_limit
        out["warmup_s"] = round(self.warmup_s, 4)
        for hist, stem in ((self._lat, "latency"), (self._qlat, "queue"),
                           (self._dlat, "device")):
            for q in (50, 99):
                v = hist.percentile(q)
                out[f"{stem}_p{q}_ms"] = (round(v * 1e3, 3)
                                          if v == v else None)
        return out
