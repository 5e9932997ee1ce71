"""Continuous-batching inference server (counterpart of
cxxnet_tpu/serve/server.py, its core without the production front).

- a **shared request queue**: `submit()` is thread-safe and returns a
  future; requests larger than the biggest bucket split internally and
  re-join on `result()`;
- **continuous/dynamic batching into padded buckets**: dispatchers
  coalesce queued requests up to `max_batch` rows and run the smallest
  bucket (powers of two up to `max_batch`, plus `max_batch`) that covers
  them, padding the tail with zero rows that never reach a caller;
- **warmup**: `warmup()` runs every bucket once at startup, so cuDNN's
  per-shape setup and the kernels' first-use build happen before
  traffic;
- **replicas**: `replicas` dispatcher threads drain the shared queue.
  Each enters `torch.inference_mode()` (it is thread-local) and
  launches on the default stream: correct, not concurrent - streams and
  CUDA graphs are later work. The `.cpu()` readback of a batch is its
  synchronisation point;
- **fill-or-timeout admission**: a dispatcher waits up to
  `max_wait_ms` past the first item's submit for the bucket to fill,
  then ships what it has, so p99 latency stays bounded under low load;
- `stop()` (drain first, or fail the queue) and `drain()`; `stats()`
  with request/row/batch/padding counts and p50/p99 latency;
- **graph passes**: the Server serves `trainer.infer_graph(node)` as it
  stands when the Server is built - a calibrated trainer's transformed
  graph (folded, int8-quantized) of that calibration epoch, which the
  Server keeps even if the trainer recalibrates later. A trainer whose
  fold_conv_bn / quantize_int8 sites have no statistics yet gets a
  warning and the float graph: warmup rows of zeros must never become
  the calibration batch. `task = serve` calibrates on the first pred
  batch before it builds the Server.

The HTTP front, load shedding, deadlines, hot-swap, canary and the
flight recorder are later slices.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """The padded-batch bucket set: powers of two up to `max_batch`,
    plus `max_batch` itself."""
    if max_batch < 1:
        raise ValueError("serve_max_batch must be >= 1")
    out = {max_batch}
    b = 1
    while b <= max_batch:
        out.add(b)
        b *= 2
    return tuple(sorted(out))


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


class Histogram:
    """Latency samples over a bounded window; thread-safe percentiles."""

    def __init__(self, window: int = 100000) -> None:
        self._lock = threading.Lock()
        self._vals: collections.deque = collections.deque(maxlen=window)

    def observe(self, v: float) -> None:
        with self._lock:
            self._vals.append(v)

    def percentile(self, q: float) -> float:
        with self._lock:
            vals = list(self._vals)
        return float(np.percentile(vals, q)) if vals else float("nan")


class _Future:
    """Minimal one-shot result future."""

    __slots__ = ("_ev", "_value", "_error")

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

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


class _WorkItem:
    __slots__ = ("data", "n", "t_submit", "future")

    def __init__(self, data: np.ndarray, t_submit: float) -> None:
        self.data = data
        self.n = data.shape[0]
        self.t_submit = t_submit
        self.future = _Future()


class Server:
    """Continuous-batching server over a trainer's inference forward.
    The trainer must hold a model (init_model or load_model) and live on
    `device` - `cuda:0` unless the caller asks for the CPU; with no card
    the default raises.

    start() spawns the dispatcher replicas (warmup() first, so the first
    requests do not pay the setup); submit() from any thread; stop()
    drains the queue, joins the replicas and returns stats(). Usable as
    a context manager."""

    def __init__(self, trainer, max_batch: int = 0,
                 max_wait_ms: Optional[float] = None,
                 replicas: Optional[int] = None, node: int = -1,
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
        self.max_batch = int(max_batch or trainer.serve_max_batch
                             or trainer.batch_size)
        self.max_wait_ms = float(trainer.serve_max_wait_ms
                                 if max_wait_ms is None else max_wait_ms)
        self.replicas = int(trainer.serve_replicas if replicas is None
                            else replicas)
        if self.replicas < 1:
            raise ValueError("serve_replicas must be >= 1")
        self.node = node if node >= 0 else trainer.net_cfg.num_nodes - 1
        self.buckets = bucket_sizes(self.max_batch)
        if trainer.passes_need_calibration():
            sys.stderr.write(
                "serve: graph passes (fold_conv_bn/quantize_int8) have "
                "no calibration stats; serving the unoptimized float "
                "graph (calibrate before Server creation to "
                "fold/quantize)\n")
        self._graph = trainer.infer_graph(self.node)
        self._input_dims = tuple(trainer.net_cfg.input_shape)
        self._cond = threading.Condition()
        # admission state: the queue and the drain flag, under the
        # condition
        self._queue: collections.deque = collections.deque()
        self._draining = False
        self._threads: List[threading.Thread] = []
        self._started = False
        self.warmup_s = 0.0
        # product-surface accounting, under _lock
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_rows = 0
        self._n_batches = 0
        self._n_padding = 0
        self._n_errors = 0
        self._bucket_hits: Dict[int, int] = {b: 0 for b in self.buckets}
        self._size_hist: Dict[int, int] = {}
        # end-to-end latency, and its split at dispatch: queue = submit
        # -> dispatch (incl. the fill-or-timeout wait), device =
        # dispatch -> rows read back
        self._lat = Histogram()
        self._qlat = Histogram()
        self._dlat = Histogram()

    # -- lifecycle ---------------------------------------------------------
    def warmup(self) -> float:
        """Run every bucket once on zero rows, so steady-state serving
        pays no first-use setup. Returns the wall seconds spent."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            for b in self.buckets:
                data = np.zeros((b,) + self._input_dims, np.float32)
                self._graph(self.trainer.stage_infer_rows(data)).cpu()
        self.warmup_s = time.perf_counter() - t0
        return self.warmup_s

    def start(self) -> "Server":
        if self._started:
            return self
        with self._cond:
            self._draining = False
        self._started = True
        for i in range(self.replicas):
            t = threading.Thread(target=self._replica_loop,
                                 name=f"serve-replica-{i}", daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def stop(self, drain: bool = True) -> Dict[str, Any]:
        """Stop the replicas - after draining the queue (default), or
        immediately failing queued requests (drain=False) - and return
        stats(). Idempotent."""
        with self._cond:
            self._draining = True
            if not drain:
                while self._queue:
                    it = self._queue.popleft()
                    it.future._set_error(
                        RuntimeError("server stopped before dispatch"))
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=60.0)
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not stop within 60 s")
        self._threads = []
        self._started = False
        return self.stats()

    def drain(self) -> Dict[str, Any]:
        """Graceful shutdown: stop admitting (new submits raise), resolve
        everything already queued, then stop. Returns the final
        stats()."""
        return self.stop(drain=True)

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- submission --------------------------------------------------------
    def submit(self, data: np.ndarray):
        """Enqueue one request: (n, c, y, x) rows or a single (c, y, x)
        instance. Returns a future whose result() is the raw final-node
        rows, (n, width) float32 - predictions_from_rows turns them into
        predict()-style labels. Thread-safe; requests wider than the
        largest bucket split transparently."""
        if not self._started:
            raise RuntimeError("Server not started (call start())")
        data = np.ascontiguousarray(data, dtype=np.float32)
        if data.ndim == 3:
            data = data[None]
        if data.ndim != 4 or data.shape[1:] != self._input_dims:
            c, y, x = self._input_dims
            raise ValueError(
                f"serve request must be (n, {c}, {y}, {x}) or a single "
                f"instance; got {data.shape}")
        if data.shape[0] < 1:
            raise ValueError("serve request needs at least one row")
        t_submit = time.monotonic()
        items = [_WorkItem(data[lo:lo + self.max_batch], t_submit)
                 for lo in range(0, data.shape[0], self.max_batch)]
        with self._cond:
            if self._draining:
                raise RuntimeError("server is stopping")
            self._queue.extend(items)
            self._cond.notify_all()
        with self._lock:
            self._n_requests += 1
            self._n_rows += data.shape[0]
            for it in items:
                self._size_hist[it.n] = self._size_hist.get(it.n, 0) + 1
        if len(items) == 1:
            return items[0].future
        return _JoinedFuture([it.future for it in items])

    # -- dispatchers -------------------------------------------------------
    def _collect(self) -> Optional[List[_WorkItem]]:
        """Admission policy: block for work, then coalesce queued items
        up to max_batch rows, waiting at most max_wait_ms past the
        FIRST item's submit time for the batch to fill. Returns None
        when stopping and drained."""
        with self._cond:
            while not self._queue:
                if self._draining:
                    return None
                self._cond.wait(0.05)
            first = self._queue.popleft()
            items = [first]
            total = first.n
            deadline = first.t_submit + self.max_wait_ms / 1e3
            while total < self.max_batch:
                if self._queue:
                    if self._queue[0].n > self.max_batch - total:
                        break  # head doesn't fit: ship what we have
                    it = self._queue.popleft()
                    items.append(it)
                    total += it.n
                    continue
                wait = deadline - time.monotonic()
                if wait <= 0 or self._draining:
                    break
                self._cond.wait(min(wait, 0.05))
            return items

    def _run_batch(self, items: List[_WorkItem]) -> None:
        total = sum(it.n for it in items)
        bucket = next(b for b in self.buckets if b >= total)
        data = np.concatenate([it.data for it in items], axis=0)
        if bucket > total:
            data = np.concatenate(
                [data, np.zeros((bucket - total,) + data.shape[1:],
                                data.dtype)], axis=0)
        t_dispatch = time.monotonic()
        out = self._graph(self.trainer.stage_infer_rows(data))
        rows = out.cpu().numpy().reshape(bucket, -1)  # the sync point
        t_done = time.monotonic()
        off = 0
        for it in items:
            it.future._set(rows[off:off + it.n])
            off += it.n
            self._lat.observe(t_done - it.t_submit)
            self._qlat.observe(max(t_dispatch - it.t_submit, 0.0))
            self._dlat.observe(t_done - t_dispatch)
        with self._lock:
            self._n_batches += 1
            self._n_padding += bucket - total
            self._bucket_hits[bucket] += 1

    def _replica_loop(self) -> None:
        with torch.inference_mode():
            while True:
                items = self._collect()
                if items is None:
                    return
                try:
                    self._run_batch(items)
                except Exception as e:  # delivered through the futures
                    with self._lock:
                        self._n_errors += 1
                    sys.stderr.write(f"serve: dispatch failed: "
                                     f"{type(e).__name__}: {e}\n")
                    for it in items:
                        if not it.future.done():
                            it.future._set_error(e)

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Request/row/batch/padding counts, per-bucket dispatch counts,
        the request-size histogram, and p50/p99 latency (ms): end to
        end, queue and device."""
        with self._lock:
            out: Dict[str, Any] = {
                "requests": self._n_requests,
                "rows": self._n_rows,
                "batches": self._n_batches,
                "padding_rows": self._n_padding,
                "errors": self._n_errors,
                "buckets": dict(self._bucket_hits),
                "request_sizes": dict(self._size_hist),
            }
        out["warmup_s"] = round(self.warmup_s, 4)
        for hist, stem in ((self._lat, "latency"), (self._qlat, "queue"),
                           (self._dlat, "device")):
            for q in (50, 99):
                v = hist.percentile(q)
                out[f"{stem}_p{q}_ms"] = (round(v * 1e3, 3)
                                          if v == v else None)
        return out
