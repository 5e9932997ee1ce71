"""Concurrency tier 2 for the port: runtime lock-order / contention audit
(own copy of cxxnet_tpu/analysis/lock_audit.py).

The GL01x lint rules (astlint.py) check lock DISCIPLINE in the source;
this module audits lock BEHAVIOR in the running process. A shim wraps
``threading.Lock``/``threading.RLock`` *construction* (which also
covers ``Condition``, ``Event`` and every ``queue.Queue``, since the
stdlib builds them from the module-level factories at call time), so
every lock created while the auditor is installed records:

- the **per-thread acquisition sequence**: acquiring B while holding
  A adds the edge A -> B to the cross-thread lock-order graph. Nodes
  are lock INSTANCES (labeled ``site:line#n``), while contention stats
  aggregate per construction site. A CYCLE in that graph is an
  inconsistent acquisition order - two threads interleaving it
  deadlock - and fails the audit;
- **contention**: wall time spent waiting in ``acquire`` and the
  held-duration of every hold (``Condition.wait`` releases the lock
  via ``_release_save``, so a consumer parked on an empty queue does
  NOT count as holding its mutex);
- **dispatch-boundary hygiene**: the points where the host waits on the
  card or reads from it - ``torch.cuda.synchronize``,
  ``torch.cuda.Stream.synchronize``, ``torch.cuda.Event.synchronize``
  and ``Tensor.item`` / ``.cpu`` / ``.tolist`` / ``.numpy`` (graph_audit's
  ``HostReads``) - are wrapped while the shim is installed, and every
  wrapper is restored on uninstall; one reached with ANY audited lock
  held is flagged: a lock held across a card sync serializes every
  other thread behind the card (the runtime twin of GL002/GL015).

The audited paths are the real exercised ones:

- ``serve-storm``: a live continuous-batching ``Server`` (2 replicas,
  warmed buckets, HTTP ingress + queue-limit admission + checkpoint
  watcher armed) under a ragged request storm from 3 submitter threads
  with a mid-storm /predict POST, the accept gate saturated
  (``serve_max_conns``), a published checkpoint picked up by the swap
  watcher and promoted by the canary judge;
- ``prefetch-round``: a ``StagedPrefetcher`` pass (chunk = 4, plus a
  mid-stream close) - the io producer/consumer queue discipline;
- ``watchdog-stall``: a fresh telemetry instance with heartbeat + hang
  watchdog through a beacon-silence episode (stall dump, recovery);
- ``native-decode`` (the port's own): a short pass of the image
  decoder's reader over an imgbin file - ``NativeBinReader`` (nvJPEG)
  on the card, ``PlainBinReader`` (its plain version, a decode pool) on
  the CPU - the code the JAX package threads in native/cxxnet_io.cc.

- ``elastic-coordinator``: two members' lease-heartbeat threads plus
  concurrent barrier() calls from their training threads
  (parallel/coordinator.py): barriers, one leader, a publish, a
  conviction.

``--seed-inversion`` (CLI) injects a deliberate two-lock ABBA fixture -
the gate's self-test: the audit MUST fail on it, proving the cycle
detector is alive.

``python -m cxxnet_tpu_torch.analysis --lock-audit`` runs everything and
exits non-zero on a cycle, a dispatch-boundary violation, a scenario
failure, or an empty audit (zero locks observed = the shim did not
engage; the gate refuses to pass vacuously). Scenarios run on the card
unless the CPU is asked for (``device``).
"""

from __future__ import annotations

import os
import shutil
import sys
import sysconfig
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# acquire waits above this count as contended (below is scheduler
# noise on an uncontended fast path)
CONTENDED_WAIT_S = 1e-4
_STDLIB_DIR = sysconfig.get_paths()["stdlib"]


def _thread_name() -> str:
    """Current thread's name WITHOUT threading.current_thread():
    during thread bootstrap (before the thread registers) that call
    constructs a _DummyThread whose Event.set() would re-enter the
    audited lock path - unbounded recursion. A raw peek at the
    registry is allocation-free and safe from any bootstrap stage."""
    ident = threading.get_ident()
    t = getattr(threading, "_active", {}).get(ident)
    return t.name if t is not None else f"thread-{ident}"


def _check(target: str, check: str, ok: bool,
           detail: str = "") -> Dict[str, Any]:
    return {"target": target, "check": check, "ok": bool(ok),
            "detail": detail}


# ---------------------------------------------------------------------------
# the shim
# ---------------------------------------------------------------------------
class _Site:
    """Aggregate stats for one lock construction site (one 'lock
    class': every Queue mutex born on queue.py's behalf is keyed by
    the USER frame that built the Queue)."""

    __slots__ = ("key", "kind", "instances", "acquisitions",
                 "contended", "wait_total", "wait_max", "held_total",
                 "held_max")

    def __init__(self, key: str, kind: str) -> None:
        self.key = key
        self.kind = kind
        self.instances = 0
        self.acquisitions = 0
        self.contended = 0
        self.wait_total = 0.0
        self.wait_max = 0.0
        self.held_total = 0.0
        self.held_max = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "site": self.key, "kind": self.kind,
            "instances": self.instances,
            "acquisitions": self.acquisitions,
            "contended": self.contended,
            "wait_total_ms": round(self.wait_total * 1e3, 3),
            "wait_max_ms": round(self.wait_max * 1e3, 3),
            "held_total_ms": round(self.held_total * 1e3, 3),
            "held_max_ms": round(self.held_max * 1e3, 3),
        }


class _AuditedLockBase:
    """Wrapper recording acquire/release through the auditor. The
    plain-Lock variant deliberately does NOT define
    ``_release_save``/``_acquire_restore``/``_is_owned`` -
    ``threading.Condition`` probes for them with ``hasattr`` and must
    fall back to its Lock-protocol defaults (which route through
    ``acquire``/``release`` here)."""

    __slots__ = ("_inner", "_site", "_uid", "_aud")

    def __init__(self, inner, site: _Site, seq: int,
                 aud: "LockAuditor") -> None:
        self._inner = inner
        self._site = site
        # instance node id in the order graph; `seq` was allotted
        # under the auditor's meta lock (reading site.instances here
        # would race concurrent constructions at the same site and
        # alias two locks onto one node - a false cycle)
        self._uid = f"{site.key}#{seq}"
        self._aud = aud

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._aud._on_acquired(self, time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._aud._on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<audited {self._site.kind} {self._site.key}>"


class AuditedLock(_AuditedLockBase):
    __slots__ = ()


class AuditedRLock(_AuditedLockBase):
    """RLock wrapper: reentrant acquires are counted so only the
    outermost acquire/release record (a nested with on the same RLock
    is not a new hold, and never an order edge). The Condition
    protocol trio wraps our bookkeeping state around the inner
    lock's, so a ``cond.wait()`` fully releases the hold in the audit
    exactly as it does in the runtime."""

    __slots__ = ()

    def _release_save(self):
        saved = self._aud._on_release_save(self)
        return (saved, self._inner._release_save())

    def _acquire_restore(self, state) -> None:
        saved, inner_state = state
        t0 = time.perf_counter()
        self._inner._acquire_restore(inner_state)
        self._aud._on_acquire_restore(self, saved,
                                      time.perf_counter() - t0)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


class _HeldEntry:
    __slots__ = ("lock", "t0", "count")

    def __init__(self, lock: _AuditedLockBase, t0: float) -> None:
        self.lock = lock
        self.t0 = t0
        self.count = 1


class LockAuditor:
    """Installable construction shim + the recorded graph/stats.

    Usage::

        aud = LockAuditor()
        with aud.installed():
            ... exercise real code paths ...
        report = aud.report()

    Bookkeeping runs under a REAL lock captured before installation,
    and the per-thread held stack lives in a ``threading.local`` - the
    auditor never acquires an audited lock itself, so it cannot
    deadlock with (or add edges to) the code under audit."""

    def __init__(self) -> None:
        self._meta = threading.Lock()   # real: created pre-install
        self._local = threading.local()
        self._sites: Dict[str, _Site] = {}
        # (from_site, to_site) -> {"count": n, "threads": set}
        self._edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._boundaries: List[Dict[str, Any]] = []
        self._boundary_seen: set = set()
        self._installed = False
        self._saved: Dict[str, Any] = {}
        self._reads = None

    # -- construction site attribution --------------------------------------
    def _site_for(self, kind: str) -> Tuple[_Site, int]:
        # frame 2 is the caller of threading.Lock()/RLock() (the
        # factory wrapper frames are below); walk out of stdlib
        # internals (queue.py, threading.Condition, ...) to the frame
        # that actually OWNS the lock
        f = sys._getframe(2)
        chosen = None
        hops = 0
        while f is not None and hops < 16:
            path = f.f_code.co_filename
            if chosen is None:
                chosen = f  # innermost as the fallback
            if not path.startswith(_STDLIB_DIR):
                chosen = f
                break
            f = f.f_back
            hops += 1
        path = chosen.f_code.co_filename if chosen else "?"
        for marker in ("/cxxnet_tpu_torch/", "/tests/"):
            i = path.find(marker)
            if i >= 0:
                path = path[i + 1:]
                break
        else:
            path = os.path.basename(path)
        key = f"{path}:{chosen.f_lineno if chosen else 0}"
        with self._meta:
            site = self._sites.get(key)
            if site is None:
                site = self._sites[key] = _Site(key, kind)
            site.instances += 1
            return site, site.instances

    # -- factories (what threading.Lock/RLock become) ------------------------
    def _make_lock(self):
        real = self._saved["Lock"]
        site, seq = self._site_for("Lock")
        return AuditedLock(real(), site, seq, self)

    def _make_rlock(self):
        real = self._saved["RLock"]
        site, seq = self._site_for("RLock")
        return AuditedRLock(real(), site, seq, self)

    # -- install / uninstall -------------------------------------------------
    def install(self) -> "LockAuditor":
        if self._installed:
            return self
        self._saved["Lock"] = threading.Lock
        self._saved["RLock"] = threading.RLock
        threading.Lock = self._make_lock  # type: ignore[assignment]
        threading.RLock = self._make_rlock  # type: ignore[assignment]
        from cxxnet_tpu_torch.analysis.graph_audit import HostReads
        self._reads = HostReads(on_read=self.boundary).__enter__()
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = self._saved["Lock"]
        threading.RLock = self._saved["RLock"]
        self._reads.__exit__(None, None, None)
        self._reads = None
        self._installed = False

    class _Installed:
        def __init__(self, aud: "LockAuditor") -> None:
            self.aud = aud

        def __enter__(self) -> "LockAuditor":
            return self.aud.install()

        def __exit__(self, *exc) -> bool:
            self.aud.uninstall()
            return False

    def installed(self) -> "_Installed":
        return LockAuditor._Installed(self)

    # -- event recording ------------------------------------------------------
    def _stack(self) -> List[_HeldEntry]:
        stack = getattr(self._local, "held", None)
        if stack is None:
            stack = self._local.held = []
        return stack

    def _on_acquired(self, lock: _AuditedLockBase,
                     waited: float) -> None:
        stack = self._stack()
        for ent in stack:
            if ent.lock is lock:
                ent.count += 1  # reentrant RLock: not a new hold
                return
        now = time.perf_counter()
        tname = _thread_name()
        with self._meta:
            site = lock._site
            site.acquisitions += 1
            site.wait_total += waited
            if waited > site.wait_max:
                site.wait_max = waited
            if waited > CONTENDED_WAIT_S:
                site.contended += 1
            for ent in stack:
                a, b = ent.lock._uid, lock._uid
                edge = self._edges.get((a, b))
                if edge is None:
                    edge = self._edges[(a, b)] = {
                        "count": 0, "threads": set()}
                edge["count"] += 1
                edge["threads"].add(tname)
        stack.append(_HeldEntry(lock, now))

    def _on_release(self, lock: _AuditedLockBase) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            ent = stack[i]
            if ent.lock is lock:
                ent.count -= 1
                if ent.count > 0:
                    return
                del stack[i]
                held = time.perf_counter() - ent.t0
                with self._meta:
                    site = lock._site
                    site.held_total += held
                    if held > site.held_max:
                        site.held_max = held
                return
        # released a lock acquired before installation: not audited

    def _on_release_save(self, lock: _AuditedLockBase) -> int:
        """Condition.wait path: the FULL reentrant hold drops."""
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            ent = stack[i]
            if ent.lock is lock:
                saved = ent.count
                ent.count = 1
                del stack[i]
                held = time.perf_counter() - ent.t0
                with self._meta:
                    site = lock._site
                    site.held_total += held
                    if held > site.held_max:
                        site.held_max = held
                return saved
        return 1

    def _on_acquire_restore(self, lock: _AuditedLockBase, saved: int,
                            waited: float) -> None:
        self._on_acquired(lock, waited)
        stack = self._stack()
        for ent in stack:
            if ent.lock is lock:
                ent.count = max(saved, 1)
                return

    def boundary(self, name: str) -> None:
        """Mark a host-sync boundary (a card sync or a tensor read) on
        this thread; any audited lock held here is a violation."""
        stack = self._stack()
        if not stack:
            return
        sites = tuple(sorted(ent.lock._uid for ent in stack))
        key = (name, sites)
        with self._meta:
            if key in self._boundary_seen:
                return
            self._boundary_seen.add(key)
            self._boundaries.append({
                "boundary": name,
                "thread": _thread_name(),
                "locks": list(sites),
            })

    # -- analysis -------------------------------------------------------------
    def find_cycle(self) -> Optional[List[str]]:
        """First cycle in the instance-level lock-order graph (None =
        acyclic). Iterative coloring DFS; the returned path is the
        cycle's node sequence, closed (first == last)."""
        with self._meta:
            graph: Dict[str, List[str]] = {}
            for (a, b) in self._edges:
                graph.setdefault(a, []).append(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        for root in sorted(graph):
            if color.get(root, WHITE) != WHITE:
                continue
            stack: List[Tuple[str, int]] = [(root, 0)]
            path = [root]
            color[root] = GRAY
            while stack:
                node, idx = stack[-1]
                succs = graph.get(node, ())
                if idx < len(succs):
                    stack[-1] = (node, idx + 1)
                    nxt = succs[idx]
                    c = color.get(nxt, WHITE)
                    if c == GRAY:
                        return path[path.index(nxt):] + [nxt]
                    if c == WHITE:
                        color[nxt] = GRAY
                        stack.append((nxt, 0))
                        path.append(nxt)
                else:
                    color[node] = BLACK
                    stack.pop()
                    path.pop()
        return None

    def report(self, top: int = 5) -> Dict[str, Any]:
        with self._meta:
            sites = sorted(self._sites.values(),
                           key=lambda s: -s.wait_total)
            edges = [{"from": a, "to": b, "count": e["count"],
                      "threads": sorted(e["threads"])}
                     for (a, b), e in sorted(self._edges.items())]
            boundaries = list(self._boundaries)
        cycle = self.find_cycle()
        acquired = [s for s in sites if s.acquisitions]
        return {
            "sites": len(self._sites),
            "instances": sum(s.instances for s in sites),
            "acquisitions": sum(s.acquisitions for s in sites),
            "edges": edges,
            "cycle": cycle,
            "contended": [s.to_dict() for s in acquired[:top]],
            "max_held_ms": round(
                max((s.held_max for s in sites), default=0.0) * 1e3, 3),
            "max_wait_ms": round(
                max((s.wait_max for s in sites), default=0.0) * 1e3, 3),
            "boundary_violations": boundaries,
        }


# ---------------------------------------------------------------------------
# scenarios (the real exercised paths)
# ---------------------------------------------------------------------------
def _scenario_prefetch_round(aud: LockAuditor,
                             device: str) -> List[Dict[str, Any]]:
    """StagedPrefetcher pass: chunked staging (12 chunks of 4, each
    batch copied to the device), a full drain, then a second pass
    abandoned mid-stream (close() - the drain-while-join shutdown
    discipline)."""
    import numpy as np
    import torch

    from cxxnet_tpu_torch.io.prefetch import StagedPrefetcher

    class _Src:
        def __init__(self, n: int) -> None:
            self.n = n
            self.i = 0

        def before_first(self) -> None:
            self.i = 0

        def next(self) -> bool:
            self.i += 1
            return self.i <= self.n

        def value(self):
            return np.full((8,), float(self.i), np.float32)

    def stage(batch, ring):
        time.sleep(0.0005)  # a visible stage cost, so the queue works
        return torch.from_numpy(batch * 2.0).to(device)

    pf = StagedPrefetcher(stage, _Src(48), depth=2, device=device,
                          chunk=4, chunk_fn=lambda xs, ring: list(xs))
    batches = 0
    pf.before_first()
    while pf.next():
        batches += len(pf.value())
    pf.before_first()
    for _ in range(3):
        pf.next()
    pf.close()
    return [_check("prefetch-round", "all-batches-delivered",
                   batches == 48, f"{batches}/48 batches")]


def _scenario_watchdog_stall(aud: LockAuditor) -> List[Dict[str, Any]]:
    """A fresh telemetry plane (heartbeat sink + hang watchdog)
    through a beacon-silence episode: beacons tick, go silent until
    the watchdog dumps and flips unhealthy, then recover."""
    import tempfile

    from cxxnet_tpu_torch import telemetry as tmod
    from cxxnet_tpu_torch.telemetry.watchdog import Watchdog

    checks: List[Dict[str, Any]] = []
    with tempfile.TemporaryDirectory() as td:
        tel = tmod.Telemetry()
        tel.configure(log_file=os.path.join(td, "events.jsonl"),
                      metrics_file=os.path.join(td, "metrics.jsonl"),
                      heartbeat_secs=0.05)
        wd = Watchdog(tel, stall_secs=0.25, poll_secs=0.05,
                      startup_secs=0.25)
        wd.start()
        try:
            for _ in range(4):
                tel.beacon("train.step")
                tel.observe("train.step_s", 0.01)
                with tel.span("round"):
                    time.sleep(0.04)
            # wait for BOTH the stall flag and the health flip: the
            # flag is set before _dump finishes writing the stacks,
            # so polling the flag alone races the health source
            deadline = time.monotonic() + 5.0
            while (not (wd.stalled and not tel.health.ok)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            stalled_seen = wd.stalled
            unhealthy = not tel.health.ok
            tel.beacon("train.step")
            deadline = time.monotonic() + 5.0
            while wd.stalled and time.monotonic() < deadline:
                time.sleep(0.02)
            recovered = not wd.stalled and tel.health.ok
        finally:
            wd.close()
            tel.close()
        checks.append(_check("watchdog-stall", "stall-dumped",
                             stalled_seen, "watchdog fired"))
        checks.append(_check("watchdog-stall", "health-flipped",
                             unhealthy, "/healthz source set"))
        checks.append(_check("watchdog-stall", "recovered",
                             recovered, "beacon cleared the stall"))
    return checks


_STORM_SIZES = (1, 2, 3, 5, 8, 13, 4, 1, 6, 2, 7, 1)


def _scenario_serve_storm(aud: LockAuditor, trainer,
                          device: str) -> List[Dict[str, Any]]:
    """A live continuous-batching Server under a ragged request storm
    from 3 submitter threads (splits, coalescing, padding, replica
    fan-out all exercised); every future must resolve. The production
    front rides along: the HTTP ingress thread answers a /predict
    POST mid-storm, the admission check runs with a (non-binding)
    queue_limit armed, the connection accept gate is saturated and
    released (serve_max_conns armed - the gate's own lock joins the
    graph), and the checkpoint watcher thread picks up a published
    checkpoint which the canary judge thread scores and promotes
    live - so the ingress/shed/swap/canary lock interactions all land
    in the audited graph."""
    import json as _json
    import socket as _socket
    import tempfile
    import urllib.request

    import numpy as np

    from cxxnet_tpu_torch.nnet import checkpoint as _ckpt
    from cxxnet_tpu_torch.serve.server import Server

    tmpd = tempfile.mkdtemp(prefix="lock_audit_serve_")
    saved = os.path.join(tmpd, "0001.model")
    with open(saved, "wb") as f:
        trainer.save_model(f)
    watch = os.path.join(tmpd, "publish.model")
    srv = Server(trainer, max_batch=8, max_wait_ms=2.0, replicas=2,
                 http_port=0, queue_limit=100000,
                 swap_watch=watch, swap_poll_ms=20.0,
                 canary_frac=0.5, canary_window=0.8, max_conns=2,
                 device=device)
    srv.shed_clear_ms = 100.0
    rows_sent = 0
    errors: List[str] = []
    results: List[int] = []
    http_status = 0
    gate_rejected = False
    res_lock = threading.Lock()
    srv.warmup()
    with srv:
        def submitter(seed: int) -> None:
            rng = np.random.RandomState(seed)
            futs = []
            for n in _STORM_SIZES:
                data = rng.rand(n, 1, 1, 36).astype(np.float32)
                futs.append((n, srv.submit(data)))
            for n, fut in futs:
                try:
                    out = fut.result(timeout=60.0)
                    with res_lock:
                        results.append(out.shape[0])
                        if out.shape[0] != n:
                            errors.append(
                                f"rows {out.shape[0]} != {n}")
                except Exception as e:  # noqa: BLE001 - reported below
                    with res_lock:
                        errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=submitter, args=(s,),
                                    name=f"storm-{s}", daemon=True)
                   for s in (11, 22, 33)]
        for t in threads:
            t.start()
        # mid-storm: saturate the accept gate (max_conns=2) with two
        # held raw connections - a third must get the gate's raw 503 -
        # then release; the gate lock's enter/leave/recover traffic
        # joins the audited graph under real load
        port = srv.metrics_server.port
        held = []
        try:
            for _ in range(2):
                h = _socket.create_connection(
                    ("127.0.0.1", port), timeout=10)
                h.sendall(b"GET /healthz HTTP/1.0\r\nX-Hold")
                held.append(h)
            time.sleep(0.2)
            probe = _socket.create_connection(
                ("127.0.0.1", port), timeout=10)
            probe.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            probe.settimeout(10.0)
            buf = b""
            try:
                while True:
                    chunk = probe.recv(4096)
                    if not chunk:
                        break
                    buf += chunk
            except OSError:
                pass
            probe.close()
            gate_rejected = b"503" in buf.split(b"\r\n")[0]
        except Exception as e:  # noqa: BLE001 - reported below
            with res_lock:
                errors.append(f"gate: {type(e).__name__}: {e}")
        finally:
            for h in held:
                h.close()
        # one /predict POST through the ingress thread (retried: the
        # just-released gate slots may take a beat to free) and one
        # checkpoint published to the watched path (same weights -
        # the full validate/stage/canary/promote path is what the
        # audit wants)
        body = _json.dumps({"data": [[0.1] * 36]}).encode()
        for attempt in range(5):
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict",
                    data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    http_status = r.status
                break
            except Exception as e:  # noqa: BLE001 - reported below
                if attempt == 4:
                    with res_lock:
                        errors.append(
                            f"http: {type(e).__name__}: {e}")
                time.sleep(0.3)
        _ckpt.publish_model(saved, watch)
        for t in threads:
            t.join(timeout=120.0)
        # a trickle keeps canary traffic + shadow samples flowing
        # until the judge reaches its verdict at the window
        rng = np.random.RandomState(44)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if srv.stats()["canary_promoted"] >= 1:
                break
            data = rng.rand(4, 1, 1, 36).astype(np.float32)
            try:
                srv.submit(data).result(timeout=60.0)
            except Exception as e:  # noqa: BLE001 - reported below
                with res_lock:
                    errors.append(
                        f"trickle: {type(e).__name__}: {e}")
                break
            time.sleep(0.02)
        alive = [t.name for t in threads if t.is_alive()]
        rows_sent = 3 * sum(_STORM_SIZES)
        # ingress counters live on the HTTP plane: snapshot them
        # before stop() closes it
        conn_rejected = srv.stats().get("conn_rejected", 0)
    stats = srv.stats()
    checks = [
        _check("serve-storm", "all-submitters-done", not alive,
               f"stuck: {alive}" if alive else "3 threads joined"),
        _check("serve-storm", "all-rows-answered",
               not errors and sum(results) == rows_sent,
               errors[0] if errors
               else f"{sum(results)}/{rows_sent} rows"),
        _check("serve-storm", "dispatches-ran",
               stats["batches"] > 0 and stats["errors"] == 0,
               f"{stats['batches']} batches, "
               f"{stats['errors']} errors"),
        _check("serve-storm", "http-ingress-answered",
               http_status == 200, f"status {http_status}"),
        _check("serve-storm", "checkpoint-hot-swapped",
               stats["swaps"] == 1 and stats["swap_rejected"] == 0,
               f"{stats['swaps']} swaps, "
               f"{stats['swap_rejected']} rejected"),
        _check("serve-storm", "canary-judge-promoted",
               stats["canary_promoted"] == 1
               and stats["canary_rolled_back"] == 0,
               f"{stats['canary_promoted']} promoted, "
               f"{stats['canary_rolled_back']} rolled back"),
        _check("serve-storm", "conn-gate-exercised",
               gate_rejected and conn_rejected >= 1,
               f"raw 503 seen: {gate_rejected}, "
               f"{conn_rejected} rejected"),
    ]
    return checks


def _write_imgbin(d: str, n: int = 48, size: int = 64) -> str:
    """n size x size RGB images (JPEG where Pillow imports, else P6),
    packed by the port's im2bin into d/set.bin; returns its path."""
    import io as _io
    import numpy as np

    from cxxnet_tpu_torch.tools.im2bin import im2bin
    rng = np.random.RandomState(5)
    root = os.path.join(d, "img")
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
        try:
            from PIL import Image
            buf = _io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            blob, name = buf.getvalue(), f"{i:04d}.jpg"
        except ImportError:
            blob = f"P6\n{size} {size}\n255\n".encode() + img.tobytes()
            name = f"{i:04d}.ppm"
        with open(os.path.join(root, name), "wb") as f:
            f.write(blob)
        lines.append(f"{i}\t{i % 4}\t{name}")
    lst = os.path.join(d, "set.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    out = os.path.join(d, "set.bin")
    devnull = open(os.devnull, "w")
    keep, sys.stdout = sys.stdout, devnull
    try:
        im2bin(lst, root + "/", out)
    finally:
        sys.stdout = keep
        devnull.close()
    return out


def _scenario_native_decode(aud: LockAuditor, path: str,
                            device: str) -> List[Dict[str, Any]]:
    """A short pass of the image decoder's reader over an imgbin file,
    read twice (a rewind between): NativeBinReader (its page-reader
    thread, nvJPEG workers and reorder buffer) on the card,
    PlainBinReader (its decode pool) on the CPU."""
    from cxxnet_tpu_torch import kernels
    from cxxnet_tpu_torch.io.native import NativeBinReader, PlainBinReader
    cuda = device != "cpu"
    k0 = kernels.launches().get(kernels.DECODER, 0)
    reader = (NativeBinReader([path], n_threads=2, max_inflight=8,
                              device=device) if cuda
              else PlainBinReader([path], n_threads=2, max_inflight=8))
    counts = []
    try:
        for _ in range(2):
            reader.before_first()
            n = 0
            while reader.next() is not None:
                n += 1
            counts.append(n)
    finally:
        reader.close()
    decoded = kernels.launches().get(kernels.DECODER, 0) - k0
    checks = [_check("native-decode", "all-records-read",
                     counts == [48, 48], f"records per pass {counts}")]
    if cuda:
        checks.append(_check(
            "native-decode", "decoded-on-the-card", decoded > 0,
            f"{decoded} YccToRgb launches ({type(reader).__name__})"))
    return checks


def _scenario_elastic_coordinator(aud: LockAuditor) -> List[Dict[str, Any]]:
    """The elastic coordinator's threads (parallel/coordinator.py)
    under audit: two members' lease-heartbeat threads plus concurrent
    barrier() calls from their training threads - a completed barrier
    with a single elected leader, a publish, then a conviction (one
    member stops arriving). It keeps the coordinator's cross-thread
    lock order in the audited graph."""
    import tempfile

    from cxxnet_tpu_torch.parallel.coordinator import (
        ControlPlane, Coordinator, PodReshapeRequired)

    checks: List[Dict[str, Any]] = []
    with tempfile.TemporaryDirectory() as td:
        plane = ControlPlane(td)
        c0 = Coordinator(plane, 0, [0, 1], barrier_secs=5.0,
                         lease_secs=0.2, poll_secs=0.01)
        c1 = Coordinator(plane, 1, [0, 1], barrier_secs=5.0,
                         lease_secs=0.2, poll_secs=0.01)
        results: Dict[int, Any] = {}
        errors: List[str] = []
        res_lock = threading.Lock()

        def trainer(coord: Coordinator) -> None:
            try:
                for rnd in range(3):
                    r = coord.barrier(rnd)
                    with res_lock:
                        results[(coord.member, rnd)] = r
                    if r.is_leader:
                        path = os.path.join(td, f"{rnd:04d}.model")
                        with open(path, "wb") as f:
                            f.write(b"x" * 16)
                        coord.publish(r, rnd, path, "0" * 64, 16)
            except Exception as e:  # noqa: BLE001 - reported below
                with res_lock:
                    errors.append(f"{type(e).__name__}: {e}")

        with c0, c1:
            threads = [threading.Thread(target=trainer, args=(c,),
                                        name=f"elastic-m{c.member}",
                                        daemon=True)
                       for c in (c0, c1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30.0)
            # conviction path: member 0 barriers alone at round 3
            c0.barrier_secs = 0.3
            try:
                c0.barrier(3)
                convicted = False
            except PodReshapeRequired as e:
                convicted = e.missing == [1]
            # heartbeats must have renewed leases while the barriers
            # ran (sampled after the conviction wait - the barriers
            # themselves can complete inside one renewal period)
            renewed = c0.renewals > 0 and c1.renewals > 0
        leaders = {r.leader for r in results.values()}
        publishers = [r for r in results.values() if r.is_leader]
        manifest = plane.read_manifest()
        checks.append(_check(
            "elastic-coordinator", "barriers-completed",
            not errors and len(results) == 6,
            errors[0] if errors else f"{len(results)}/6 barriers"))
        checks.append(_check(
            "elastic-coordinator", "single-leader",
            leaders == {0} and len(publishers) == 3,
            f"leaders={sorted(leaders)}, "
            f"{len(publishers)} leader-side results"))
        checks.append(_check(
            "elastic-coordinator", "published",
            manifest is not None and manifest.get("epoch") == 3,
            f"manifest={manifest}"))
        checks.append(_check(
            "elastic-coordinator", "lease-renewed", renewed,
            f"renewals: m0={c0.renewals} m1={c1.renewals}"))
        checks.append(_check(
            "elastic-coordinator", "conviction-raised", convicted,
            "absent member convicted at the timed-out barrier"))
    return checks


def _scenario_seeded_inversion(
        aud: LockAuditor) -> List[Dict[str, Any]]:
    """The deliberate ABBA fixture: thread 1 takes A then B, thread 2
    takes B then A - run SEQUENTIALLY (no deadlock risk; the order
    graph does not care about timing, only per-thread sequences). The
    audit must report the cycle and fail."""
    lock_a = threading.Lock()
    lock_b = threading.Lock()

    def a_then_b() -> None:
        with lock_a:
            with lock_b:
                pass

    def b_then_a() -> None:
        with lock_b:
            with lock_a:
                pass

    for fn in (a_then_b, b_then_a):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        t.join(timeout=10.0)
    return [_check("seeded-inversion", "fixture-ran", True,
                   "two-lock ABBA interleaving recorded")]


SCENARIOS = ("prefetch-round", "watchdog-stall", "serve-storm",
             "native-decode", "elastic-coordinator")


# ---------------------------------------------------------------------------
# the audit driver
# ---------------------------------------------------------------------------
def run_lock_audit(scenarios: Optional[Sequence[str]] = None,
                   seed_inversion: bool = False,
                   device: str = DEFAULT_DEVICE) -> Dict[str, Any]:
    """Run the selected scenarios (default: all) under one installed
    auditor and return the combined report: per-scenario checks plus
    the global graph checks (acyclic order, no lock across a dispatch
    boundary, non-vacuous coverage). ``seed_inversion`` additionally
    runs the ABBA fixture, which must make the acyclic check fail."""
    names = tuple(scenarios) if scenarios else SCENARIOS
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise ValueError(
            f"unknown lock-audit scenario(s) {unknown}; "
            f"known: {list(SCENARIOS)}")
    t0 = time.monotonic()
    device = str(resolve_device(device))
    checks: List[Dict[str, Any]] = []
    trainer = None
    if "serve-storm" in names:
        # built BEFORE the shim installs: the audit targets the serve
        # layer's locks, not the trainer's import-time internals
        from cxxnet_tpu_torch.analysis.graph_audit import _make_trainer
        trainer = _make_trainer(device)
    tmpd = tempfile.mkdtemp(prefix="lock_audit_")
    binfile = (_write_imgbin(tmpd) if "native-decode" in names else "")
    aud = LockAuditor()
    fns: Dict[str, Callable[[], List[Dict[str, Any]]]] = {
        "prefetch-round": lambda: _scenario_prefetch_round(aud, device),
        "watchdog-stall": lambda: _scenario_watchdog_stall(aud),
        "serve-storm": lambda: _scenario_serve_storm(aud, trainer,
                                                     device),
        "native-decode": lambda: _scenario_native_decode(aud, binfile,
                                                         device),
        "elastic-coordinator":
            lambda: _scenario_elastic_coordinator(aud),
    }
    with aud.installed():
        for name in names:
            try:
                checks.extend(fns[name]())
            except Exception as e:  # noqa: BLE001 - a crash IS the finding
                checks.append(_check(
                    name, "scenario-completed", False,
                    f"{type(e).__name__}: {e}"))
        if seed_inversion:
            checks.extend(_scenario_seeded_inversion(aud))
    rep = aud.report()
    cycle = rep["cycle"]
    checks.append(_check(
        "lock-order", "acyclic", cycle is None,
        " -> ".join(cycle) if cycle
        else f"{len(rep['edges'])} edges, no cycle"))
    checks.append(_check(
        "dispatch-boundary", "no-lock-held-across-dispatch",
        not rep["boundary_violations"],
        "; ".join(f"{v['thread']} held {v['locks']} at "
                  f"{v['boundary']}"
                  for v in rep["boundary_violations"])
        or "no audited lock held at a card sync or tensor read"))
    checks.append(_check(
        "coverage", "locks-observed", rep["acquisitions"] > 0,
        f"{rep['sites']} sites, {rep['instances']} instances, "
        f"{rep['acquisitions']} acquisitions"))
    shutil.rmtree(tmpd, ignore_errors=True)
    rep["scenarios"] = list(names)
    rep["device"] = device
    rep["seed_inversion"] = bool(seed_inversion)
    rep["checks"] = checks
    rep["failed"] = sum(1 for c in checks if not c["ok"])
    rep["elapsed_s"] = round(time.monotonic() - t0, 3)
    # contention stats into the process registry, next to the other
    # observability series (docs/OBSERVABILITY.md)
    from cxxnet_tpu_torch import telemetry
    telemetry.set_gauge("lock.audit.max_held_ms", rep["max_held_ms"])
    telemetry.set_gauge("lock.audit.max_wait_ms", rep["max_wait_ms"])
    telemetry.set_gauge("lock.audit.sites", rep["sites"])
    return rep
