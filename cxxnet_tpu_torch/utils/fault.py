"""Fault-tolerance primitives (counterpart of cxxnet_tpu/utils/fault.py):
the divergence error, the retry decorator, the process-wide
fault-injection registry and the atomic file writer.

- ``retry``: decorator for transient-failure paths (iterator reads,
  network mounts) with exponential backoff and jitter.
- a process-wide **fault-injection registry** driven by the
  ``CXXNET_FAULT`` env var (``point:mode@N`` specs) or the ``inject``
  API, so tests and chip_smoke.py can crash / delay / corrupt named
  fault points deterministically (the serving front's
  ``serve_dispatch_delay``, ``serve_dispatch_error``,
  ``swap_torn_checkpoint``, ``canary_divergence``,
  ``canary_judge_error``, ``serve_slow_client``, ...), and the
  rank-scoped modes (``kill_rank``, ``hang_rank``, ``delay_collective``)
  the elastic pod's end-to-end proofs murder one worker with.
- ``atomic_writer``: tmp-file + fsync + ``os.replace`` (+ a directory
  fsync) so a file either appears complete or not at all.
"""

from __future__ import annotations

import contextlib
import functools
import os
import random
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Type


class InjectedFault(RuntimeError):
    """Raised by a ``crash``-mode fault point (fault injection only)."""


class InjectedIOError(OSError):
    """Raised by an ``ioerror``-mode fault point: a *transient* IO
    error, the class the retry decorator absorbs."""


class DivergenceError(RuntimeError):
    """Training diverged: ``max_bad_rounds`` consecutive non-finite
    update rounds (the trainer's divergence guard, check_nan = 1)."""


def default_on_retry(fn, attempt, total, exc, sleep_s):
    """Per-retry notification: the JAX package's stderr text, routed
    through the telemetry plane (a structured ``fault`` event when a sink
    is armed) plus a ``fault.retry`` counter, so retry storms are
    countable."""
    from cxxnet_tpu_torch import telemetry
    telemetry.inc("fault.retry")
    telemetry.stderr(
        f"retry: {getattr(fn, '__qualname__', fn)} failed "
        f"(attempt {attempt}/{total}: {type(exc).__name__}: {exc}); "
        f"retrying in {sleep_s:.2f}s\n",
        event_kind="fault", type="retry",
        fn=str(getattr(fn, "__qualname__", fn)), attempt=attempt,
        attempts=total, error=f"{type(exc).__name__}: {exc}",
        sleep_s=sleep_s)


def retry(attempts: int = 3, backoff: float = 0.05, jitter: float = 0.05,
          retry_on: Tuple[Type[BaseException], ...] = (OSError,),
          deadline: Optional[float] = None,
          on_retry: Optional[Callable] = None):
    """Decorator: retry on transient errors with exponential backoff.

    - ``attempts``: total call attempts (1 = no retry).
    - ``backoff``: initial sleep between attempts, doubled each retry.
    - ``jitter``: uniform [0, jitter) seconds added to each sleep so
      many workers retrying the same shared resource don't stampede.
    - ``retry_on``: exception classes considered transient; anything
      else propagates immediately.
    - ``deadline``: optional cap on TOTAL elapsed seconds (including
      the pending sleep); when exceeded the last error propagates even
      if attempts remain.
    - ``on_retry(fn, attempt, attempts, exc, sleep_s)``: hook for the
      per-retry warning; default writes it to stderr.
    """
    if attempts < 1:
        raise ValueError("retry: attempts must be >= 1")
    notify = on_retry or default_on_retry

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            start = time.monotonic()
            delay = backoff
            for attempt in range(1, attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except retry_on as exc:
                    if attempt >= attempts:
                        raise
                    sleep_s = delay + random.uniform(0.0, jitter)
                    if (deadline is not None and
                            time.monotonic() - start + sleep_s > deadline):
                        raise
                    notify(fn, attempt, attempts, exc, sleep_s)
                    time.sleep(sleep_s)
                    delay *= 2
            raise AssertionError("unreachable")  # pragma: no cover
        return wrapped
    return deco


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
FAULT_ENV = "CXXNET_FAULT"
KILL_EXIT_CODE = 117  # distinctive: assertable from subprocess tests
# a worker that convicts an absent peer at a checkpoint barrier exits
# with this code so the elastic supervisor (parallel/elastic.py) knows
# to reshape the pod rather than treat it as a crash
RESHAPE_EXIT_CODE = 118


def current_rank() -> int:
    """This process's identity for the rank-scoped fault modes
    (kill_rank / hang_rank / delay_collective). Under the elastic
    supervisor this is the stable pod member id (CXN_MEMBER_ID) -
    generation ranks renumber after a reshape, so a spec pinned to a
    plain rank would fire on a different worker in every generation;
    otherwise the launcher's CXN_WORKER_RANK. The env vars exist before
    any process group does; torch.distributed's rank is read only when
    the group is already up (a fault point must never be what
    initialises anything)."""
    for key in ("CXN_MEMBER_ID", "CXN_WORKER_RANK"):
        v = os.environ.get(key)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                return 0
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:  # noqa: BLE001 - no group to ask: rank 0
            return 0
    return 0


class _Fault:
    __slots__ = ("mode", "arg", "at")

    def __init__(self, mode: str, arg: Optional[str], at: int):
        self.mode = mode
        self.arg = arg
        self.at = at


class FaultRegistry:
    """Process-wide registry of injected faults keyed by fault-point
    name. Specs come from the ``CXXNET_FAULT`` env var (re-parsed
    whenever its value changes, so monkeypatched env vars work
    in-process) or the programmatic ``inject`` API.

    Spec grammar (comma-separated)::

        point:mode@N        trigger `mode` on the Nth hit of `point`
        point:mode=ARG@N    mode with an argument (e.g. delay=0.5)

    ``@N`` defaults to 1; the fault fires exactly on hit N (hits are
    counted per process since the registry was last cleared).

    Built-in modes handled inside ``fault_point``:

    - ``crash``   raise InjectedFault
    - ``kill``    os._exit(KILL_EXIT_CODE) - simulates preemption; no
                  cleanup handlers run, exactly like SIGKILL
    - ``ioerror`` raise InjectedIOError (transient; retry-absorbable)
    - ``delay``   sleep arg seconds (default 0.05)

    Collective-scope (rank-aware) modes, for murdering one worker of a
    multi-process pod deterministically (the elastic pod's end-to-end
    proofs). The same spec is exported to every worker; only the named
    rank acts, and hits are counted per process (every rank hits the
    trainer's ``collective`` point once a dispatched step, in the same
    order, so ``@N`` picks the same step on every worker):

    - ``kill_rank=R``        ``kill``, only when current_rank() == R
    - ``hang_rank=R``        wedge the calling thread forever (a live
                             but stalled worker - the absence-alert /
                             STALE-verdict detection path), only on
                             rank R
    - ``delay_collective=S`` sleep S seconds (straggler injection);
      ``delay_collective=R:S`` restricts the delay to rank R

    Any other mode (``corrupt``, ...) is returned to the CALLER, which
    gives each fault point site-specific sabotage: checkpoint.py
    truncates the blob being written (``save_model:corrupt``) or tears
    a published file (``swap_torn_checkpoint:corrupt``), and the
    serving canary NaN-poisons the candidate's shadow outputs
    (``canary_divergence:corrupt``) so the rollback verdict trips.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # the registry's shared state: fault points fire from every
        # io/trainer thread, so all four fields move only under the
        # lock (checked statically - docs/STATIC_ANALYSIS.md GL016)
        # guarded-by: self._lock
        self._faults: Dict[str, List[_Fault]] = {}
        # guarded-by: self._lock
        self._env_faults: Dict[str, List[_Fault]] = {}
        # guarded-by: self._lock
        self._hits: Dict[str, int] = {}
        # guarded-by: self._lock
        self._env_seen: Optional[str] = None

    # -- configuration -----------------------------------------------------
    @staticmethod
    def parse(spec: str) -> Dict[str, List[_Fault]]:
        faults: Dict[str, List[_Fault]] = {}
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if ":" not in entry:
                raise ValueError(
                    f"bad {FAULT_ENV} entry {entry!r}: want point:mode[@N]")
            point, mode = entry.split(":", 1)
            at = 1
            if "@" in mode:
                mode, at_s = mode.rsplit("@", 1)
                at = int(at_s)
            arg = None
            if "=" in mode:
                mode, arg = mode.split("=", 1)
            if not point or not mode:
                raise ValueError(
                    f"bad {FAULT_ENV} entry {entry!r}: empty point/mode")
            faults.setdefault(point, []).append(_Fault(mode, arg, at))
        return faults

    def configure(self, spec: str) -> None:
        """Replace all injected faults with the parsed `spec` (hit
        counters reset)."""
        with self._lock:
            self._faults = self.parse(spec)
            self._hits = {}

    def inject(self, point: str, mode: str, arg: Optional[str] = None,
               at: int = 1) -> None:
        with self._lock:
            self._faults.setdefault(point, []).append(_Fault(mode, arg, at))

    def clear(self) -> None:
        with self._lock:
            self._faults = {}
            self._env_faults = {}
            self._hits = {}
            # forget the env value so a still-set CXXNET_FAULT is
            # re-armed on the next hit (clear = reset, not disable)
            self._env_seen = None

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    # -- the hot path ------------------------------------------------------
    def fault_point(self, point: str) -> Optional[str]:
        """Mark a named fault point. No-op (returns None) unless a
        fault is armed for `point` at the current hit count; then the
        built-in modes act here and caller-handled modes are returned
        as the action string."""
        env = os.environ.get(FAULT_ENV)
        with self._lock:
            if env != self._env_seen:
                # env faults layer over programmatic ones and are
                # REPLACED whenever the value changes (unset disarms
                # them); hit counters are preserved
                self._env_seen = env
                self._env_faults = self.parse(env) if env else {}
            if not self._faults and not self._env_faults:
                return None
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            armed = ([f for f in self._faults.get(point, ()) if f.at == hit]
                     + [f for f in self._env_faults.get(point, ())
                        if f.at == hit])
        for f in armed:
            if f.mode == "crash":
                raise InjectedFault(
                    f"injected crash at fault point {point!r} (hit {hit})")
            if f.mode == "kill":
                sys.stderr.write(
                    f"fault: killing process at fault point {point!r} "
                    f"(hit {hit})\n")
                sys.stderr.flush()
                os._exit(KILL_EXIT_CODE)
            if f.mode == "ioerror":
                raise InjectedIOError(
                    f"injected transient IO error at {point!r} (hit {hit})")
            if f.mode == "delay":
                time.sleep(float(f.arg) if f.arg else 0.05)
                continue
            if f.mode == "kill_rank":
                if f.arg is not None and current_rank() == int(f.arg):
                    sys.stderr.write(
                        f"fault: killing rank {f.arg} at fault point "
                        f"{point!r} (hit {hit})\n")
                    sys.stderr.flush()
                    os._exit(KILL_EXIT_CODE)
                continue
            if f.mode == "hang_rank":
                if f.arg is not None and current_rank() == int(f.arg):
                    sys.stderr.write(
                        f"fault: hanging rank {f.arg} at fault point "
                        f"{point!r} (hit {hit})\n")
                    sys.stderr.flush()
                    while True:  # wedged, not dead: detection's job
                        time.sleep(0.5)
                continue
            if f.mode == "delay_collective":
                spec = f.arg or "0.05"
                if ":" in spec:
                    rk, secs = spec.split(":", 1)
                    if current_rank() == int(rk):
                        time.sleep(float(secs))
                else:
                    time.sleep(float(spec))
                continue
            return f.mode  # site-handled action (e.g. "corrupt")
        return None


_REGISTRY = FaultRegistry()

# module-level convenience API (the registry is process-wide state,
# like the reference's global singletons)
fault_point = _REGISTRY.fault_point
inject = _REGISTRY.inject
clear = _REGISTRY.clear
configure = _REGISTRY.configure
hits = _REGISTRY.hits


@contextlib.contextmanager
def atomic_writer(path: str, mode: str = "wb", fsync: bool = True,
                  tmp_suffix: str = ".tmp"):
    """Write `path` atomically: the body writes to ``path + tmp_suffix``
    and a successful exit fsyncs + ``os.replace``s it into place, so
    `path` either holds the complete new content or is untouched. On
    error the tmp file is removed and the error propagates; on a hard
    kill mid-write only the tmp file can be left behind.
    """
    tmp = path + tmp_suffix
    fo = open(tmp, mode)
    try:
        yield fo
        fo.flush()
        if fsync:
            os.fsync(fo.fileno())
        fo.close()
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        with contextlib.suppress(OSError):
            fo.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def _fsync_dir(dirname: str) -> None:
    """fsync a directory so the rename itself is durable (best-effort:
    some filesystems refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
