"""Shared helpers for the queue-backed producer threads in io (own copy
of cxxnet_tpu/io/thread_util.py).

The role of utils/thread_buffer.h (thread_buffer.h:22-202) — a bounded
producer/consumer handoff with a shutdown protocol that can't deadlock:
the producer only ever blocks in a stop-aware put, and the consumer side
drains the queue while joining so a pending put always unblocks.
"""

from __future__ import annotations

import queue
import threading
import time


class ErrorBox:
    """Single-slot cross-thread exception handoff: the producer
    ``put``s its failure, the consumer ``take``s it after the queue's
    sentinel arrives. The box is what makes the publication explicit -
    a bare ``self._exc = e`` on the worker would be an unlocked
    shared-state write (the queue sentinel *usually* orders it, but
    nothing says so in the code). First error wins; ``take`` clears the
    slot."""

    __slots__ = ("_lock", "_exc")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._exc = None

    def put(self, exc: BaseException) -> None:
        with self._lock:
            if self._exc is None:
                self._exc = exc

    def take(self):
        """Return-and-clear the stored exception (None if clean)."""
        with self._lock:
            exc, self._exc = self._exc, None
            return exc


def stoppable_put(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """Bounded put that aborts when `stop` is set. Returns False if
    aborted (the producer should exit)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def drain_and_join(q: "queue.Queue", thread: threading.Thread,
                   stop: threading.Event, timeout: float = 30.0,
                   on_item=None) -> None:
    """Stop a producer: set the flag, drain so a pending put unblocks,
    join with a bounded total wait.

    `on_item` sees every drained queue item - so a shutdown can notice
    an undelivered worker EXCEPTION instead of silently discarding it
    (io/prefetch.py surfaces those from close()).

    Raises RuntimeError if the producer is still alive after `timeout`
    (stuck outside q.put, e.g. a stalled read): restarting on top of a
    live producer would race it on the shared underlying iterator, so a
    stuck pipeline must fail loudly instead."""
    stop.set()
    deadline = time.monotonic() + timeout

    def drain():
        try:
            while True:
                item = q.get_nowait()
                if on_item is not None:
                    on_item(item)
        except queue.Empty:
            pass

    while thread.is_alive() and time.monotonic() < deadline:
        drain()
        thread.join(timeout=0.1)
    if thread.is_alive():
        raise RuntimeError(
            f"io producer thread failed to stop within {timeout}s "
            "(stalled read?); cannot safely restart the pipeline")
    # the producer may have completed a final put between the last
    # drain and its exit - sweep once more so nothing lingers
    drain()
