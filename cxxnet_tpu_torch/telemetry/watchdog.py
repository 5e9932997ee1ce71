"""Hang watchdog: stack-dump forensics when progress stops (counterpart of
cxxnet_tpu/telemetry/watchdog.py).

A hung device call leaves a process silent until the operator kills
it. This module is the black box for that: instrumented sites publish
cheap *progress beacons* (``telemetry.beacon("train.step")`` - a dict
store + monotonic read, no device sync), and a daemon thread watches
the newest beacon's age. When nothing has progressed for
``watchdog_secs``:

1. every Python thread's stack is captured (``sys._current_frames``)
   together with the last N completed spans and the flight recorder's
   dispatch tail (telemetry/flight.py) - exactly where the hang is,
   what ran last, and WHICH executable (fingerprint, bucket, request
   trace id) is still in flight;
2. the dump goes to **stderr** and, as a structured ``watchdog``
   event (op=``stall_dump``, with the stacks and spans as fields), to
   the event stream - so a post-mortem needs only the JSONL;
3. ``/healthz`` flips to 503 (health.py source "watchdog") until a
   beacon moves again, which emits op=``recovered`` and clears it.

One dump per stall episode (a 10-minute hang is one incident, not 600
dumps). Before the FIRST beacon the threshold is ``startup_secs``
(default 60): model build, kernel builds and warmup legitimately run minutes
with no step progress, and a watchdog that cries during warmup would
be disarmed by every operator on day one.

Armed only via ``watchdog_secs=`` (or programmatically); never
imported otherwise.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import List, Optional

# threshold applied until the first beacon is seen (compile/init grace)
STARTUP_SECS = 60.0
# spans included in a stall dump
DUMP_SPANS = 20


def dump_stacks() -> str:
    """Every live Python thread's current stack, named."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {names.get(ident, '?')} "
                   f"(ident {ident}) ---")
        out.extend(line.rstrip("\n")
                   for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


class Watchdog:
    """Progress monitor over the telemetry beacon table."""

    def __init__(self, tel, stall_secs: float,
                 poll_secs: Optional[float] = None,
                 startup_secs: float = STARTUP_SECS,
                 dump_spans: int = DUMP_SPANS) -> None:
        if stall_secs <= 0:
            raise ValueError("watchdog_secs must be > 0")
        self.tel = tel
        self.stall_secs = float(stall_secs)
        # poll a few times per threshold so a stall is seen promptly
        # without a hot loop; clamped for tiny test thresholds
        self.poll_secs = (float(poll_secs) if poll_secs is not None
                          else min(max(stall_secs / 4.0, 0.05), 1.0))
        self.startup_secs = max(float(startup_secs), self.stall_secs)
        self.dump_spans = int(dump_spans)
        self.stalled = False
        self._armed_at = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="telemetry-watchdog",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self.stalled:
            # a watchdog that dies while firing must not leave a
            # permanent 503 behind (the next run's server would
            # inherit it in-process)
            self.stalled = False
            self.tel.health.clear("watchdog")

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_secs):
            try:
                self.check_now()
            except Exception:  # noqa: BLE001 - forensics never kill training
                pass

    # -- the check ---------------------------------------------------------
    def _progress_age(self, now: float) -> tuple:
        """(seconds since newest beacon, threshold to judge it by)."""
        beacons = self.tel.beacons()
        if not beacons:
            return now - self._armed_at, self.startup_secs
        last = max(ts for _, ts in beacons.values())
        return now - last, self.stall_secs

    def check_now(self, now: Optional[float] = None) -> bool:
        """One evaluation (the thread calls this; tests drive it with
        a fake clock). Returns the stalled state after the check."""
        now = time.monotonic() if now is None else now
        age, threshold = self._progress_age(now)
        if age >= threshold and not self.stalled:
            self.stalled = True
            self._dump(age)
        elif age < threshold and self.stalled:
            self.stalled = False
            self.tel.health.clear("watchdog")
            self.tel.event("watchdog", op="recovered",
                           stalled_secs=round(age, 3))
        return self.stalled

    def _dump(self, age: float) -> None:
        self.tel.inc("watchdog.stalls")
        stacks = dump_stacks()
        spans = self.tel.recent_spans()[-self.dump_spans:]
        span_lines = "".join(
            f"  {s['secs']:.4f}s {s['name']}\n" for s in spans)
        # flight-recorder tail (telemetry/flight.py): the stall dump's
        # "which executable" half - in-flight entries name the exact
        # wedged dispatch (fingerprint, bucket, request trace id) the
        # thread stacks alone cannot. Same one-dump-per-episode rule:
        # this runs only on the stalled-edge transition above.
        flights = self.tel.flight.tail(self.dump_spans)
        text = (
            f"watchdog: no progress for {age:.1f}s "
            f"(threshold {self.stall_secs:g}s); dumping "
            f"{stacks.count('--- thread')} thread stacks\n"
            f"{stacks}"
            f"last {len(spans)} spans (newest last):\n{span_lines}"
            f"last {len(flights)} dispatches (flight recorder, "
            f"newest last):\n"
            f"{self.tel.flight.format_tail(rows=flights)}")
        # stderr first (the operator's console), then the structured
        # event - both BEFORE the absence alert fires on the same
        # stall, since the alert engine judges beacon age with a
        # threshold that should sit above watchdog_secs
        self.tel.stderr(text, event_kind="watchdog", op="stall_dump",
                        stalled_secs=round(age, 3), stacks=stacks,
                        spans=spans, flights=flights)
        self.tel.health.set_unhealthy(
            "watchdog",
            f"no progress for {age:.1f}s "
            f"(watchdog_secs={self.stall_secs:g})")
