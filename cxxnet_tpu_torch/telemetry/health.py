"""Process health state: the single source of truth for `/healthz` (counterpart of
cxxnet_tpu/telemetry/health.py).

One registry of (source -> reason) strings. A source that detects a
problem calls ``set_unhealthy``; when the condition clears it calls
``clear`` - so `/healthz` flips back to 200 exactly when every
detector has recovered (the hysteresis contract the alert engine and
watchdog both honor). Sources are namespaced strings ("watchdog",
"alert:<rule-name>") so independent detectors never clobber each
other's verdicts.

Stdlib-only and jax-free like the rest of the telemetry plane.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


class HealthState:
    """Thread-safe (source -> reason) map; healthy iff empty."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._reasons: Dict[str, str] = {}

    def set_unhealthy(self, source: str, reason: str) -> None:
        with self._lock:
            self._reasons[source] = reason

    def clear(self, source: str) -> None:
        with self._lock:
            self._reasons.pop(source, None)

    def reset(self) -> None:
        with self._lock:
            self._reasons = {}

    @property
    def ok(self) -> bool:
        with self._lock:
            return not self._reasons

    def status(self) -> Tuple[bool, Dict[str, str]]:
        """(healthy?, {source: reason}) snapshot."""
        with self._lock:
            return (not self._reasons, dict(self._reasons))
