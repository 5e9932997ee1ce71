"""Process-wide metrics registry: counters, gauges, histograms (counterpart of
cxxnet_tpu/telemetry/registry.py).

The reference framework's only runtime signal is a wall-clock round
time printed to stdout (cxxnet_main.cpp:376-387); nothing can count
retries, watch queue depths, or alert on checkpoint latency. This
module is the accounting half of the telemetry subsystem
(docs/OBSERVABILITY.md): cheap thread-safe instruments that work
whether or not any sink is configured. Rare-event sites (fault.retry,
checkpoint.*) accumulate unconditionally; per-step/per-batch hot paths
(train.*, io.prefetch.*) gate their instrumentation on a sink being
armed, because honest step timing costs a device sync the disabled
path must not pay. Snapshots are plain dicts, serialized into the
metrics JSONL by the sink layer.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Deque, Dict, List, Optional, Union

# histograms keep a bounded window of recent observations for
# percentiles (count/sum/min/max stay exact over the full stream); a
# training run observes one value per step, so 8192 covers hours of
# rounds without unbounded growth
HISTOGRAM_WINDOW = 8192


class Counter:
    """Monotonic counter (events, retries, batches)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, loss)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method),
    without the numpy import on the telemetry hot path."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded
    window of recent observations for p50/p99."""

    __slots__ = ("_lock", "count", "sum", "min", "max", "_window")

    def __init__(self, window: int = HISTOGRAM_WINDOW) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._window: Deque[float] = collections.deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._window.append(v)

    def percentile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._window)
        if not vals:
            return float("nan")
        return _percentile(vals, q)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._window)
            count, total = self.count, self.sum
            vmin, vmax = self.min, self.max
        out = {
            "count": count,
            "sum": total,
            "mean": total / count if count else None,
            "min": vmin if count else None,
            "max": vmax if count else None,
        }
        if vals:
            out["p50"] = _percentile(vals, 50)
            out["p99"] = _percentile(vals, 99)
        else:
            out["p50"] = out["p99"] = None
        return out


class BucketHistogram:
    """Fixed-bound cumulative-bucket histogram - the Prometheus
    ``histogram`` type (``_bucket{le=...}`` series), unlike Histogram
    above which exports as a quantile summary. Used where the value
    domain is known at creation (the Server's request-size
    distribution over its bucket ladder) so a scrape gets the real
    shape, not two quantiles."""

    __slots__ = ("_lock", "bounds", "count", "sum", "_counts")

    def __init__(self, bounds) -> None:
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("BucketHistogram needs >= 1 bound")
        self.count = 0
        self.sum = 0.0
        # per-bound NON-cumulative counts + one overflow slot;
        # snapshot() accumulates (the export wants cumulative le=)
        self._counts = [0] * (len(self.bounds) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            count, total = self.count, self.sum
        buckets: Dict[str, int] = {}
        acc = 0
        for b, c in zip(self.bounds, counts):
            acc += c
            key = str(int(b)) if b == int(b) else repr(b)
            buckets[key] = acc
        buckets["+Inf"] = count
        return {"count": count, "sum": total, "buckets": buckets}


Instrument = Union[Counter, Gauge, Histogram, BucketHistogram]


class MetricsRegistry:
    """Name -> instrument map. Creation is idempotent per (name, kind);
    asking for an existing name with a different kind is a programming
    error and fails loudly (a silent re-type would corrupt the stream
    consumers parse)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, name: str, cls) -> Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls()
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def bucket_histogram(self, name: str, bounds=()) -> BucketHistogram:
        """Idempotent per name like the other kinds; the FIRST
        creation's bounds win (a second Server re-requesting the
        instrument must not silently re-bucket the series mid-scrape)."""
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = BucketHistogram(bounds)
                self._instruments[name] = inst
            elif not isinstance(inst, BucketHistogram):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not BucketHistogram")
            return inst

    def get(self, name: str) -> Optional[Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> Dict[str, Instrument]:
        """Copied name -> instrument map (the Prometheus exposition
        needs instrument KINDS, which snapshot() erases - a counter
        and an integer-valued gauge snapshot identically)."""
        with self._lock:
            return dict(self._instruments)

    def reset(self) -> None:
        with self._lock:
            self._instruments = {}

    def snapshot(self) -> Dict[str, object]:
        """One JSON-ready dict of every instrument's current value
        (counters/gauges scalar, histograms a stats sub-dict), sorted
        by name so diffs of consecutive records are readable."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}
