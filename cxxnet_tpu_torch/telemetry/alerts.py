"""Declarative alert engine over the metrics registry (counterpart of
cxxnet_tpu/telemetry/alerts.py).

The fault counters count; nothing here ACTED on the counts - a
nan-rollback storm or a serve queue backlog scrolled past on stderr
(the ROADMAP pod item's "alert hooks on the fault counters" open end).
This module evaluates rules loaded from ``alert_rules=rules.json``
against the live registry on a background thread. Three condition
types:

- **threshold**: an instrument's current value compared against a
  bound, sustained for ``for_secs`` (``serve.queue_depth > 100 for
  10s``; histograms pick a ``stat`` - p50/p99/mean/count/sum);
- **rate**: a counter's increments per minute over a sliding window
  (``fault.nan_rollback > 3/min``);
- **absence**: a progress beacon (watchdog.py's table) that has gone
  silent for ``for_secs`` (``no train.step for 120s``). Before the
  beacon's first sighting the grace is ``startup_grace_secs``
  (default 60) - compile time must not page anyone.

A FIRING rule: emits an ``alert`` event (state=firing), bumps
``alert.fired``, flips `/healthz` to 503 (health source
``alert:<name>``), and optionally launches the ``alert_cmd=`` shell
hook with ALERT_NAME/ALERT_STATE/ALERT_MESSAGE in its environment
(fire-and-forget; a broken hook is noted once, never fatal). When the
condition has been false for ``clear_secs`` (hysteresis, default 0 =
immediately) the rule RESOLVES: state=resolved event, health cleared -
`/healthz` returns to 200 iff no other source is unhealthy.

Rule files are validated eagerly at load: an unknown type or key is a
config error at startup, not a rule that silently never fires (the
same stance as the config schema gate, docs/STATIC_ANALYSIS.md).
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional

from cxxnet_tpu_torch.telemetry.registry import Counter, Gauge, Histogram

STARTUP_GRACE_SECS = 60.0

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

# allowed keys per rule type: a typo'd key ("for_sec") must be a load
# error, not a rule that silently uses the default forever
_COMMON_KEYS = {"name", "type", "for_secs", "clear_secs"}
_RULE_KEYS = {
    "threshold": _COMMON_KEYS | {"metric", "op", "value", "stat"},
    "rate": _COMMON_KEYS | {"metric", "max_per_min", "window_secs"},
    "absence": _COMMON_KEYS | {"beacon", "startup_grace_secs"},
}
_HIST_STATS = ("p50", "p99", "mean", "count", "sum", "min", "max")
# numeric rule fields, coerced to float at load so a string "256" (a
# hand-written JSON slip) is a startup error, not a TypeError the
# evaluation loop would swallow forever
_NUMERIC_KEYS = ("value", "max_per_min", "window_secs", "for_secs",
                 "clear_secs", "startup_grace_secs")


def _validate_rule(rule: Dict, idx: int) -> Dict:
    if not isinstance(rule, dict):
        raise ValueError(f"alert rule #{idx} is not an object: {rule!r}")
    rtype = rule.get("type")
    if rtype not in _RULE_KEYS:
        raise ValueError(
            f"alert rule #{idx}: unknown type {rtype!r} "
            f"(want one of {sorted(_RULE_KEYS)})")
    bad = set(rule) - _RULE_KEYS[rtype]
    if bad:
        raise ValueError(
            f"alert rule #{idx} ({rtype}): unknown key(s) "
            f"{sorted(bad)} - allowed: {sorted(_RULE_KEYS[rtype])}")
    rule = dict(rule)
    rule.setdefault("name", f"rule{idx}")
    if rtype == "threshold":
        for k in ("metric", "op", "value"):
            if k not in rule:
                raise ValueError(
                    f"alert rule {rule['name']!r}: threshold needs "
                    f"'{k}'")
        if rule["op"] not in _OPS:
            raise ValueError(
                f"alert rule {rule['name']!r}: op {rule['op']!r} not "
                f"in {sorted(_OPS)}")
        stat = rule.setdefault("stat", "p99")
        if stat not in _HIST_STATS:
            raise ValueError(
                f"alert rule {rule['name']!r}: stat {stat!r} not in "
                f"{_HIST_STATS}")
    elif rtype == "rate":
        if "metric" not in rule or "max_per_min" not in rule:
            raise ValueError(
                f"alert rule {rule['name']!r}: rate needs 'metric' "
                "and 'max_per_min'")
        rule.setdefault("window_secs", 60.0)
    else:  # absence
        if "beacon" not in rule or "for_secs" not in rule:
            raise ValueError(
                f"alert rule {rule['name']!r}: absence needs 'beacon' "
                "and 'for_secs'")
        rule.setdefault("startup_grace_secs", STARTUP_GRACE_SECS)
    rule.setdefault("for_secs", 0.0)
    rule.setdefault("clear_secs", 0.0)
    for k in _NUMERIC_KEYS:
        if k not in rule:
            continue
        v = rule[k]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(
                f"alert rule {rule['name']!r}: '{k}' must be a "
                f"number, got {v!r}")
        rule[k] = float(v)
    return rule


def load_rules(path: str) -> List[Dict]:
    """Parse + validate a rules file: a JSON list of rule objects, or
    ``{"rules": [...]}``."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("rules", doc)
    if not isinstance(doc, list):
        raise ValueError(
            f"alert rules file {path}: want a JSON list of rules "
            f"(or {{'rules': [...]}}), got {type(doc).__name__}")
    rules = [_validate_rule(r, i) for i, r in enumerate(doc)]
    names = [r["name"] for r in rules]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(
            f"alert rules file {path}: duplicate rule name(s) "
            f"{sorted(dupes)}")
    return rules


class _RuleState:
    __slots__ = ("rule", "firing", "pending_since", "clear_since",
                 "samples", "fired_count", "broken")

    def __init__(self, rule: Dict) -> None:
        self.rule = rule
        self.firing = False
        self.pending_since: Optional[float] = None
        self.clear_since: Optional[float] = None
        # rate rules: sliding window of (t, counter value)
        self.samples: collections.deque = collections.deque()
        self.fired_count = 0
        self.broken = False  # eval blew up (noted once)


class AlertEngine:
    """Evaluates rules on a daemon thread; ``check_now(now)`` is the
    deterministic entry point tests drive with a fake clock."""

    def __init__(self, tel, rules: List[Dict], alert_cmd: str = "",
                 poll_secs: Optional[float] = None) -> None:
        self.tel = tel
        self.alert_cmd = alert_cmd
        # normalize/validate here too (idempotent after load_rules):
        # programmatic rule lists get the same eager rejection and
        # defaulting the file loader applies
        rules = [_validate_rule(r, i) for i, r in enumerate(rules)]
        self.states = [_RuleState(r) for r in rules]
        if poll_secs is None:
            spans = [float(r.get("for_secs") or 0) for r in rules] + \
                    [float(r.get("window_secs") or 0) for r in rules]
            tight = min([s for s in spans if s > 0], default=4.0)
            poll_secs = min(max(tight / 4.0, 0.05), 1.0)
        self.poll_secs = float(poll_secs)
        self._armed_at = time.monotonic()
        self._hook_broken = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "AlertEngine":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="telemetry-alerts", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for rs in self.states:
            if rs.firing:
                # same contract as the watchdog: a dying engine must
                # not leave a permanent 503 behind
                rs.firing = False
                self.tel.health.clear(f"alert:{rs.rule['name']}")

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_secs):
            try:
                self.check_now()
            except Exception:  # noqa: BLE001 - alerting never kills training
                pass

    # -- evaluation --------------------------------------------------------
    def check_now(self, now: Optional[float] = None) -> List[str]:
        """Evaluate every rule; returns the names currently firing.
        Rules are isolated: one rule blowing up (noted once on
        stderr) must not stop the rules after it from being
        evaluated."""
        now = time.monotonic() if now is None else now
        for rs in self.states:
            try:
                cond, msg = self._condition(rs, now)
                self._advance(rs, cond, msg, now)
            except Exception as e:  # noqa: BLE001 - per-rule isolation
                if not rs.broken:
                    rs.broken = True
                    self.tel.stderr(
                        f"alerts: rule {rs.rule['name']!r} failed to "
                        f"evaluate: {type(e).__name__}: {e}\n",
                        event_kind="alert", name=rs.rule["name"],
                        state="eval_error",
                        error=f"{type(e).__name__}: {e}")
        return [rs.rule["name"] for rs in self.states if rs.firing]

    def _value(self, metric: str, stat: str):
        inst = self.tel.registry.get(metric)
        if inst is None:
            return None
        if isinstance(inst, (Counter, Gauge)):
            return inst.value
        if isinstance(inst, Histogram):
            snap = inst.snapshot()
            return snap.get(stat)
        return None

    def _condition(self, rs: _RuleState, now: float):
        r = rs.rule
        if r["type"] == "threshold":
            v = self._value(r["metric"], r["stat"])
            if v is None:
                return False, ""
            hit = _OPS[r["op"]](v, r["value"])
            return hit, (f"{r['metric']} = {v:g} {r['op']} "
                         f"{r['value']:g}" if hit else "")
        if r["type"] == "rate":
            v = self._value(r["metric"], "count")
            if v is None:
                v = 0
            win = float(r["window_secs"])
            rs.samples.append((now, float(v)))
            # keep one sample older than the window as the baseline
            while (len(rs.samples) > 2
                   and now - rs.samples[1][0] >= win):
                rs.samples.popleft()
            t0, v0 = rs.samples[0]
            span = now - t0
            if span <= 0 or len(rs.samples) < 2:
                return False, ""
            per_min = (float(v) - v0) / span * 60.0
            hit = per_min > float(r["max_per_min"])
            return hit, (f"{r['metric']} at {per_min:.2f}/min > "
                         f"{r['max_per_min']:g}/min" if hit else "")
        # absence
        beacons = self.tel.beacons()
        b = beacons.get(r["beacon"])
        if b is None:
            age = now - self._armed_at
            grace = max(float(r["startup_grace_secs"]),
                        float(r["for_secs"]))
            hit = age >= grace
            return hit, (f"beacon {r['beacon']!r} never seen in "
                         f"{age:.1f}s" if hit else "")
        age = now - b[1]
        hit = age >= float(r["for_secs"])
        return hit, (f"no {r['beacon']!r} progress for {age:.1f}s"
                     if hit else "")

    def _advance(self, rs: _RuleState, cond: bool, msg: str,
                 now: float) -> None:
        r = rs.rule
        if cond:
            rs.clear_since = None
            if rs.firing:
                return
            if rs.pending_since is None:
                rs.pending_since = now
            # absence embeds its duration in the condition (for_secs
            # IS the beacon-age threshold); threshold and rate sustain
            # the condition for_secs before firing
            wait = (0.0 if r["type"] == "absence"
                    else float(r["for_secs"]))
            if now - rs.pending_since >= wait:
                self._fire(rs, msg, now)
        else:
            rs.pending_since = None
            if not rs.firing:
                return
            if rs.clear_since is None:
                rs.clear_since = now
            if now - rs.clear_since >= float(r["clear_secs"]):
                self._resolve(rs, now)

    # -- transitions -------------------------------------------------------
    def _fire(self, rs: _RuleState, msg: str, now: float) -> None:
        rs.firing = True
        rs.fired_count += 1
        name = rs.rule["name"]
        self.tel.inc("alert.fired")
        self.tel.event("alert", name=name, state="firing",
                       rule_type=rs.rule["type"], message=msg)
        self.tel.health.set_unhealthy(f"alert:{name}", msg)
        self._run_hook(name, "firing", msg)

    def _resolve(self, rs: _RuleState, now: float) -> None:
        rs.firing = False
        rs.clear_since = None
        name = rs.rule["name"]
        self.tel.inc("alert.resolved")
        self.tel.event("alert", name=name, state="resolved",
                       rule_type=rs.rule["type"])
        self.tel.health.clear(f"alert:{name}")
        self._run_hook(name, "resolved", "")

    def _run_hook(self, name: str, state: str, msg: str) -> None:
        if not self.alert_cmd:
            return
        env = dict(os.environ, ALERT_NAME=name, ALERT_STATE=state,
                   ALERT_MESSAGE=msg)
        try:
            subprocess.Popen(  # noqa: S602 - operator-supplied hook
                self.alert_cmd, shell=True, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError as e:
            if not self._hook_broken:
                self._hook_broken = True
                self.tel.stderr(
                    f"alerts: alert_cmd failed to launch: {e}\n",
                    event_kind="alert", name=name, state="hook_error",
                    error=str(e))
