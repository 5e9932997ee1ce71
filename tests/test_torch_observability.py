"""The port's live observability plane (cxxnet_tpu_torch/telemetry:
http.py exposition and endpoints, alerts.py, watchdog.py, the
arm/disarm lifecycle and the CLI keys that arm it) held to the JAX
package's on the CPU.

Tolerance: exact. The same instrument operations render byte-equal
Prometheus text in both packages (one process: the host and pid tags
are the same); the alert engines fire and resolve the same rules at the
same injected clock readings; validate_exposition gives the same
verdicts on the same text."""

import importlib
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import cxxnet_tpu.telemetry as jax_tel
import cxxnet_tpu_torch.telemetry as port_tel
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.telemetry import Telemetry
from cxxnet_tpu_torch.telemetry.alerts import AlertEngine, load_rules
from cxxnet_tpu_torch.telemetry.http import (
    PROM_CONTENT_TYPE, ObservabilityServer, prom_label_escape, prom_name,
    render_prometheus, validate_exposition)
from cxxnet_tpu_torch.telemetry.sink import read_jsonl
from cxxnet_tpu_torch.telemetry.watchdog import Watchdog

PKGS = {"jax": "cxxnet_tpu", "torch": "cxxnet_tpu_torch"}


def _mod(pkg, name=""):
    return importlib.import_module(PKGS[pkg] + ".telemetry"
                                   + (f".{name}" if name else ""))


@pytest.fixture(autouse=True)
def _clean_singletons():
    jax_tel.reset_for_tests()
    port_tel.reset_for_tests()
    yield
    jax_tel.reset_for_tests()
    port_tel.reset_for_tests()


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _obs_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("telemetry-")]


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------
def _instrument_script(pkg):
    """The same instrument operations on a fresh Telemetry of `pkg`:
    every kind, an empty histogram, a bucket histogram, escaped tags,
    an executable entry with dispatches."""
    mod = _mod(pkg)
    tel = mod.Telemetry()
    tel.inc("fault.retry", 3)
    tel.inc("serve.requests", 41)
    tel.set_gauge("train.loss", 0.25)
    tel.set_gauge("serve.queue_depth", float("nan"))
    for v in (0.01, 0.02, 0.03, 0.04, 0.5):
        tel.observe("train.step_s", v)
    tel.histogram("serve.latency_s")
    bh = tel.registry.bucket_histogram("serve.request_rows",
                                       bounds=(1, 2, 4, 8))
    for v in (1, 3, 3, 8, 9, 2):
        bh.observe(v)
    tel.set_tags(host='h"x\\y\nz', pid=1234, device="cpu")
    fp = _mod(pkg, "flight").fingerprint("serve.infer", 5, 8, (3, 35, 35))
    tel.executables.register(fp, name="serve.infer:b8", kind="serve",
                             shape="(8, 3, 35, 35)", arg_bytes=117600,
                             device="cpu", compile_s=0.5)
    tel.executables.count_dispatch(fp, secs=0.25)
    tel.executables.count_dispatch(fp, secs=0.125)
    return tel


def _render(pkg):
    tel = _instrument_script(pkg)
    http = _mod(pkg, "http")
    text = http.render_prometheus(tel)
    # the executable's last-use wall clock differs by construction
    return "\n".join(ln for ln in text.splitlines()
                     if "last_used" not in ln)


def test_render_prometheus_byte_equal_jax():
    want = _render("jax")
    got = _render("torch")
    assert got == want
    assert validate_exposition(got + "\n") == []
    assert "cxxnet_serve_requests_total 41" in got
    assert 'cxxnet_serve_latency_s{quantile="0.5"} NaN' in got


def test_render_every_instrument_kind():
    tel = Telemetry()
    tel.inc("fault.retry", 3)
    tel.set_gauge("train.loss", 0.25)
    for v in (0.01, 0.02, 0.03, 0.04):
        tel.observe("train.step_s", v)
    lines = render_prometheus(tel).splitlines()
    assert "# TYPE cxxnet_fault_retry_total counter" in lines
    assert "cxxnet_fault_retry_total 3" in lines
    assert "cxxnet_train_loss 0.25" in lines
    assert "# TYPE cxxnet_train_step_s summary" in lines
    assert "cxxnet_train_step_s_count 4" in lines


@pytest.mark.parametrize("name", ["train.step_s", "io.prefetch.depth",
                                  "9weird name", "serve.request_rows"])
def test_prom_name_matches_jax(name):
    assert prom_name(name) == _mod("jax", "http").prom_name(name)


def test_prom_label_escaping():
    assert prom_label_escape('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


@pytest.mark.parametrize("text", [
    "ok_metric 1\n",
    "bad metric name 1\n",
    'x{unclosed="v" 1\n',
    "# FROB x y\n",
    "# TYPE a counter\na 1\na 2\n",
    "# HELP a b\n# TYPE a gauge\na NaN\n",
    'x{le="+Inf"} 3\n',
    "",
])
def test_validate_exposition_verdicts_match_jax(text):
    want = _mod("jax", "http").validate_exposition(text)
    got = validate_exposition(text)
    assert got == want


# ---------------------------------------------------------------------------
# endpoints
# ---------------------------------------------------------------------------
def test_http_endpoints_metrics_varz_healthz_404():
    tel = Telemetry()
    tel.inc("train.images", 64)
    srv = ObservabilityServer(tel, 0, host="127.0.0.1").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, ctype, body = _get(base + "/metrics")
        assert code == 200 and ctype == PROM_CONTENT_TYPE
        assert validate_exposition(body.decode()) == []
        assert "cxxnet_train_images_total 64" in body.decode()
        code, ctype, body = _get(base + "/varz")
        rec = json.loads(body)
        assert rec["kind"] == "varz"
        assert rec["metrics"]["train.images"] == 64
        code, _, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        tel.health.set_unhealthy("watchdog", "no progress for 99s")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/healthz")
        assert ei.value.code == 503
        assert "watchdog" in json.loads(ei.value.read())["reasons"]
        tel.health.clear("watchdog")
        assert _get(base + "/healthz")[0] == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/nope")
        assert ei.value.code == 404
    finally:
        srv.close()
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{srv.port}/healthz", timeout=0.5)


def test_server_scrapes_do_not_touch_std_streams(capfd):
    srv = ObservabilityServer(Telemetry(), 0, host="127.0.0.1").start()
    try:
        _get(f"http://127.0.0.1:{srv.port}/metrics")
        _get(f"http://127.0.0.1:{srv.port}/varz")
    finally:
        srv.close()
    assert capfd.readouterr() == ("", "")


# ---------------------------------------------------------------------------
# alert rules: the firing sequence under an injected clock
# ---------------------------------------------------------------------------
RULE_SCRIPTS = {
    "threshold_for_secs": (
        [{"name": "q", "type": "threshold", "metric": "serve.queue_depth",
          "op": ">", "value": 10, "for_secs": 5}],
        [(0, "gauge", "serve.queue_depth", 50), (0, None), (4.9, None),
         (5.0, None), (5.5, "gauge", "serve.queue_depth", 2),
         (6.0, None)]),
    "threshold_blip": (
        [{"name": "q", "type": "threshold", "metric": "serve.queue_depth",
          "op": ">", "value": 10, "for_secs": 5}],
        [(0, "gauge", "serve.queue_depth", 50), (0, None),
         (1, "gauge", "serve.queue_depth", 0), (3, None),
         (3.5, "gauge", "serve.queue_depth", 50), (4, None), (8.9, None),
         (9.0, None)]),
    "hysteresis": (
        [{"name": "q", "type": "threshold", "metric": "serve.queue_depth",
          "op": ">", "value": 10, "for_secs": 0, "clear_secs": 10}],
        [(0, "gauge", "serve.queue_depth", 99), (0, None),
         (1, "gauge", "serve.queue_depth", 0), (5, None),
         (7, "gauge", "serve.queue_depth", 99), (8, None),
         (8.5, "gauge", "serve.queue_depth", 0), (9, None),
         (19.5, None)]),
    "histogram_p99": (
        [{"name": "slow", "type": "threshold", "metric": "serve.latency_s",
          "op": ">", "value": 0.5, "for_secs": 0, "stat": "p99"}],
        [(0, "observe", "serve.latency_s", 0.01, 99), (0, None),
         (0.5, "observe", "serve.latency_s", 2.0, 40), (1, None)]),
    "rate": (
        [{"name": "nan", "type": "rate", "metric": "fault.nan_rollback",
          "max_per_min": 3, "window_secs": 60}],
        [(0, None), (1, "inc", "fault.nan_rollback", 2), (60, None),
         (61, "inc", "fault.nan_rollback", 30), (120, None),
         (300, None)]),
    "rate_sustain": (
        [{"name": "nan", "type": "rate", "metric": "fault.nan_rollback",
          "max_per_min": 3, "window_secs": 600, "for_secs": 100}],
        [(0, None), (1, "inc", "fault.nan_rollback", 50), (60, None),
         (120, None), (161, None)]),
}


def _run_rules(pkg, rules, script):
    """Drive one engine through `script`: (t, None) checks at now + t,
    other steps mutate the registry. Returns the fired lists, the
    health verdicts and the alert counters."""
    mod = _mod(pkg)
    tel = mod.Telemetry()
    eng = _mod(pkg, "alerts").AlertEngine(tel, [dict(r) for r in rules])
    now = time.monotonic()
    seq = []
    for step in script:
        t, op = step[0], step[1]
        if op is None:
            seq.append((t, eng.check_now(now + t), tel.health.ok))
        elif op == "gauge":
            tel.set_gauge(step[2], step[3])
        elif op == "inc":
            tel.inc(step[2], step[3])
        else:
            for _ in range(step[4]):
                tel.observe(step[2], step[3])
    snap = tel.registry.snapshot()
    return seq, snap.get("alert.fired"), snap.get("alert.resolved")


@pytest.mark.parametrize("case", sorted(RULE_SCRIPTS))
def test_alert_firing_sequence_matches_jax(case):
    rules, script = RULE_SCRIPTS[case]
    want = _run_rules("jax", rules, script)
    got = _run_rules("torch", rules, script)
    assert got == want
    assert any(fired for _t, fired, _ok in got[0])


def test_absence_rule_beacon_and_startup_grace():
    tel = Telemetry()
    now = time.monotonic()
    eng = AlertEngine(tel, [{
        "name": "stall", "type": "absence", "beacon": "train.step",
        "for_secs": 10, "startup_grace_secs": 60}])
    eng._armed_at = now
    assert eng.check_now(now + 30) == []
    assert eng.check_now(now + 61) == ["stall"]
    tel.beacon("train.step")
    real = time.monotonic()
    assert eng.check_now(real) == []
    assert tel.health.ok
    assert eng.check_now(real + 10.5) == ["stall"]


def test_alert_cmd_hook_and_stream_events(tmp_path):
    tel = Telemetry()
    log = str(tmp_path / "ev.jsonl")
    tel.configure(log_file=log)
    marker = tmp_path / "hook.out"
    eng = AlertEngine(
        tel, [{"name": "q", "type": "threshold", "metric": "x.y",
               "op": ">", "value": 1, "for_secs": 0}],
        alert_cmd=f'echo "$ALERT_NAME $ALERT_STATE" >> {marker}')
    now = time.monotonic()
    tel.set_gauge("x.y", 5)
    assert eng.check_now(now) == ["q"]
    tel.set_gauge("x.y", 0)
    assert eng.check_now(now + 1) == []
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if marker.exists() and len(marker.read_text().splitlines()) >= 2:
            break
        time.sleep(0.05)
    assert marker.read_text().splitlines() == ["q firing", "q resolved"]
    tel.close()
    alerts = [e for e in read_jsonl(log) if e["kind"] == "alert"]
    assert [a["state"] for a in alerts] == ["firing", "resolved"]


@pytest.mark.parametrize("rules,match", [
    ([{"type": "frobnicate"}], "unknown type"),
    ([{"type": "absence", "beacon": "b", "for_secs": 5, "for_sec": 5}],
     "unknown key"),
    ([{"type": "threshold", "metric": "m", "op": "~", "value": 1}], "op"),
    ([{"name": "a", "type": "absence", "beacon": "b", "for_secs": 1},
      {"name": "a", "type": "absence", "beacon": "c", "for_secs": 1}],
     "duplicate"),
    ({"rules": "nope"}, "JSON list"),
])
def test_load_rules_validation_matches_jax(tmp_path, rules, match):
    p = tmp_path / "r.json"
    p.write_text(json.dumps(rules))
    with pytest.raises(ValueError, match=match) as got:
        load_rules(str(p))
    with pytest.raises(ValueError) as want:
        _mod("jax", "alerts").load_rules(str(p))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
def test_watchdog_stall_dump_and_recovery(tmp_path, capfd):
    tel = Telemetry()
    log = str(tmp_path / "ev.jsonl")
    tel.configure(log_file=log)
    with tel.span("train.chunk"):
        pass
    now = time.monotonic()
    wd = Watchdog(tel, 5.0)
    wd._armed_at = now
    tel.beacon("train.step")
    base = time.monotonic()
    assert wd.check_now(base + 1) is False
    assert wd.check_now(base + 6) is True
    assert wd.check_now(base + 7) is True
    ok, reasons = tel.health.status()
    assert not ok and "watchdog" in reasons
    tel.beacon("train.step")
    assert wd.check_now(time.monotonic()) is False
    assert tel.health.ok
    tel.close()
    err = capfd.readouterr().err
    assert "watchdog: no progress" in err
    assert "test_watchdog_stall_dump_and_recovery" in err
    assert "train.chunk" in err
    events = list(read_jsonl(log))
    dumps = [e for e in events if e.get("kind") == "watchdog"
             and e.get("op") == "stall_dump"]
    assert len(dumps) == 1
    assert "test_watchdog_stall_dump_and_recovery" in dumps[0]["stacks"]
    assert dumps[0]["spans"][-1]["name"] == "train.chunk"
    assert tel.registry.counter("watchdog.stalls").value == 1


def test_watchdog_startup_grace_and_close():
    tel = Telemetry()
    now = time.monotonic()
    wd = Watchdog(tel, 2.0, startup_secs=60.0)
    wd._armed_at = now
    assert wd.check_now(now + 30) is False
    assert wd.check_now(now + 61) is True
    assert not tel.health.ok
    wd.close()
    assert tel.health.ok


# ---------------------------------------------------------------------------
# arming lifecycle and the CLI
# ---------------------------------------------------------------------------
def test_arm_observability_all_off_is_a_noop():
    assert port_tel.arm_observability() is None
    assert port_tel.arm_observability(
        metrics_port=None, alert_rules="", alert_cmd="",
        watchdog_secs=0.0) is None
    assert _obs_threads() == []


def test_arm_and_disarm_lifecycle(tmp_path):
    rules = tmp_path / "r.json"
    rules.write_text(json.dumps([
        {"name": "stall", "type": "absence", "beacon": "train.step",
         "for_secs": 30}]))
    srv = port_tel.arm_observability(
        metrics_port=0, alert_rules=str(rules), watchdog_secs=30.0)
    try:
        assert srv is not None and srv.port > 0
        names = _obs_threads()
        for n in ("telemetry-http", "telemetry-watchdog",
                  "telemetry-alerts"):
            assert n in names
        assert _get(f"http://127.0.0.1:{srv.port}/healthz")[0] == 200
        assert port_tel.get().flight.enabled
        # the watchdog alone is no per-step cost; the listener is
        assert port_tel.enabled()
    finally:
        port_tel.disarm_observability()
    deadline = time.monotonic() + 5.0
    while _obs_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _obs_threads() == []
    port_tel.arm_observability(watchdog_secs=60.0)
    try:
        assert not port_tel.enabled()
    finally:
        port_tel.disarm_observability()


def _train_conf(tmp_path):
    from test_torch_train import CLI_CONF, write_mnist
    d = str(tmp_path)
    write_mnist(d, "train", 100, 3)
    write_mnist(d, "t10k", 50, 4)
    conf = os.path.join(d, "train.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(d=d, shuffle=0,
                                models=os.path.join(d, "models")))
    return conf


def test_cli_unarmed_run_spawns_no_observability(tmp_path, capfd):
    """Off by default: no telemetry key -> no plane thread, no socket,
    no observability text in the CLI's output."""
    conf = _train_conf(tmp_path)
    seen = []
    stop = threading.Event()

    def watch():
        while not stop.wait(0.01):
            seen.extend(_obs_threads())

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    try:
        assert port_main.main([conf, "num_round=1", "max_round=1"]) == 0
    finally:
        stop.set()
        th.join(timeout=5)
    assert seen == [] and _obs_threads() == []
    out, err = capfd.readouterr()
    for needle in ("watchdog", "alert", "healthz", "observability"):
        assert needle not in out and needle not in err


def test_cli_run_with_metrics_port_live_scrape(tmp_path, capfd):
    """A training run with the plane armed serves live scrapes with the
    trainer's step spans on them; the listener dies with the run, and
    the event stream holds the step spans and the checkpoint saves."""
    conf = _train_conf(tmp_path)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    log = str(tmp_path / "ev.jsonl")
    got = {}
    stop = threading.Event()

    def poll():
        base = f"http://127.0.0.1:{port}"
        while not stop.wait(0.02):
            try:
                code, ctype, body = _get(base + "/metrics", timeout=1.0)
                if "cxxnet_train_step_s" in body.decode():
                    got["metrics"] = (ctype, body.decode())
                got["healthz"] = _get(base + "/healthz", timeout=1.0)[0]
            except (OSError, ValueError):
                continue

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        rc = port_main.main([conf, f"metrics_port={port}",
                             "watchdog_secs=60", f"log_file={log}",
                             "num_round=3", "max_round=3"])
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert rc == 0
    capfd.readouterr()
    ctype, body = got["metrics"]
    assert ctype == PROM_CONTENT_TYPE
    assert validate_exposition(body) == []
    assert got["healthz"] == 200
    assert _obs_threads() == []
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/healthz", timeout=0.5)
    events = list(read_jsonl(log))
    kinds = [e["kind"] for e in events]
    assert kinds[:2] == ["observability", "run_start"]
    assert kinds[-1] == "run_end"
    steps = [e for e in events
             if e["kind"] == "span" and e["name"] == "train.step"]
    assert len(steps) == 3 * 4  # 100 rows / batch 25, three rounds
    assert all(np.isfinite(e["loss"]) for e in steps)
    saves = [e for e in events
             if e["kind"] == "checkpoint" and e.get("op") == "save"]
    assert len(saves) == 4 and all(e["bytes"] > 0 for e in saves)
    reg = port_tel.get().registry
    assert reg.histogram("checkpoint.save_s").count == 4
    assert reg.counter("train.images").value == 300


@pytest.mark.parametrize("key,val", [
    ("metrics_port", "abc"), ("heartbeat_secs", "x"),
    ("watchdog_secs", "y"), ("flight_recorder", "z"),
])
def test_cli_rejects_bad_telemetry_values_as_jax(key, val):
    """The CLI's telemetry keys parse their values as the JAX CLI does:
    the same error type for the same bad value."""
    from cxxnet_tpu.main import LearnTask as JaxTask
    with pytest.raises(ValueError) as want:
        JaxTask().set_param(key, val)
    with pytest.raises(ValueError) as got:
        port_main.LearnTask().set_param(key, val)
    assert str(got.value) == str(want.value)


def test_schema_recognizes_telemetry_and_serve_keys():
    from cxxnet_tpu_torch.analysis import schema
    reg = schema.get_registry(refresh=True)
    for key in ("metrics_port", "metrics_host", "alert_rules",
                "alert_cmd", "watchdog_secs", "flight_recorder",
                "log_file", "metrics_file", "log_format",
                "heartbeat_secs", "publish_model", "serve_port",
                "serve_queue_limit", "serve_deadline_ms",
                "serve_shed_clear_ms", "swap_watch", "swap_poll_ms",
                "swap_canary_frac", "swap_canary_window",
                "serve_conn_timeout_ms", "serve_max_conns",
                "serve_max_body_bytes", "serve_bucket_ladder",
                "telemetry_steps"):
        assert reg.recognizes(key), key
        assert key not in reg.not_ported, key
    assert reg.suggest("metrics_portt") == "metrics_port"
    assert reg.suggest("serve_queue_limitt") == "serve_queue_limit"
