"""The port's telemetry core (cxxnet_tpu_torch/telemetry: registry,
spans, sinks, health) held to the JAX package's (cxxnet_tpu/telemetry)
on the CPU.

Each mirrored case runs on both packages (parametrized `pkg`); the
differential cases run one operation script through both and compare.
Tolerance: exact. Numbers come from the same stdlib arithmetic (the
windowed percentile is pure Python in both), so snapshots compare with
==, and sink output compares byte for byte once the wall-clock `ts`,
`host` and `pid` tags - which differ by construction - are fixed."""

import importlib
import json
import math
import threading
import time

import numpy as np
import pytest

import cxxnet_tpu.telemetry as jax_tel
import cxxnet_tpu_torch.telemetry as port_tel

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


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_counter_gauge_basics(pkg):
    reg = _mod(pkg, "registry")
    c = reg.Counter()
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = reg.Gauge()
    g.set(3)
    g.set(1.5)
    assert g.value == 1.5


def test_histogram_percentile_math(pkg):
    h = _mod(pkg, "registry").Histogram()
    for v in range(1, 101):
        h.observe(float(v))
    vals = np.arange(1, 101, dtype=np.float64)
    assert h.count == 100 and h.sum == pytest.approx(5050.0)
    assert h.percentile(50) == pytest.approx(np.percentile(vals, 50))
    assert h.percentile(99) == pytest.approx(np.percentile(vals, 99))
    assert h.snapshot()["mean"] == pytest.approx(50.5)


def test_histogram_empty_single_and_window(pkg):
    reg = _mod(pkg, "registry")
    h = reg.Histogram()
    assert math.isnan(h.percentile(50))
    assert h.snapshot()["p50"] is None
    h.observe(2.0)
    assert h.percentile(50) == h.percentile(99) == 2.0
    w = reg.Histogram(window=8)
    for v in range(100):
        w.observe(float(v))
    assert w.count == 100 and w.max == 99.0
    assert w.percentile(0) >= 92.0


def test_registry_idempotent_type_checked_thread_safe(pkg):
    r = _mod(pkg, "registry").MetricsRegistry()
    assert r.counter("a") is r.counter("a")
    with pytest.raises(TypeError):
        r.gauge("a")

    def work():
        for _ in range(1000):
            r.counter("n").inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert r.counter("n").value == 8000


def _registry_script(reg_mod):
    """One operation script over a registry: every instrument kind."""
    r = reg_mod.MetricsRegistry()
    r.counter("serve.requests").inc(7)
    r.gauge("serve.queue_depth").set(12.5)
    rng = np.random.RandomState(0)
    for v in rng.rand(300):
        r.histogram("serve.latency_s").observe(float(v))
    bh = r.bucket_histogram("serve.request_rows", bounds=(1, 2, 4, 8))
    for v in (1, 3, 3, 8, 9, 2):
        bh.observe(v)
    h = r.histogram("serve.device_s")
    qs = [h.percentile(q) for q in (50, 99)]
    for v in (0.5, 0.1, 0.9, 0.3):
        h.observe(v)
    qs += [h.percentile(q) for q in (0, 25, 50, 75, 99, 100)]
    return r.snapshot(), qs


def test_registry_script_matches_jax():
    want_snap, want_q = _registry_script(_mod("jax", "registry"))
    got_snap, got_q = _registry_script(_mod("torch", "registry"))
    assert got_snap == want_snap
    assert [str(v) for v in got_q] == [str(v) for v in want_q]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
def test_span_disabled_is_noop_singleton(pkg):
    tel = _mod(pkg).Telemetry()
    s1, s2 = tel.span("a"), tel.span("b")
    assert s1 is s2
    with s1:
        pass
    assert tel.registry.get("a") is None


def test_span_nesting_records_paths(pkg, tmp_path):
    mod = _mod(pkg)
    tel = mod.Telemetry()
    log = str(tmp_path / "ev.jsonl")
    tel.configure(log_file=log)
    with tel.span("round"):
        with tel.span("step", idx=3):
            time.sleep(0.01)
        with tel.span("step"):
            pass
    tel.close()
    assert tel.registry.get("round/step").count == 2
    assert tel.registry.get("round").count == 1
    spans = [e for e in mod.read_jsonl(log) if e["kind"] == "span"]
    assert [s["name"] for s in spans] == ["round/step", "round/step",
                                          "round"]
    assert spans[0]["idx"] == 3


def _span_script(mod, log):
    """Spans, events, beacons and the recent-span ring on one Telemetry:
    returns what is deterministic (names, counts, kinds, fields)."""
    tel = mod.Telemetry()
    tel.configure(log_file=log, tags={"device": "cpu"})
    for i in range(3):
        with tel.span("train"):
            with tel.span("step", idx=i):
                pass
    tel.event("span", name="train.step", secs=0.25, step=4)
    tel.beacon("train.step")
    tel.beacon("train.step", 2)
    tel.close()
    events = [{k: v for k, v in e.items()
               if k not in ("ts", "host", "pid", "secs")}
              for e in mod.read_jsonl(log)]
    snap = {k: (v["count"] if isinstance(v, dict) else v)
            for k, v in tel.registry.snapshot().items()}
    ring = [s["name"] for s in tel.recent_spans()]
    return events, snap, ring, tel.beacons()["train.step"][0]


def test_span_script_matches_jax(tmp_path):
    want = _span_script(_mod("jax"), str(tmp_path / "j.jsonl"))
    got = _span_script(_mod("torch"), str(tmp_path / "p.jsonl"))
    assert got == want
    assert got[3] == 3


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------
RECORDS = [
    {"ts": 12.0, "kind": "checkpoint", "host": "h", "pid": 1, "proc": 0,
     "op": "save", "round": 3, "secs": 0.5, "bytes": 123},
    {"ts": 13.5, "kind": "span", "host": "h", "pid": 1, "proc": 0,
     "name": "train.step", "loss": float("nan"), "ips": float("inf"),
     "np_nan": np.float32("nan"), "vals": [1, 2.5, None],
     "nested": {"a": np.float64(0.1), "b": np.int64(7)}},
    {"ts": 14.25, "kind": "metrics", "host": "h", "pid": 1, "proc": 0,
     "metrics": {"serve.requests": 7,
                 "serve.latency_s": {"count": 2, "p50": 0.1}}},
]


@pytest.mark.parametrize("fmt", ["json", "text"])
def test_line_sink_bytes_equal_jax(tmp_path, fmt):
    outs = []
    for pkg in ("jax", "torch"):
        path = str(tmp_path / f"{pkg}.log")
        sink = _mod(pkg, "sink").LineSink(path, fmt)
        for rec in RECORDS:
            sink.write(dict(rec))
        sink.close()
        with open(path, "rb") as f:
            outs.append(f.read())
    assert outs[0] and outs[1] == outs[0]
    if fmt == "json":
        for line in outs[1].decode().splitlines():
            assert "NaN" not in line and "Infinity" not in line
            json.loads(line)


def test_read_jsonl_torn_last_line_matches_jax(tmp_path):
    p = tmp_path / "m.jsonl"
    p.write_text(json.dumps({"kind": "round", "round": 1}) + "\n"
                 + json.dumps({"kind": "round", "round": 2}) + "\n"
                 + '{"kind": "round", "rou')  # killed mid-write
    want = list(_mod("jax", "sink").read_jsonl(str(p)))
    got = list(_mod("torch", "sink").read_jsonl(str(p)))
    assert got == want == [{"kind": "round", "round": 1},
                           {"kind": "round", "round": 2}]


def test_jsonl_round_trip_with_tags(pkg, tmp_path):
    mod = _mod(pkg)
    tel = mod.Telemetry()
    log, met = str(tmp_path / "ev.jsonl"), str(tmp_path / "me.jsonl")
    tel.configure(log_file=log, metrics_file=met, tags={"device": "cpu"})
    tel.inc("fault.retry", 2)
    tel.observe("train.step_s", 0.25)
    tel.event("checkpoint", op="save", round=3, secs=0.5, bytes=123)
    tel.emit_metrics(kind="round", round=3)
    tel.close()
    (e,) = list(mod.read_jsonl(log))
    assert e["kind"] == "checkpoint" and e["bytes"] == 123
    for tag in ("ts", "host", "pid", "proc", "device"):
        assert tag in e
    (m,) = list(mod.read_jsonl(met))
    assert m["metrics"]["fault.retry"] == 2 and m["round"] == 3


def test_sink_io_failure_never_raises(pkg, tmp_path, capfd):
    sink = _mod(pkg, "sink").LineSink(str(tmp_path / "ev.jsonl"))
    sink._f.close()
    sink.write({"kind": "x"})
    sink.write({"kind": "y"})
    sink.flush()
    sink.close()
    assert "telemetry: disabling sink" in capfd.readouterr().err


def test_log_format_validation(pkg, tmp_path):
    with pytest.raises(ValueError):
        _mod(pkg).Telemetry().configure(log_file=str(tmp_path / "x"),
                                        log_format="xml")


def test_stdout_stderr_passthrough_and_mirror(pkg, tmp_path, capfd):
    mod = _mod(pkg)
    tel = mod.Telemetry()
    log = str(tmp_path / "ev.jsonl")
    tel.configure(log_file=log)
    tel.stdout("hello out")
    tel.stderr("[1]\ttest-error:0.5\n", event_kind="eval", round=1,
               values={"test-error": 0.5})
    tel.stderr("plain line\n")
    tel.close()
    out, err = capfd.readouterr()
    assert out == "hello out\n"
    assert err == "[1]\ttest-error:0.5\nplain line\n"
    assert [e["kind"] for e in mod.read_jsonl(log)] == ["log", "eval",
                                                         "log"]


def test_disabled_telemetry_writes_no_files(pkg, tmp_path, capfd):
    tel = _mod(pkg).Telemetry()
    tel.stderr("text\n")
    tel.event("x", a=1)
    tel.emit_metrics()
    assert capfd.readouterr().err == "text\n"
    assert list(tmp_path.iterdir()) == []


def test_heartbeat_and_reconfigure(pkg, tmp_path):
    mod = _mod(pkg)
    tel = mod.Telemetry()
    met = str(tmp_path / "hb.jsonl")
    tel.configure(metrics_file=met, heartbeat_secs=0.05)
    tel.inc("beats.seen")
    time.sleep(0.18)
    tel.close()
    hb = [r for r in mod.read_jsonl(met) if r["kind"] == "heartbeat"]
    assert len(hb) >= 2 and hb[-1]["metrics"]["beats.seen"] == 1
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    tel.configure(log_file=a)
    tel.event("one")
    tel.configure(log_file=b)
    tel.event("two")
    tel.configure()
    tel.event("three")
    assert [e["kind"] for e in mod.read_jsonl(a)] == ["one"]
    assert [e["kind"] for e in mod.read_jsonl(b)] == ["two"]


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------
def _health_script(mod):
    h = mod.HealthState()
    seq = [h.status()]
    h.set_unhealthy("serve_shed", "load shed: queue 8 rows + 4 > limit 8")
    h.set_unhealthy("watchdog", "stall")
    seq.append(h.status())
    h.clear("serve_shed")
    seq.append(h.status())
    h.clear("watchdog")
    h.clear("never-set")
    seq.append(h.status())
    return seq


def test_health_verdicts_match_jax():
    want = _health_script(_mod("jax"))
    got = _health_script(_mod("torch"))
    assert got == want
    assert got[0][0] is True and got[1][0] is False


def test_port_singleton_is_separate_from_jax():
    """Both planes live in one process: the port's counters never show
    in the JAX package's registry, nor the reverse."""
    port_tel.inc("serve.requests", 3)
    assert jax_tel.get().registry.get("serve.requests") is None
    jax_tel.inc("serve.requests", 5)
    assert port_tel.get().registry.counter("serve.requests").value == 3
