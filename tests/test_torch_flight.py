"""The port's flight recorder and executable registry
(cxxnet_tpu_torch/telemetry/flight.py) and their dispatch sites - the
trainer's train / eval / infer programs and the Server's warmed
buckets - held to the JAX package's on the CPU.

Tolerance: exact (ring contents, in-flight marking, fingerprints and
the /executables schema are bookkeeping). Where the port cannot say
what the JAX package says, the difference is named: an /executables
entry carries the same fields, but `cost_bytes` (XLA's "bytes
accessed") stays None in the port, whose `flops` come from
torch.utils.flop_counter over the warmup forward instead of XLA's cost
analysis."""

import importlib
import json
import time
import urllib.request

import numpy as np
import pytest

import cxxnet_tpu.telemetry as jax_tel
from cxxnet_tpu_torch import telemetry
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Server
from cxxnet_tpu_torch.telemetry import Telemetry
from cxxnet_tpu_torch.telemetry.flight import (
    ExecutableRegistry, FlightRecorder, fingerprint)
from cxxnet_tpu_torch.telemetry.http import (
    render_prometheus, validate_exposition)
from cxxnet_tpu_torch.telemetry.sink import read_jsonl
from cxxnet_tpu_torch.telemetry.watchdog import Watchdog

MLP_CFG = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1:sg1] = tanh
layer[sg1->fc2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,36
batch_size = 32
dev = cpu
eta = 0.3
silent = 1
seed = 7
metric = error
"""

# the fields of an /executables entry (tests/test_flight.py's list)
EXEC_FIELDS = ("fingerprint", "name", "kind", "shape", "arg_bytes",
               "device", "donated", "compile_s", "flops", "cost_bytes",
               "out_bytes", "dispatches", "dispatch_s", "last_used_ts")
# what the port leaves None where the JAX package fills it
PORT_LEAVES_OUT = ("cost_bytes",)


@pytest.fixture(autouse=True)
def _clean_singleton():
    telemetry.reset_for_tests()
    jax_tel.reset_for_tests()
    yield
    telemetry.reset_for_tests()
    jax_tel.reset_for_tests()


def make_trainer():
    t = NetTrainer(cfg=MLP_CFG)
    t.init_model()
    return t


def _batch(i, b=32):
    rng = np.random.RandomState(100 + i)
    return DataBatch(
        data=rng.rand(b, 1, 1, 36).astype(np.float32),
        label=rng.randint(0, 3, size=(b, 1)).astype(np.float32))


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


# ---------------------------------------------------------------------------
# ring semantics, against the JAX recorder on one script
# ---------------------------------------------------------------------------
def _ring_script(mod):
    fr = mod.FlightRecorder(size=4)
    out = [fr.start("train", fp="x") is None, fr.snapshot()]
    fr.arm()
    wedged = fr.start("serve", fp="wedged99", bucket=8, nbytes=1024,
                      trace="t-w", fields={"rows": 5})
    for i in range(10):
        fr.finish(fr.start("train", fp=f"fp{i}", bucket=32))
    fl = fr.start("infer", fp="open1", bucket=4)
    fr.fail(fl, "RuntimeError: boom")
    keys = ("seq", "kind", "fp", "bucket", "bytes", "in_flight", "trace",
            "rows", "error")
    out.append([{k: s.get(k) for k in keys} for s in fr.snapshot()])
    out.append([{k: s.get(k) for k in keys} for s in fr.in_flight()])
    out.append([s["fp"] for s in fr.tail(3)])
    fr.finish(wedged)
    out.append(fr.in_flight())
    return out


def test_ring_script_matches_jax():
    want = _ring_script(importlib.import_module(
        "cxxnet_tpu.telemetry.flight"))
    got = _ring_script(importlib.import_module(
        "cxxnet_tpu_torch.telemetry.flight"))
    assert got == want
    assert got[3][0]["fp"] == "wedged99"  # the wedged entry survived


def test_record_lifecycle_and_in_flight_marking():
    fr = FlightRecorder(size=8)
    fr.arm()
    fl = fr.start("serve", fp="deadbeef0123", bucket=8, nbytes=1024,
                  trace="t-1", fields={"rows": 5})
    (snap,) = fr.snapshot()
    assert snap["in_flight"] is True and snap["age_s"] >= 0
    assert snap["trace"] == "t-1" and snap["rows"] == 5
    fr.finish(fl)
    (snap,) = fr.snapshot()
    assert snap["in_flight"] is False and snap["secs"] >= 0
    assert "IN-FLIGHT" not in fr.format_tail()


def test_open_table_bounded_and_tail_names_in_flight():
    fr = FlightRecorder(size=4)
    fr.arm()
    for i in range(10):
        fr.start("train", fp=f"leak{i}")
    assert len(fr.in_flight()) == 4
    fr2 = FlightRecorder(size=8)
    fr2.arm()
    fr2.finish(fr2.start("train", fp="aaa111"))
    fr2.start("serve", fp="bbb222", bucket=16, trace="t-9")
    text = fr2.format_tail()
    assert "IN-FLIGHT" in text and "fp=bbb222" in text
    assert "bucket=16" in text and "trace=t-9" in text


@pytest.mark.parametrize("parts", [
    ("serve.infer", 3, 8, (1, 1, 36), 0),
    ("serve.infer", 3, 16, (1, 1, 36), 0),
    ("train_step", (32, 1, 1, 36)),
    ("infer", 5, 2, (8, 3, 35, 35)),
])
def test_fingerprint_matches_jax(parts):
    want = importlib.import_module(
        "cxxnet_tpu.telemetry.flight").fingerprint(*parts)
    assert fingerprint(*parts) == want and len(want) == 12


# ---------------------------------------------------------------------------
# executable registry and the /executables schema
# ---------------------------------------------------------------------------
def test_registry_register_idempotent_counts_accumulate():
    reg = ExecutableRegistry()
    reg.register("fp1", name="train_step@b32", kind="train",
                 shape="(32, 1, 1, 36)", arg_bytes=4608, donated=1)
    reg.count_dispatch("fp1", secs=0.5)
    reg.count_dispatch("fp1")
    reg.register("fp1", name="other", kind="train", compile_s=1.25)
    (e,) = reg.snapshot()
    assert e["name"] == "train_step@b32"
    assert e["dispatches"] == 2 and e["dispatch_s"] == 0.5
    assert e["compile_s"] == 1.25
    reg.count_dispatch("unknown-fp")
    assert len(reg) == 1


def test_registry_enrich_counts_flops_of_the_forward():
    import torch
    reg = ExecutableRegistry()
    w = torch.ones(8, 8)
    reg.register("fpX", name="toy", kind="infer")
    reg.enrich("fpX", lambda x: x @ w, (torch.ones(4, 8),))
    (e,) = reg.snapshot()
    assert e["flops"] == 2 * 4 * 8 * 8
    assert e["out_bytes"] == 4 * 8 * 4
    assert e["cost_bytes"] is None
    reg.enrich("nope", lambda x: x, (torch.ones(1),))
    assert len(reg) == 1


def _executables_body(tel):
    tel.flight.arm()
    tel.executables.register("fpZ", name="serve.infer:b4", kind="serve",
                             shape="(4, 1, 1, 36)", arg_bytes=576,
                             donated=0, compile_s=0.1)
    tel.executables.count_dispatch("fpZ")
    tel.flight.finish(tel.flight.start("serve", fp="fpZ", bucket=4))
    tel.flight.start("serve", fp="fpZ", bucket=4)
    mod = importlib.import_module(type(tel).__module__ + ".http")
    srv = mod.ObservabilityServer(tel, 0, host="127.0.0.1").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        return (json.loads(_get(base + "/executables")),
                json.loads(_get(base + "/varz")))
    finally:
        srv.close()


def test_executables_endpoint_schema_matches_jax():
    jrec, jvarz = _executables_body(jax_tel.Telemetry())
    prec, pvarz = _executables_body(Telemetry())
    assert set(prec) == set(jrec)
    assert prec["kind"] == "executables"
    (je,), (pe,) = jrec["executables"], prec["executables"]
    assert set(pe) == set(je) == set(EXEC_FIELDS)
    for k in ("fingerprint", "name", "kind", "shape", "arg_bytes",
              "donated", "compile_s", "dispatches"):
        assert pe[k] == je[k], k
    (inf,) = prec["in_flight"]
    assert inf["fp"] == "fpZ" and inf["in_flight"] is True
    assert [f["fp"] for f in pvarz["flight"]] == \
        [f["fp"] for f in jvarz["flight"]] == ["fpZ", "fpZ"]


def test_exposition_valid_with_every_new_series():
    tel = Telemetry()
    tel.registry.bucket_histogram("serve.request_rows",
                                  bounds=(1, 2, 4)).observe(3)
    tel.executables.register("fp1", name="serve.infer:b8", kind="serve",
                             compile_s=0.5)
    tel.executables.count_dispatch("fp1")
    tel.flight.arm()
    tel.flight.start("serve", fp="fp1", bucket=8)
    text = render_prometheus(tel)
    assert validate_exposition(text) == []
    assert 'cxxnet_serve_request_rows_bucket{le="+Inf"} 1' in text
    assert "cxxnet_flight_inflight 1" in text


def test_flight_arms_with_sinks_and_plane(tmp_path):
    tel = Telemetry()
    assert tel.flight.enabled is False
    tel.configure(log_file=str(tmp_path / "ev.jsonl"))
    assert tel.flight.enabled is True
    tel.configure()
    assert tel.flight.enabled is False
    tel.arm_observability(watchdog_secs=60.0)
    assert tel.flight.enabled is True
    tel.disarm_observability()
    assert tel.flight.enabled is False
    tel.flight.arm()
    tel.configure()
    assert tel.flight.enabled is True
    tel.close()


# ---------------------------------------------------------------------------
# trainer + serve dispatch sites
# ---------------------------------------------------------------------------
def test_trainer_sites_register_and_record():
    tr = make_trainer()
    tr.update(_batch(0))
    tr.predict(_batch(3))
    by_name = {e["name"]: e for e in telemetry.executables().snapshot()}
    assert by_name["train_step@b32"]["dispatches"] == 1
    assert by_name["train_step@b32"]["donated"] == 1
    infer = [e for e in by_name.values() if e["kind"] == "infer"]
    assert infer and infer[0]["dispatches"] == 1
    assert infer[0]["donated"] == 0
    # unarmed: the registry filled but the ring stayed empty
    assert telemetry.flight().snapshot() == []
    telemetry.flight().arm()
    tr.update(_batch(4))
    tr.predict(_batch(5))
    kinds = [f["kind"] for f in telemetry.flight().snapshot()]
    assert kinds == ["train", "infer"]
    fps = {f["fp"] for f in telemetry.flight().snapshot()}
    assert fps <= {e["fingerprint"]
                   for e in telemetry.executables().snapshot()}
    # the progress beacon moved once per step
    assert telemetry.beacons()["train.step"][0] == 2


def test_evaluate_registers_eval_executable():
    tr = make_trainer()

    class _OneBatch:
        def __init__(self):
            self._served = False

        def before_first(self):
            self._served = False

        def next(self):
            if self._served:
                return False
            self._served = True
            return True

        def value(self):
            return _batch(9)

    tr.evaluate(_OneBatch(), "eval")
    kinds = {e["kind"] for e in telemetry.executables().snapshot()}
    assert "eval" in kinds
    assert telemetry.beacons()["eval.step"][0] == 1


def test_trace_id_propagates_through_oversize_split(tmp_path):
    events = str(tmp_path / "ev.jsonl")
    telemetry.configure(log_file=events)
    tr = make_trainer()
    srv = Server(tr, max_batch=4, max_wait_ms=2.0, replicas=2,
                 device="cpu")
    srv.warmup()
    srv.start()
    out = srv.submit(np.random.RandomState(0)
                     .rand(10, 1, 1, 36).astype(np.float32)
                     ).result(timeout=60)
    assert out.shape[0] == 10
    stats = srv.stop()
    telemetry.close()
    traces = [r for r in read_jsonl(events) if r.get("kind") == "trace"]
    assert len(traces) == 3
    assert len({r["trace"] for r in traces}) == 1
    assert sorted(r["part"] for r in traces) == [0, 1, 2]
    assert sum(r["rows"] for r in traces) == 10
    for r in traces:
        assert (r["t_submit"] <= r["t_collect"] <= r["t_dispatch"]
                <= r["t_done"])
        assert r["queue_ms"] == pytest.approx(
            (r["t_dispatch"] - r["t_submit"]) * 1e3, abs=0.01)
        assert r["fp"]
    serve_flights = [f for f in telemetry.flight().snapshot()
                     if f["kind"] == "serve"]
    reg_fps = {e["fingerprint"] for e in telemetry.executables().snapshot()
               if e["kind"] == "serve"}
    assert serve_flights and {f["fp"] for f in serve_flights} <= reg_fps
    assert stats["queue_p50_ms"] is not None
    assert stats["device_p99_ms"] is not None


def test_failed_dispatch_closes_flight_entry_with_error():
    telemetry.flight().arm()
    tr = make_trainer()
    srv = Server(tr, max_batch=4, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    real = tr.stage_infer_rows
    state = {"fail": True}

    def flaky(data):
        if state.pop("fail", False):
            raise RuntimeError("injected staging failure")
        return real(data)

    tr.stage_infer_rows = flaky
    srv.start()
    bad = srv.submit(np.zeros((2, 1, 1, 36), np.float32))
    with pytest.raises(RuntimeError):
        bad.result(timeout=60)
    srv.submit(np.zeros((2, 1, 1, 36), np.float32)).result(timeout=60)
    stats = srv.stop()
    serve_flights = [f for f in telemetry.flight().snapshot()
                     if f["kind"] == "serve"]
    failed, ok = serve_flights
    assert failed["in_flight"] is False
    assert "injected staging failure" in failed["error"]
    assert ok["in_flight"] is False and "error" not in ok
    assert telemetry.flight().in_flight() == []
    # delivered through the future and counted, never re-run elsewhere
    assert stats["errors"] == 1
    assert telemetry.get().registry.counter("serve.errors").value == 1


def test_programmatic_metrics_server_arms_flight_and_enriches():
    tr = make_trainer()
    srv = Server(tr, max_batch=4, max_wait_ms=1.0, replicas=1,
                 metrics_port=0, metrics_host="127.0.0.1", device="cpu")
    assert telemetry.flight().enabled
    srv.warmup()
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.metrics_server.port}"
        srv.submit(np.zeros((3, 1, 1, 36), np.float32)).result(timeout=60)
        varz = json.loads(_get(base + "/varz"))
        assert any(f["kind"] == "serve" for f in varz["flight"])
        execs = json.loads(_get(base + "/executables"))
        serve = {e["name"]: e for e in execs["executables"]
                 if e["kind"] == "serve"}
        assert sorted(serve) == ["serve.infer:b1", "serve.infer:b2",
                                 "serve.infer:b4"]
        for b in (1, 2, 4):
            e = serve[f"serve.infer:b{b}"]
            # two fullc products: 2*b*(36*16 + 16*3) FLOPs
            assert e["flops"] == 2 * b * (36 * 16 + 16 * 3)
            assert e["out_bytes"] == b * 3 * 4
            for k in PORT_LEAVES_OUT:
                assert e[k] is None
    finally:
        srv.stop()
    assert telemetry.flight().enabled is False


def test_request_rows_histogram_reaches_metrics(tmp_path):
    telemetry.configure(log_file=str(tmp_path / "ev.jsonl"))
    tr = make_trainer()
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    srv.start()
    for n in (1, 3, 8, 8):
        srv.submit(np.random.RandomState(n).rand(n, 1, 1, 36)
                   .astype(np.float32)).result(timeout=60)
    srv.stop()
    text = render_prometheus(telemetry.get())
    assert validate_exposition(text) == []
    assert 'cxxnet_serve_request_rows_bucket{le="8"} 4' in text
    assert "cxxnet_serve_request_rows_count 4" in text


def test_watchdog_dump_names_in_flight_executable(tmp_path, capfd):
    tel = Telemetry()
    log = str(tmp_path / "ev.jsonl")
    tel.configure(log_file=log)
    tel.flight.finish(tel.flight.start("train", fp="aaa111", bucket=32))
    tel.flight.start("serve", fp="bbb222", bucket=8, trace="t-42")
    now = time.monotonic()
    wd = Watchdog(tel, 5.0)
    wd._armed_at = now
    tel.beacon("train.step")
    assert wd.check_now(time.monotonic() + 6) is True
    tel.close()
    err = capfd.readouterr().err
    assert "fp=bbb222" in err and "trace=t-42" in err
    (dump,) = [e for e in read_jsonl(log) if e.get("op") == "stall_dump"]
    assert "bbb222" in json.dumps(dump)
