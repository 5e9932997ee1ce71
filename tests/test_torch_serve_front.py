"""The port's serving front (cxxnet_tpu_torch/serve/server.py over
telemetry/http.py) held to the JAX package's Server on the CPU:
/predict, load shedding with 429 + Retry-After and the /healthz shed
verdict, deadlines (504), the ingress limits (413, the accept gate's
503, slow-client cuts), hot-swap, the canary, drain, the bucket ladder,
checkpoint publishing, and the CLI's task = serve with SIGTERM.

Differential cases run the same input through both packages:
- the narrow AlexNet pair (tests/torch_port_util.py, K1's plain version
  on the CPU) with carried weights, served through both Servers: rows
  at JAX_TOL of tests/test_torch_serve.py, rtol 1e-4 / atol 1e-5
  (float32; XLA:CPU and torch's CPU kernels sum in other orders);
- the same /predict bodies: the same status codes, the same JSON keys,
  the same predictions (argmax) and outputs at JAX_TOL;
- ladder_buckets / ladder_from_histogram, validate_file verdicts and
  publish_model's `.meta` sidecar bytes: exact;
- Retry-After only where the JAX tests pin it: the cold clamp, and a
  stopped Server with a known backlog and drain rate (exact).
The rest mirrors tests/test_serve.py's front cases on the port alone,
with a small MLP; a swap's switch is bitwise on one bucket (one
float32 program), and a request served inside another bucket agrees
with its cold reference to rtol 1e-5 / atol 1e-6."""

import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import cxxnet_tpu.telemetry as jax_tel
from cxxnet_tpu.nnet import checkpoint as jax_ckpt
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.serve import Server as JaxServer
from cxxnet_tpu.serve import server as jax_server
from cxxnet_tpu.utils import fault as jax_fault
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch import telemetry
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet import checkpoint
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import (
    RETRY_AFTER_COLD_S, DeadlineExpiredError, QueueFullError, Server,
    bucket_sizes, ladder_buckets, ladder_from_histogram,
    predictions_from_rows)
from cxxnet_tpu_torch.telemetry.http import validate_exposition
from cxxnet_tpu_torch.utils import fault
from torch_port_util import NARROW_ALEXNET, carry

JAX_TOL = dict(rtol=1e-4, atol=1e-5)
# the port against itself across bucket sizes (tests/test_torch_serve.py)
SELF_TOL = dict(rtol=1e-5, atol=1e-6)

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
"""


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset_for_tests()
    jax_tel.reset_for_tests()
    fault.clear()
    jax_fault.clear()
    yield
    fault.clear()
    jax_fault.clear()
    telemetry.reset_for_tests()
    jax_tel.reset_for_tests()


def make_trainer(extra=""):
    t = NetTrainer(cfg=MLP_CFG + extra)
    t.init_model()
    return t


def req(rng, n):
    return rng.rand(n, 1, 1, 36).astype(np.float32)


def alex_rows(n, seed):
    return (np.random.RandomState(seed).randn(n, 3, 35, 35) * 3.0).astype(
        np.float32)


def _post(port, payload, timeout=30, raw=None):
    body = raw if raw is not None else json.dumps(payload).encode()
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(r, timeout=timeout)
        return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _stall_dispatch(n, secs, mod=fault):
    mod.clear()
    for i in range(n):
        mod.inject("serve_dispatch_delay", "delay", str(secs), at=i + 1)


def _save(tr, path):
    with open(path, "wb") as fo:
        tr.save_model(fo)


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def _wait(pred, secs=15.0):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# the narrow AlexNet pair through both Servers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def alex_pair():
    jt = JaxTrainer(cfg=NARROW_ALEXNET)
    jt.init_model()
    pt = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    pt.init_model()
    carry(jt, pt)
    return jt, pt


def test_ragged_stream_matches_jax_server(alex_pair):
    jt, pt = alex_pair
    sizes = [1, 3, 8, 2, 5, 7, 4, 11, 6]
    reqs = [alex_rows(n, 10 + i) for i, n in enumerate(sizes)]
    outs = []
    for cls, tr, kw in ((JaxServer, jt, {}), (Server, pt,
                                              {"device": "cpu"})):
        srv = cls(tr, max_batch=8, max_wait_ms=1.0, replicas=2, **kw)
        srv.warmup()
        with srv:
            futs = [srv.submit(r) for r in reqs]
            outs.append([np.asarray(f.result(timeout=120)) for f in futs])
    for want, got, n in zip(outs[0], outs[1], sizes):
        assert got.shape == want.shape == (n, 10)
        np.testing.assert_allclose(got, want, **JAX_TOL)
    want_all = np.concatenate(outs[0])
    assert len(set(want_all.argmax(1).tolist())) > 1
    # and the served rows are predict_dist's rows
    ref = pt.predict_dist(DataBatch(data=reqs[1], label=np.zeros((3, 1),
                                                                  np.float32)))
    np.testing.assert_allclose(outs[1][1], ref, rtol=1e-5, atol=1e-6)


def _predict_script(c, y, x):
    """(name, payload or raw bytes) of the /predict differential."""
    one = alex_rows(1, 30)
    two = alex_rows(2, 31)
    return [
        ("flat_raw", {"data": one.reshape(1, -1).tolist(), "raw": True}),
        ("nested", {"data": two.tolist(), "raw": True}),
        ("single_instance", {"data": one.reshape(-1).tolist()}),
        ("with_deadline", {"data": two.reshape(2, -1).tolist(),
                           "deadline_ms": 60000, "raw": True}),
        ("not_json", b"{nonsense"),
        ("no_data", {}),
        ("not_numeric", {"data": "nonsense"}),
        ("wrong_width", {"data": [[0.0] * 7]}),
        ("extras", {"data": one.reshape(1, -1).tolist(),
                    "extras": [[1.0]]}),
        ("empty_rows", {"data": np.zeros((0, c, y, x)).tolist()}),
    ]


def test_predict_bodies_match_jax_server(alex_pair):
    jt, pt = alex_pair
    script = _predict_script(3, 35, 35)
    results = []
    for cls, tr, kw in ((JaxServer, jt, {}), (Server, pt,
                                              {"device": "cpu"})):
        srv = cls(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                  http_port=0, metrics_host="127.0.0.1", **kw)
        srv.warmup()
        got = {}
        with srv:
            port = srv.metrics_server.port
            for name, payload in script:
                raw = payload if isinstance(payload, bytes) else None
                got[name] = _post(port, payload, raw=raw, timeout=120)
        results.append(got)
    want, got = results
    for name, _ in script:
        (wc, _, wb), (gc, _, gb) = want[name], got[name]
        assert gc == wc, (name, gc, wc, gb)
        assert sorted(gb) == sorted(wb), name
        if gc == 200:
            assert gb["predictions"] == wb["predictions"], name
            assert gb["rows"] == wb["rows"]
            if "outputs" in wb:
                np.testing.assert_allclose(
                    np.asarray(gb["outputs"]), np.asarray(wb["outputs"]),
                    **JAX_TOL)
        else:
            assert gb["error"] == wb["error"], name
    assert got["flat_raw"][0] == 200 and got["not_json"][0] == 400
    assert got["extras"][0] == 400


# ---------------------------------------------------------------------------
# pure rules, against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ladder,max_batch", [
    ((3, 5, 64), 8), ((1, 2, 4), 16), ((0, -3, 6, 100), 32), ((), 5),
    ((7,), 7),
])
def test_ladder_buckets_match_jax(ladder, max_batch):
    assert ladder_buckets(ladder, max_batch) == \
        jax_server.ladder_buckets(ladder, max_batch)


@pytest.mark.parametrize("hist,max_batch,rungs", [
    ({}, 16, 4), ({1: 10, 2: 5, 7: 3, 16: 1}, 16, 4),
    ({3: 100}, 64, 4), ({1: 1, 50: 1, 64: 2}, 64, 2),
    ({5: 4, 9: 4, 13: 4}, 20, 3),
])
def test_ladder_from_histogram_matches_jax(hist, max_batch, rungs):
    assert ladder_from_histogram(hist, max_batch, rungs=rungs) == \
        jax_server.ladder_from_histogram(hist, max_batch, rungs=rungs)


@pytest.mark.parametrize("max_batch", [1, 5, 8, 64, 100])
def test_bucket_sizes_match_jax(max_batch):
    assert bucket_sizes(max_batch) == jax_server.bucket_sizes(max_batch)


def test_retry_after_known_backlog_matches_jax():
    """A stopped Server with a known drain rate: the advice for a given
    backlog is the same arithmetic in both packages."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JT
    from cxxnet_tpu.utils.config import parse_config_string
    jt = JT()
    for k, v in parse_config_string(MLP_CFG):
        jt.set_param(k, v)
    jt.init_model()
    js = JaxServer(jt, max_batch=8)
    ps = Server(make_trainer(), max_batch=8, device="cpu")
    assert ps._retry_after(100) == js._retry_after(100) \
        == RETRY_AFTER_COLD_S == jax_server.RETRY_AFTER_COLD_S
    for rate in (1.0, 37.5, 1e4, 1e-9, float("inf")):
        js._drain_rate = ps._drain_rate = rate
        for backlog in (0, 1, 64, 5000):
            assert ps._retry_after(backlog) == js._retry_after(backlog)


def _checkpoint_files(tmp_path, tr):
    good = str(tmp_path / "good.model")
    _save(tr, good)
    blob = _read(good, "rb")
    files = {"good": good}
    for name, data in (("half", blob[:len(blob) // 2]),
                       ("no_trailer", blob[:-16]),
                       ("flipped", blob[:100] + bytes([blob[100] ^ 1])
                        + blob[101:]),
                       ("empty", b""), ("short", blob[:4]),
                       ("foreign", b"NOTMODEL" + blob[8:])):
        p = str(tmp_path / f"{name}.model")
        with open(p, "wb") as f:
            f.write(data)
        files[name] = p
    return files


def test_validate_file_verdicts_match_jax(tmp_path):
    files = _checkpoint_files(tmp_path, make_trainer())
    for name, path in files.items():
        want = jax_ckpt.validate_file(path)
        got = checkpoint.validate_file(path)
        assert got == want, name
    assert checkpoint.validate_file(files["good"]) is None
    assert checkpoint.validate_file(files["half"]) is not None
    assert checkpoint.validate_file(str(tmp_path / "missing")) == \
        jax_ckpt.validate_file(str(tmp_path / "missing"))


@pytest.mark.parametrize("torn", [False, True])
def test_publish_meta_sidecar_bytes_match_jax(tmp_path, torn):
    tr = make_trainer()
    src = str(tmp_path / "a.model")
    _save(tr, src)
    outs = []
    for ck, fl, tag in ((jax_ckpt, jax_fault, "j"), (checkpoint, fault,
                                                     "p")):
        fl.clear()
        if torn:
            fl.inject("swap_torn_checkpoint", "corrupt")
        pub = str(tmp_path / f"{tag}.model")
        ck.publish_model(src, pub)
        fl.clear()
        with open(pub + ".meta", "rb") as f, open(pub, "rb") as g:
            outs.append((f.read(), g.read(), ck.read_publish_meta(pub),
                         ck.validate_file(pub)))
    assert outs[1] == outs[0]
    meta = outs[1][2]
    assert meta["src"] == os.path.abspath(src) and meta["torn"] is torn
    assert (outs[1][3] is None) is (not torn)
    assert checkpoint.read_publish_meta(str(tmp_path / "none")) is None


@pytest.mark.parametrize("key,val", [
    ("serve_port", "70000"), ("serve_port", "-1"),
    ("serve_queue_limit", "-1"), ("serve_deadline_ms", "-0.5"),
    ("serve_shed_clear_ms", "-1"), ("swap_poll_ms", "0"),
    ("swap_canary_frac", "1.5"), ("swap_canary_window", "0"),
    ("serve_conn_timeout_ms", "-1"), ("serve_max_conns", "-2"),
    ("serve_max_body_bytes", "-1"), ("serve_bucket_ladder", "4,2"),
    ("serve_bucket_ladder", "0,8"),
])
def test_trainer_rejects_bad_serve_values_as_jax(key, val):
    with pytest.raises(ValueError) as want:
        JaxTrainer().set_param(key, val)
    with pytest.raises(ValueError) as got:
        NetTrainer(device="cpu").set_param(key, val)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("key,val,attr,want", [
    ("serve_port", "8080", "serve_port", 8080),
    ("serve_queue_limit", "256", "serve_queue_limit", 256),
    ("serve_deadline_ms", "250", "serve_deadline_ms", 250.0),
    ("swap_watch", "m.model", "swap_watch", "m.model"),
    ("swap_canary_frac", "0.25", "swap_canary_frac", 0.25),
    ("serve_bucket_ladder", "1,4,16", "serve_ladder", [1, 4, 16]),
    ("telemetry_steps", "0", "telemetry_steps", 0),
])
def test_trainer_takes_serve_values_as_jax(key, val, attr, want):
    jt, pt = JaxTrainer(), NetTrainer(device="cpu")
    jt.set_param(key, val)
    pt.set_param(key, val)
    assert getattr(pt, attr) == getattr(jt, attr) == want


def test_ladder_key_shapes_the_buckets():
    tr = make_trainer("serve_bucket_ladder = 3,5,40\n")
    srv = Server(tr, max_batch=8, device="cpu")
    assert srv.buckets == (3, 5, 8)


# ---------------------------------------------------------------------------
# backpressure, deadlines, HTTP error paths
# ---------------------------------------------------------------------------
def test_queue_limit_rejects_with_typed_error():
    tr = make_trainer()
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 queue_limit=16, device="cpu")
    srv.warmup()
    _stall_dispatch(64, 0.1)
    srv.start()
    rng = np.random.RandomState(5)
    futs, errs = [], []
    try:
        for _ in range(30):
            try:
                futs.append(srv.submit(req(rng, 4)))
            except QueueFullError as e:
                errs.append(e)
        assert errs and errs[0].retry_after_s > 0
        assert errs[0].queue_depth <= 16
        # the first shed lands before any batch completed: cold clamp
        assert errs[0].retry_after_s == RETRY_AFTER_COLD_S
        for f in futs:
            f.result(timeout=60)
    finally:
        fault.clear()
        stats = srv.stop()
    assert stats["errors"] == 0
    assert stats["shed_requests"] == len(errs)
    assert stats["shed_rows"] == 4 * len(errs)
    reg = telemetry.get().registry
    assert reg.counter("serve.shed_total").value == len(errs)


def test_shed_flips_healthz_503_then_recovers():
    tr = make_trainer()
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=2,
                 queue_limit=8, http_port=0, metrics_host="127.0.0.1",
                 device="cpu")
    srv.shed_clear_ms = 200.0
    srv.warmup()
    _stall_dispatch(32, 0.1)
    srv.start()
    rng = np.random.RandomState(6)
    futs, shed = [], 0
    try:
        url = f"http://127.0.0.1:{srv.metrics_server.port}/healthz"
        for _ in range(30):
            try:
                futs.append(srv.submit(req(rng, 4)))
            except QueueFullError:
                shed += 1
        assert shed > 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 503
        assert "serve_shed" in json.loads(ei.value.read())["reasons"]
        for f in futs:
            f.result(timeout=60)
        fault.clear()
        assert _wait(lambda: telemetry.get().health.ok, 10.0)
        assert urllib.request.urlopen(url, timeout=5).status == 200
    finally:
        srv.stop()


def test_deadline_expires_before_dispatch():
    tr = make_trainer()
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    _stall_dispatch(4, 0.4)
    srv.start()
    rng = np.random.RandomState(7)
    try:
        blocker = srv.submit(req(rng, 8))
        doomed = srv.submit(req(rng, 2), deadline_ms=50)
        with pytest.raises(DeadlineExpiredError):
            doomed.result(timeout=30)
        blocker.result(timeout=30)
    finally:
        fault.clear()
        stats = srv.stop()
    assert stats["deadline_expired"] == 1 and stats["errors"] == 0
    assert stats["rows"] - 2 == sum(
        b * n for b, n in stats["buckets"].items()) - stats["padding_rows"]


def test_http_storm_429_deadline_504_and_metrics():
    tr = make_trainer()
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 http_port=0, queue_limit=4, metrics_host="127.0.0.1",
                 device="cpu")
    srv.warmup()
    _stall_dispatch(64, 0.3)
    srv.start()
    results = []
    try:
        port = srv.metrics_server.port
        rng = np.random.RandomState(9)
        payload = {"data": req(rng, 4).reshape(4, -1).tolist()}
        lock = threading.Lock()

        def hammer():
            for _ in range(4):
                r = _post(port, payload, timeout=120)
                with lock:
                    results.append(r)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        codes = [c for c, _, _ in results]
        assert 200 in codes and 429 in codes, codes
        for code, headers, out in results:
            if code == 429:
                assert 1 <= int(headers["Retry-After"]) <= 60
                assert out["retry_after_s"] > 0
                assert out["queue_depth"] <= 4
        # a deadline shorter than the stalled dispatch ahead: 504
        blocker = srv.submit(req(rng, 4))
        # let the replica pop it alone and enter the stalled dispatch
        assert _wait(lambda: srv._queued_rows == 0, 5.0)
        time.sleep(0.05)
        code, _, out = _post(port, {"data": req(rng, 2).reshape(2, -1)
                                    .tolist(), "deadline_ms": 50})
        assert code == 504 and "expired" in out["error"]
        blocker.result(timeout=60)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert validate_exposition(body) == []
        assert "cxxnet_serve_shed_total" in body
    finally:
        fault.clear()
        stats = srv.stop()
    assert stats["errors"] == 0
    assert stats["shed_requests"] == codes.count(429)
    assert stats["deadline_expired"] == 1


def _read_until_eof(sock, timeout=10.0):
    sock.settimeout(timeout)
    buf = b""
    try:
        while True:
            chunk = sock.recv(4096)
            if not chunk:
                break
            buf += chunk
    except OSError:
        pass
    return buf


def test_oversized_body_413_then_serves_normally():
    srv = Server(make_trainer(), max_batch=8, max_wait_ms=1.0, replicas=1,
                 http_port=0, max_body_bytes=512, device="cpu")
    srv.warmup()
    srv.start()
    rng = np.random.RandomState(26)
    try:
        port = srv.metrics_server.port
        code, _, out = _post(port, {"data": req(rng, 16).reshape(16, -1)
                                    .tolist()})
        assert code == 413 and out["max_body_bytes"] == 512
        code, _, out = _post(port, {"data": [[0.0] * 36]})
        assert code == 200 and out["rows"] == 1
        assert srv.stats()["conn_oversized"] == 1
    finally:
        srv.stop()


def test_slow_client_cut_while_service_continues():
    srv = Server(make_trainer(), max_batch=8, max_wait_ms=1.0, replicas=1,
                 http_port=0, conn_timeout_ms=400.0, device="cpu")
    srv.warmup()
    srv.start()
    rng = np.random.RandomState(25)
    try:
        port = srv.metrics_server.port
        s1 = socket.create_connection(("127.0.0.1", port), timeout=10)
        s1.sendall(b"POST /predict HTTP/1.0\r\nContent-")
        s2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        s2.sendall(b"POST /predict HTTP/1.0\r\n"
                   b"Content-Length: 1000\r\n\r\nxx")
        t0 = time.monotonic()
        code, _, out = _post(port, {"data": req(rng, 2).reshape(2, -1)
                                    .tolist()})
        assert code == 200 and out["rows"] == 2
        body_resp = _read_until_eof(s2)
        _read_until_eof(s1)
        assert time.monotonic() - t0 < 8.0
        s1.close()
        s2.close()
        assert b"408" in body_resp.split(b"\r\n")[0], body_resp[:80]
        assert srv.stats()["conn_timeouts"] >= 2
    finally:
        srv.stop()


def test_accept_gate_503_with_retry_after_then_recovers():
    srv = Server(make_trainer(), max_batch=8, max_wait_ms=1.0, replicas=1,
                 http_port=0, max_conns=1, device="cpu")
    srv.shed_clear_ms = 200.0
    srv.warmup()
    srv.start()
    try:
        port = srv.metrics_server.port
        hold = socket.create_connection(("127.0.0.1", port), timeout=10)
        hold.sendall(b"GET /healthz HTTP/1.0\r\nX-Hold")
        time.sleep(0.3)
        rej = socket.create_connection(("127.0.0.1", port), timeout=10)
        rej.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
        buf = _read_until_eof(rej)
        rej.close()
        assert b"503" in buf.split(b"\r\n")[0], buf[:80]
        assert b"Retry-After: 1" in buf
        ok, reasons = telemetry.get().health.status()
        assert not ok and "serve_conns" in reasons
        hold.close()

        def healthy():
            try:
                return urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz",
                    timeout=5).status == 200
            except (urllib.error.HTTPError, OSError):
                return False
        assert _wait(healthy, 10.0), "conn gate never recovered"
        assert srv.stats()["conn_rejected"] >= 1
    finally:
        srv.stop()


def test_no_http_thread_unless_armed():
    srv = Server(make_trainer(), max_batch=8, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    with srv:
        assert srv.metrics_server is None
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("telemetry-")]


def test_listener_that_cannot_bind_raises():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    port = s.getsockname()[1]
    try:
        srv = Server(make_trainer(), max_batch=8, http_port=port,
                     metrics_host="127.0.0.1", device="cpu")
        with pytest.raises(OSError):
            srv.start()
    finally:
        s.close()


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------
def _cold(tr, probe):
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    with srv:
        return srv.submit(probe).result(timeout=60)


def test_hot_swap_mid_storm_zero_drops_bitwise_switch(tmp_path):
    tr_old = make_trainer()
    tr_new = make_trainer("seed = 99\n")
    ck = str(tmp_path / "new.model")
    _save(tr_new, ck)
    srv = Server(tr_old, max_batch=8, max_wait_ms=1.0, replicas=2,
                 device="cpu")
    srv.warmup()
    n_warm = srv.executable_cache_size()
    assert n_warm == len(srv.buckets)
    old_slot = srv._slot
    old_bits = {lk: {pn: t.clone() for pn, t in d.items()}
                for lk, d in old_slot.cparams.items()}
    srv.start()
    rng = np.random.RandomState(11)
    probe = req(rng, 5)
    try:
        old_ref = srv.submit(probe).result(timeout=60)
        sizes = [1, 3, 8, 2, 5, 7] * 4
        data = [req(rng, s) for s in sizes]
        futs = [srv.submit(d) for d in data]
        assert srv.swap_to(ck) is True
        outs = [f.result(timeout=120) for f in futs]
        new_out = srv.submit(probe).result(timeout=60)
        stats = srv.stats()
        assert stats["errors"] == 0 and stats["swaps"] == 1
        assert srv.executable_cache_size() == n_warm
    finally:
        srv.stop()
    cold_ref = _cold(tr_new, probe)
    assert not np.array_equal(old_ref, new_out)
    assert np.array_equal(new_out, cold_ref)
    # every in-flight answer is the old or the new weights' rows (to
    # float32 rounding: a request shares its bucket with others, and
    # the cold reference runs it alone), and the switch happened once
    old_rows = [_cold(make_trainer(), d) for d in data]
    new_rows = [_cold(tr_new, d) for d in data]
    side = []
    for o, a, b in zip(outs, old_rows, new_rows):
        assert not np.allclose(a, b, **SELF_TOL)
        is_old = np.allclose(o, a, **SELF_TOL)
        assert is_old or np.allclose(o, b, **SELF_TOL)
        side.append(0 if is_old else 1)
    assert side == sorted(side)
    # the old slot was never written in place
    for lk, d in old_slot.cparams.items():
        for pn, t in d.items():
            assert np.array_equal(t.numpy(), old_bits[lk][pn].numpy())
    assert telemetry.get().registry.counter("serve.swaps").value == 1


def test_torn_and_mismatched_checkpoints_rejected_keep_serving(tmp_path):
    tr = make_trainer()
    files = _checkpoint_files(tmp_path, make_trainer("seed = 99\n"))
    wide = NetTrainer(cfg=MLP_CFG.replace("nhidden = 16", "nhidden = 12"))
    wide.init_model()
    mism = str(tmp_path / "wide.model")
    _save(wide, mism)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    srv.start()
    probe = req(np.random.RandomState(12), 4)
    try:
        before = srv.submit(probe).result(timeout=60)
        for path in (files["half"], files["flipped"], mism):
            assert srv.swap_to(path) is False
        after = srv.submit(probe).result(timeout=60)
        stats = srv.stats()
    finally:
        srv.stop()
    assert np.array_equal(before, after)
    assert stats["swaps"] == 0 and stats["swap_rejected"] == 3
    assert stats["errors"] == 0


def test_swap_watcher_picks_up_published_checkpoint(tmp_path):
    tr = make_trainer()
    saved = str(tmp_path / "0001.model")
    watch = str(tmp_path / "publish.model")
    _save(make_trainer("seed = 99\n"), saved)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 swap_watch=watch, swap_poll_ms=20.0, device="cpu")
    srv.warmup()
    srv.start()
    probe = req(np.random.RandomState(13), 4)
    try:
        old = srv.submit(probe).result(timeout=60)
        checkpoint.publish_model(saved, watch)
        assert _wait(lambda: srv.stats()["swaps"] >= 1)
        new = srv.submit(probe).result(timeout=60)
        assert not np.array_equal(old, new)
        fault.inject("swap_torn_checkpoint", "corrupt")
        checkpoint.publish_model(saved, watch)
        assert _wait(lambda: srv.stats()["swap_rejected"] >= 1)
        still = srv.submit(probe).result(timeout=60)
        assert np.array_equal(new, still)
        assert srv.stats()["swaps"] == 1
    finally:
        fault.clear()
        srv.stop()


# ---------------------------------------------------------------------------
# canary
# ---------------------------------------------------------------------------
def _perturbed_trainer():
    t = make_trainer()
    w, _ = t.get_weight("fc1", "wmat")
    t.set_weight(w * 1.001, "fc1", "wmat")
    return t


def test_canary_promotes_healthy_candidate_mid_storm(tmp_path):
    tr = make_trainer()
    tr_new = _perturbed_trainer()
    ck = str(tmp_path / "cand.model")
    _save(tr_new, ck)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=2,
                 canary_frac=0.5, canary_window=1.0, device="cpu")
    srv.warmup()
    n_warm = srv.executable_cache_size()
    srv.start()
    rng = np.random.RandomState(21)
    probe = req(rng, 5)
    try:
        old_ref = srv.submit(probe).result(timeout=60)
        assert srv.swap_to(ck) is True
        assert srv.stats()["canary_active"] is True
        futs = []
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            futs.append(srv.submit(req(rng, int(rng.randint(1, 9)))))
            if srv.stats()["canary_promoted"]:
                break
            time.sleep(0.005)
        for f in futs:
            f.result(timeout=120)
        stats = srv.stats()
        assert stats["canary_promoted"] == 1
        assert stats["canary_rolled_back"] == 0 and stats["swaps"] == 1
        assert stats["canary_requests"] > 0 and stats["errors"] == 0
        assert srv.executable_cache_size() == n_warm
        new_out = srv.submit(probe).result(timeout=60)
    finally:
        srv.stop()
    assert not np.array_equal(old_ref, new_out)
    assert np.array_equal(new_out, _cold(tr_new, probe))
    assert telemetry.get().registry.counter(
        "serve.canary_promoted").value == 1


def test_canary_rolls_back_on_divergence(tmp_path):
    tr = make_trainer()
    ck = str(tmp_path / "cand.model")
    _save(_perturbed_trainer(), ck)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=2,
                 canary_frac=0.25, canary_window=1.0, device="cpu")
    srv.warmup()
    srv.start()
    rng = np.random.RandomState(22)
    probe = req(rng, 4)
    inc_slot = srv._slot
    try:
        before = srv.submit(probe).result(timeout=60)
        for i in range(50):
            fault.inject("canary_divergence", "corrupt", at=i + 1)
        assert srv.swap_to(ck) is True
        futs = []
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            futs.append(srv.submit(req(rng, 3)))
            if srv.stats()["canary_rolled_back"]:
                break
            time.sleep(0.005)
        for f in futs:
            f.result(timeout=120)
        stats = srv.stats()
        assert stats["canary_rolled_back"] == 1
        assert stats["swaps"] == 0 and stats["canary_promoted"] == 0
        assert stats["errors"] == 0
        after = srv.submit(probe).result(timeout=60)
        assert np.array_equal(before, after)
        assert srv._slot is inc_slot
    finally:
        fault.clear()
        srv.stop()


def test_canary_judge_crash_fails_safe(tmp_path):
    tr = make_trainer()
    ck = str(tmp_path / "cand.model")
    _save(_perturbed_trainer(), ck)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 canary_frac=0.5, canary_window=30.0, device="cpu")
    srv.warmup()
    srv.start()
    probe = req(np.random.RandomState(23), 4)
    try:
        before = srv.submit(probe).result(timeout=60)
        fault.inject("canary_judge_error", "crash")
        assert srv.swap_to(ck) is True
        assert _wait(lambda: srv.stats()["canary_rolled_back"] == 1)
        stats = srv.stats()
        assert stats["swaps"] == 0 and stats["canary_active"] is False
        assert np.array_equal(before, srv.submit(probe).result(timeout=60))
    finally:
        fault.clear()
        srv.stop()


def test_unarmed_swap_is_direct_no_judge_thread(tmp_path):
    tr = make_trainer()
    ck = str(tmp_path / "cand.model")
    _save(_perturbed_trainer(), ck)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    with srv:
        assert srv.swap_to(ck) is True
        stats = srv.stats()
        assert stats["swaps"] == 1 and stats["canary_active"] is False
        assert not [t for t in threading.enumerate()
                    if t.name == "serve-canary-judge"]


# ---------------------------------------------------------------------------
# drain and the CLI
# ---------------------------------------------------------------------------
def test_drain_resolves_every_queued_future():
    tr = make_trainer()
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=1,
                 device="cpu")
    srv.warmup()
    _stall_dispatch(16, 0.2)
    srv.start()
    rng = np.random.RandomState(27)
    futs = [srv.submit(req(rng, 2)) for _ in range(10)]
    state = {}
    th = threading.Thread(target=lambda: state.update(stats=srv.drain()))
    th.start()
    try:
        assert _wait(lambda: "serve_drain" in
                     telemetry.get().health.status()[1], 5.0)
        with pytest.raises(RuntimeError):
            srv.submit(req(rng, 1))
    finally:
        th.join(timeout=120)
        fault.clear()
    for f in futs:
        assert f.result(timeout=1).shape == (2, 3)
    assert state["stats"]["errors"] == 0
    assert telemetry.get().health.ok


def test_cli_serve_sigterm_drains(tmp_path, capsys):
    """SIGTERM during task = serve stops admission, drains every
    admitted request into the output file, and exits 0; the lines are
    task = pred's first lines."""
    from test_torch_serve import CLI_CONF, write_mnist
    d = str(tmp_path)
    write_mnist(d, 200, 1)
    conf = os.path.join(d, "serve.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d))
    pt = NetTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d))
    pt.init_model()
    model = os.path.join(d, "0001.model")
    _save(pt, model)
    pred = os.path.join(d, "pred.txt")
    assert port_main.main([conf, "task=pred", f"model_in={model}",
                           f"pred={pred}"]) == 0
    want = _read(pred).splitlines()
    old = signal.signal(signal.SIGTERM, lambda s, f: None)
    stop = threading.Event()
    n0 = telemetry.get().registry.counter("serve.requests").value

    def killer():
        while not stop.is_set():
            n = telemetry.get().registry.counter("serve.requests").value
            if n - n0 >= 8:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.01)

    _stall_dispatch(2000, 0.02)
    th = threading.Thread(target=killer, daemon=True)
    th.start()
    out = os.path.join(d, "serve.txt")
    try:
        rc = port_main.main([conf, "task=serve", f"model_in={model}",
                             f"pred={out}", "serve_rows=1",
                             "serve_max_batch=8"])
    finally:
        stop.set()
        th.join(timeout=10)
        fault.clear()
        signal.signal(signal.SIGTERM, old)
    assert rc == 0
    text = capsys.readouterr().out
    assert "serve: SIGTERM - draining queued requests" in text
    lines = _read(out).splitlines()
    assert 0 < len(lines) < 200
    assert lines == want[:len(lines)]
    # every admitted request is in the file
    import re
    m = re.search(r"serve: (\d+) requests \((\d+) rows\)", text)
    assert int(m.group(2)) == len(lines)


def test_cli_serve_port_answers_predict(tmp_path, capsys):
    """task = serve with serve_port and metrics_port: /predict and
    /metrics answer while the run is live, and the output file is
    task = pred's."""
    from test_torch_serve import CLI_CONF, write_mnist
    d = str(tmp_path)
    images = write_mnist(d, 100, 2)
    conf = os.path.join(d, "serve.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(out=os.path.join(d, "unused.txt"), d=d))
    pt = NetTrainer(cfg=CLI_CONF.format(out="unused.txt", d=d))
    pt.init_model()
    model = os.path.join(d, "0001.model")
    _save(pt, model)
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    got = {}
    stop = threading.Event()

    def poll():
        while not stop.wait(0.01):
            try:
                if "predict" not in got:
                    got["predict"] = _post(
                        ports[0], {"data": images[:2].reshape(2, -1)
                                   .tolist()}, timeout=5)
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{ports[1]}/metrics",
                    timeout=2).read().decode()
                if "cxxnet_serve_requests_total" in body:
                    got["metrics"] = body
            except (OSError, ValueError):
                continue

    _stall_dispatch(2000, 0.002)
    th = threading.Thread(target=poll, daemon=True)
    th.start()
    out = os.path.join(d, "serve.txt")
    try:
        assert port_main.main([conf, "task=serve", f"model_in={model}",
                               f"pred={out}", "serve_rows=0",
                               f"serve_port={ports[0]}",
                               f"metrics_port={ports[1]}",
                               "metrics_host=127.0.0.1"]) == 0
    finally:
        stop.set()
        th.join(timeout=10)
        fault.clear()
    capsys.readouterr()
    code, _, body = got["predict"]
    assert code == 200 and body["rows"] == 2
    assert body["predictions"] == [float(v) for v in pt.predict(
        DataBatch(data=images[:2], label=np.zeros((2, 1), np.float32)))]
    assert validate_exposition(got["metrics"]) == []
    assert len(_read(out).splitlines()) == 100


def test_predictions_from_rows_matches_predict():
    tr = make_trainer()
    data = req(np.random.RandomState(3), 6)
    srv = Server(tr, max_batch=8, device="cpu")
    srv.warmup()
    with srv:
        rows = srv.submit(data).result(timeout=60)
    np.testing.assert_array_equal(
        predictions_from_rows(rows),
        tr.predict(DataBatch(data=data, label=np.zeros((6, 1),
                                                       np.float32))))


def test_calibrated_swap_rewarms_while_serving(tmp_path):
    """A swap onto a Server whose graph froze int8 calibration retires
    it (the frozen scales describe the old weights), as the JAX Server
    does: the canary is bypassed, the new graph is warmed on a lane of
    its own while the replicas keep serving, and the answers are the
    new weights' through the uncalibrated graph."""
    conf = NARROW_ALEXNET + "graph_passes = quantize_int8\n"
    tr = NetTrainer(cfg=conf, device="cpu")
    tr.init_model()
    calib = alex_rows(8, 40)
    tr.calibrate_graph_passes(DataBatch(data=calib, label=np.zeros(
        (8, 1), np.float32)))
    new = NetTrainer(cfg=conf.replace("seed = 3", "seed = 9"), device="cpu")
    new.init_model()
    ck = str(tmp_path / "new.model")
    _save(new, ck)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=2,
                 canary_frac=0.5, device="cpu")
    srv.warmup()
    n_warm = srv.executable_cache_size()
    probe = alex_rows(3, 41)
    with srv:
        futs = [srv.submit(alex_rows(n, 42 + n)) for n in (1, 5, 8, 2)]
        assert srv.swap_to(ck) is True
        for f in futs:
            assert np.all(np.isfinite(f.result(timeout=120)))
        got = srv.submit(probe).result(timeout=120)
        stats = srv.stats()
    assert stats["swaps"] == 1 and stats["errors"] == 0
    assert stats["canary_active"] is False and stats["canary_requests"] == 0
    assert srv.executable_cache_size() == 2 * n_warm
    assert tr.passes_need_calibration()
    flt = NetTrainer(cfg=NARROW_ALEXNET.replace("seed = 3", "seed = 9"),
                     device="cpu")
    flt.init_model()
    want = flt.predict_dist(DataBatch(data=probe, label=np.zeros(
        (3, 1), np.float32)))
    np.testing.assert_allclose(got, want, **SELF_TOL)


def test_stress_many_submitters_swaps_and_stats_agree(tmp_path):
    """More submitter threads than cores against 4 replicas, with two
    swaps and a shortened switch interval: every future resolves to
    rows of one of the three weight sets, and the request, row and
    batch counts agree with what was submitted and dispatched."""
    import sys
    tr = make_trainer()
    cks = []
    for seed in (99, 100):
        ck = str(tmp_path / f"w{seed}.model")
        _save(make_trainer(f"seed = {seed}\n"), ck)
        cks.append(ck)
    srv = Server(tr, max_batch=8, max_wait_ms=0.5, replicas=4,
                 device="cpu")
    srv.warmup()
    n_threads = 2 * (os.cpu_count() or 4) + 2
    per_thread = 12
    results, errors = [], []
    lock = threading.Lock()

    def client(k):
        rng = np.random.RandomState(100 + k)
        try:
            for _ in range(per_thread):
                d = req(rng, int(rng.randint(1, 12)))
                out = srv.submit(d).result(timeout=120)
                with lock:
                    results.append((d, out))
        except BaseException as e:  # re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with srv:
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for ck in cks:
                time.sleep(0.05)
                assert srv.swap_to(ck) is True
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            stats = srv.stats()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert len(results) == n_threads * per_thread
    weights = [make_trainer()] + [make_trainer(f"seed = {s}\n")
                                  for s in (99, 100)]
    for d, out in results[::7]:
        assert any(np.allclose(out, _cold(w, d), **SELF_TOL)
                   for w in weights)
    rows = sum(d.shape[0] for d, _ in results)
    assert stats["requests"] == len(results) and stats["rows"] == rows
    assert stats["errors"] == 0 and stats["swaps"] == 2
    dispatched = sum(b * n for b, n in stats["buckets"].items())
    assert dispatched - stats["padding_rows"] == rows
