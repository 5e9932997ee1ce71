"""The port's runtime lock audit (cxxnet_tpu_torch/analysis/
lock_audit.py), held to the cases of tests/test_lock_audit.py: shim
transparency, lock-order cycle detection (the seeded ABBA fixture MUST
fail and a clean run MUST stay silent), contention/held accounting
through the Condition release-save path, the dispatch-boundary check on
the port's boundaries (card syncs and tensor reads), the real scenarios
on the CPU, and the CLI gate's exit codes.
"""

import json
import os
import queue
import subprocess
import sys
import threading
import time

import pytest

import torch

from cxxnet_tpu_torch.analysis.lock_audit import (
    SCENARIOS, LockAuditor, run_lock_audit)

REPO = __file__.rsplit("/tests/", 1)[0]


# ---------------------------------------------------------------------------
# shim transparency
# ---------------------------------------------------------------------------
def test_shim_wraps_and_restores():
    real_lock, real_rlock = threading.Lock, threading.RLock
    aud = LockAuditor()
    with aud.installed():
        assert threading.Lock is not real_lock
        lk = threading.Lock()
        with lk:
            assert lk.locked()
        assert not lk.locked()
        rl = threading.RLock()
        with rl:
            with rl:  # reentrant
                pass
        ev = threading.Event()
        ev.set()
        assert ev.wait(0.1)
        q = queue.Queue(maxsize=2)
        q.put("x")
        assert q.get() == "x"
        with pytest.raises(queue.Empty):
            q.get(timeout=0.01)
    assert threading.Lock is real_lock
    assert threading.RLock is real_rlock
    rep = aud.report()
    assert rep["acquisitions"] > 0
    assert rep["cycle"] is None


def test_reentrant_rlock_is_one_hold_no_self_edge():
    aud = LockAuditor()
    with aud.installed():
        rl = threading.RLock()
        with rl:
            with rl:
                pass
    rep = aud.report()
    assert rep["edges"] == []
    site = [s for s in rep["contended"] if s["kind"] == "RLock"]
    assert site and site[0]["acquisitions"] == 1


def test_locks_created_before_install_not_audited():
    lk = threading.Lock()
    aud = LockAuditor()
    with aud.installed():
        with lk:
            pass
    assert aud.report()["acquisitions"] == 0


# ---------------------------------------------------------------------------
# the order graph
# ---------------------------------------------------------------------------
def _run_thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()


def test_consistent_order_is_acyclic():
    aud = LockAuditor()
    with aud.installed():
        a, b = threading.Lock(), threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        _run_thread(ab)
        _run_thread(ab)
    rep = aud.report()
    assert rep["cycle"] is None
    assert any(e["count"] == 2 for e in rep["edges"])


def test_abba_inversion_detected_without_deadlock():
    # the two orders run SEQUENTIALLY - the graph does not need a
    # real race to convict, only the per-thread sequences
    aud = LockAuditor()
    with aud.installed():
        a, b = threading.Lock(), threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        _run_thread(ab)
        _run_thread(ba)
    cycle = aud.report()["cycle"]
    assert cycle is not None
    assert cycle[0] == cycle[-1]
    assert len(set(cycle)) == 2


def test_contention_and_held_accounting():
    aud = LockAuditor()
    with aud.installed():
        lk = threading.Lock()

        def holder():
            with lk:
                time.sleep(0.15)

        t = threading.Thread(target=holder, daemon=True)
        t.start()
        time.sleep(0.03)  # let the holder win the lock
        with lk:          # contended acquire: waits ~0.12s
            pass
        t.join(timeout=5.0)
    rep = aud.report()
    site = rep["contended"][0]
    assert site["contended"] >= 1
    assert site["wait_max_ms"] > 50.0
    assert rep["max_held_ms"] > 100.0


def test_condition_wait_releases_the_hold():
    # a consumer parked on an empty queue must NOT count as holding
    # the queue mutex for the park duration (the _release_save path)
    aud = LockAuditor()
    with aud.installed():
        q = queue.Queue()

        def consumer():
            q.get(timeout=0.6)

        t = threading.Thread(target=consumer, daemon=True)
        t.start()
        time.sleep(0.45)
        q.put("late")
        t.join(timeout=5.0)
    assert aud.report()["max_held_ms"] < 300.0


# ---------------------------------------------------------------------------
# dispatch-boundary check
# ---------------------------------------------------------------------------
def test_boundary_flags_held_lock_and_dedupes():
    aud = LockAuditor()
    with aud.installed():
        lk = threading.Lock()
        aud.boundary("torch.cuda.synchronize")  # nothing held: clean
        with lk:
            aud.boundary("torch.cuda.synchronize")
            aud.boundary("torch.cuda.synchronize")  # deduped
    rep = aud.report()
    assert len(rep["boundary_violations"]) == 1
    v = rep["boundary_violations"][0]
    assert v["boundary"] == "torch.cuda.synchronize"
    assert v["locks"]


def test_torch_boundaries_patched_during_install():
    real = {n: getattr(torch.Tensor, n)
            for n in ("item", "cpu", "tolist", "numpy")}
    real_sync = (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
                 torch.cuda.Event.synchronize)
    aud = LockAuditor()
    with aud.installed():
        assert torch.Tensor.cpu is not real["cpu"]
        assert torch.cuda.synchronize is not real_sync[0]
        lk = threading.Lock()
        with lk:
            torch.zeros(2).sum().item()
    for n, fn in real.items():
        assert getattr(torch.Tensor, n) is fn
    assert (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
            torch.cuda.Event.synchronize) == real_sync
    v = aud.report()["boundary_violations"]
    assert [b["boundary"] for b in v] == ["Tensor.item"]


# ---------------------------------------------------------------------------
# the real scenarios + the driver
# ---------------------------------------------------------------------------
def test_prefetch_round_scenario_clean():
    rep = run_lock_audit(scenarios=("prefetch-round",), device="cpu")
    assert rep["failed"] == 0, rep["checks"]
    assert rep["cycle"] is None
    assert rep["acquisitions"] > 0
    assert any("prefetch" in s["site"] for s in rep["contended"])


def test_watchdog_stall_scenario_clean():
    rep = run_lock_audit(scenarios=("watchdog-stall",), device="cpu")
    assert rep["failed"] == 0, rep["checks"]
    checks = {c["check"]: c["ok"] for c in rep["checks"]}
    assert checks["stall-dumped"] and checks["recovered"]


def test_serve_storm_scenario_clean():
    rep = run_lock_audit(scenarios=("serve-storm",), device="cpu")
    assert rep["failed"] == 0, rep["checks"]
    assert rep["cycle"] is None
    # the server's condition and future events are in the audit
    assert any("serve/server.py" in s["site"]
               for s in rep["contended"]), rep["contended"]


def test_seeded_inversion_fails_the_audit():
    rep = run_lock_audit(scenarios=("prefetch-round",),
                         seed_inversion=True, device="cpu")
    assert rep["failed"] >= 1
    assert rep["cycle"] is not None
    bad = [c for c in rep["checks"] if not c["ok"]]
    assert any(c["check"] == "acyclic" for c in bad)


def test_registry_gauges_wired():
    from cxxnet_tpu_torch import telemetry
    run_lock_audit(scenarios=("prefetch-round",), device="cpu")
    g = telemetry.get().registry.get("lock.audit.max_held_ms")
    assert g is not None and g.value >= 0.0
    assert telemetry.get().registry.get("lock.audit.sites") is not None


def test_unknown_scenario_rejected():
    with pytest.raises(ValueError, match="no-such-scenario"):
        run_lock_audit(scenarios=("no-such-scenario",), device="cpu")
    assert set(SCENARIOS) == {
        "prefetch-round", "watchdog-stall", "serve-storm",
        "native-decode", "elastic-coordinator"}


def test_native_decode_scenario_clean_on_the_cpu():
    """On the CPU the decoder's reader is its plain version (a decode
    pool); two passes read every record."""
    rep = run_lock_audit(scenarios=("native-decode",), device="cpu")
    assert rep["failed"] == 0, rep["checks"]
    assert any("io/native.py" in s["site"] for s in rep["contended"])
    # nothing of the JAX audit is deferred any more
    assert "deferred" not in rep


def test_elastic_coordinator_scenario_clean_on_the_cpu():
    """The JAX audit's elastic-coordinator scenario on the port's
    coordinator: two members' heartbeat threads and training threads,
    three barriers with one leader and its publishes, then a conviction;
    the coordinator's locks enter the audited order graph."""
    rep = run_lock_audit(scenarios=("elastic-coordinator",), device="cpu")
    assert rep["failed"] == 0, rep["checks"]
    got = {c["check"] for c in rep["checks"]
           if c["target"] == "elastic-coordinator"}
    assert got == {"barriers-completed", "single-leader", "published",
                   "lease-renewed", "conviction-raised"}
    assert any("parallel/coordinator.py" in s["site"]
               for s in rep["contended"])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_lock_audit(scenarios=("prefetch-round",))


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.analysis", "--dev", "cpu",
         *args],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)


def test_cli_clean_run_exits_zero(tmp_path):
    report = tmp_path / "lock.json"
    r = _cli("--lock-audit",
             "--lock-audit-scenarios", "prefetch-round",
             "--json", str(report))
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(report.read_text())["lock_audit"]
    assert rep["failed"] == 0 and rep["cycle"] is None
    assert "lock-audit:" in r.stdout


def test_cli_seeded_inversion_exits_nonzero(tmp_path):
    report = tmp_path / "seeded.json"
    r = _cli("--lock-audit",
             "--lock-audit-scenarios", "prefetch-round",
             "--seed-inversion", "--json", str(report))
    assert r.returncode == 1, r.stdout + r.stderr
    rep = json.loads(report.read_text())["lock_audit"]
    assert rep["cycle"] is not None
    assert "[FAIL] lock-order: acyclic" in r.stdout


def test_cli_usage_errors():
    r = _cli("--seed-inversion")
    assert r.returncode == 2
    r = _cli("--lock-audit", "--lock-audit-scenarios", "bogus")
    assert r.returncode == 2
    assert "bogus" in r.stdout
