"""Elastic pod training in the port (parallel/coordinator.py,
parallel/elastic.py, the rank-scoped fault modes, the CLI's barrier and
leader-only checkpoint), held to the JAX package on the CPU.

- the JAX package's unit cases (tests/test_elastic.py) against the
  port: the control plane's records and fake-clock leases, the
  barrier / election / publish / conviction protocol across threads,
  the lease heartbeat, current_rank and the kill_rank / hang_rank /
  delay_collective modes (by subprocess), read_membership's bounded
  retry, classify_lost, the workers' command lines and the
  self-convict hook;
- classify_lost and _worker_argv against the JAX functions over one
  table of cases (the command lines name each package's own modules);
- one coord_dir shared by a JAX Coordinator and a port Coordinator: one
  barrier, one leader, one publish, each package reading the other's
  records;
- the trainer's `collective` fault point: one hit a dispatched step,
  one a fused chunk;
- e2e, the JAX test's rejoin scenario (`collective:kill_rank=1@3`,
  elastic_respawn = 1) as a JAX pod and as a port pod side by side,
  both started from one JAX-written 0000.model (their RNGs never
  agree): the same generations and publishers, the eval lines within
  1e-6 and the final checkpoints within rtol 1e-5 / atol 1e-6.
"""

import glob
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cxxnet_tpu.parallel import coordinator as jax_coord
from cxxnet_tpu.parallel import elastic as jax_elastic
from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.coordinator import (BarrierResult,
                                                   ControlPlane, Coordinator,
                                                   PodReshapeRequired,
                                                   file_sha256)
from cxxnet_tpu_torch.parallel.elastic import (ElasticPod, _self_convict,
                                               classify_lost)
from cxxnet_tpu_torch.utils import fault
from cxxnet_tpu_torch.utils.config import ConfigError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_plane_lease_freshness_fake_clock(tmp_path):
    clock = FakeClock()
    plane = ControlPlane(str(tmp_path), clock=clock)
    plane.write_lease(0, generation=0)
    assert plane.lease_fresh(0, lease_secs=10.0)
    assert plane.live_members([0, 1], lease_secs=10.0) == [0]
    clock.t += 9.0
    assert plane.lease_fresh(0, lease_secs=10.0)
    clock.t += 2.0   # 11 s > 10 s: stale
    assert not plane.lease_fresh(0, lease_secs=10.0)
    assert plane.live_members([0, 1], lease_secs=10.0) == []


def test_plane_garbage_record_reads_as_absent(tmp_path):
    plane = ControlPlane(str(tmp_path))
    assert plane.read_manifest() is None
    with open(plane.manifest_path(), "w") as f:
        f.write('{"torn": ')
    assert plane.read_manifest() is None   # not a crash


def test_plane_generation_record_roundtrip(tmp_path):
    plane = ControlPlane(str(tmp_path))
    plane.write_generation(2, [3, 1])
    rec = plane.read_generation()
    assert rec["generation"] == 2
    assert rec["members"] == [1, 3]


# ---------------------------------------------------------------------------
# coordinator: barrier / election / publish / conviction
# ---------------------------------------------------------------------------
def test_two_member_barrier_elects_single_leader(tmp_path):
    plane = ControlPlane(str(tmp_path))
    c0 = Coordinator(plane, 0, [0, 1], barrier_secs=10.0,
                     lease_secs=5.0, poll_secs=0.01)
    c1 = Coordinator(plane, 1, [0, 1], barrier_secs=10.0,
                     lease_secs=5.0, poll_secs=0.01)
    results = {}

    def run(c):
        results[c.member] = c.barrier(1)

    with c0, c1:
        t = threading.Thread(target=run, args=(c1,), daemon=True)
        t.start()
        run(c0)
        t.join(timeout=10.0)
    r0, r1 = results[0], results[1]
    assert r0.leader == r1.leader == 0
    assert r0.is_leader and not r1.is_leader
    assert r0.members == r1.members == [0, 1]
    assert r0.epoch == r1.epoch == 1   # no manifest yet


def test_leader_publish_and_nonleader_publish_refused(tmp_path):
    plane = ControlPlane(str(tmp_path))
    c0 = Coordinator(plane, 0, [0], barrier_secs=2.0, poll_secs=0.01)
    with c0:
        r = c0.barrier(1)
        assert r.is_leader
        blob = tmp_path / "0001.model"
        blob.write_bytes(b"w" * 8)
        rec = c0.publish(r, 1, str(blob), "ab" * 32, 8)
    assert plane.read_manifest() == rec
    assert rec["epoch"] == 1 and rec["writer"] == 0
    fake = BarrierResult(round_no=2, generation=0, members=[0, 1],
                         leader=1, is_leader=False, epoch=2)
    with pytest.raises(RuntimeError, match="leader is 1"):
        c0.publish(fake, 2, str(blob), "cd" * 32, 8)


def test_epoch_increments_across_publishes(tmp_path):
    plane = ControlPlane(str(tmp_path))
    blob = tmp_path / "m.model"
    blob.write_bytes(b"x")
    with Coordinator(plane, 0, [0], barrier_secs=2.0,
                     poll_secs=0.01) as c0:
        for rnd in (1, 2, 3):
            r = c0.barrier(rnd)
            assert r.epoch == rnd
            c0.publish(r, rnd, str(blob), "00" * 32, 1)
    assert plane.read_manifest()["epoch"] == 3


def test_barrier_timeout_convicts_absent_member(tmp_path):
    plane = ControlPlane(str(tmp_path))
    c0 = Coordinator(plane, 0, [0, 1], barrier_secs=0.3,
                     lease_secs=30.0, poll_secs=0.01)
    # member 1 holds a FRESH lease but never arrives: wedged
    plane.write_lease(1, generation=0)
    with c0:
        with pytest.raises(PodReshapeRequired) as ei:
            c0.barrier(1)
    assert ei.value.missing == [1]
    assert ei.value.dead == []
    assert "wedged" in str(ei.value)
    assert plane.convictions([0, 1])[1]["reason"] == "wedged"


def test_barrier_timeout_dead_vs_wedged_classification(tmp_path):
    plane = ControlPlane(str(tmp_path))
    c0 = Coordinator(plane, 0, [0, 1], barrier_secs=0.3,
                     lease_secs=0.05, poll_secs=0.01)
    plane.write_lease(1, generation=0)
    time.sleep(0.1)
    with c0:
        with pytest.raises(PodReshapeRequired) as ei:
            c0.barrier(1)
    assert ei.value.missing == [1]
    assert ei.value.dead == [1]
    assert plane.convictions([0, 1])[1]["reason"] == "dead"


def test_lease_heartbeat_renews(tmp_path):
    plane = ControlPlane(str(tmp_path))
    with Coordinator(plane, 0, [0], lease_secs=0.09,
                     poll_secs=0.01) as c0:
        deadline = time.monotonic() + 5.0
        while c0.renewals < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert c0.renewals >= 2
        assert plane.lease_fresh(0, lease_secs=0.09)


def test_coordinator_telemetry_names():
    """The gauges, counters and beacon the port's coordinator feeds are
    the JAX coordinator's (the same dashboards read both)."""
    import inspect
    pat = re.compile(r"telemetry\.(?:set_gauge|inc|beacon)\(\s*\"([^\"]+)\"")
    got = sorted(set(pat.findall(inspect.getsource(Coordinator))))
    want = sorted(set(pat.findall(inspect.getsource(jax_coord.Coordinator))))
    assert got == want and "coord.barrier" in got


# ---------------------------------------------------------------------------
# one coord_dir, a JAX member and a port member
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("port_member", [0, 1])
def test_jax_and_port_coordinators_share_one_coord_dir(tmp_path,
                                                       port_member):
    """A JAX Coordinator and a port Coordinator barrier in one coord_dir:
    both see the same arrivals and elect one leader, the leader's
    package publishes, and each package's plane reads the other's
    records (manifest, leases, generation, conviction)."""
    d = str(tmp_path)
    jplane, pplane = jax_coord.ControlPlane(d), ControlPlane(d)
    pplane.write_generation(3, [0, 1])
    assert jplane.read_generation()["members"] == [0, 1]
    jm = 1 - port_member
    pc = Coordinator(pplane, port_member, [0, 1], generation=3,
                     barrier_secs=20.0, lease_secs=5.0, poll_secs=0.01)
    jc = jax_coord.Coordinator(jplane, jm, [0, 1], generation=3,
                               barrier_secs=20.0, lease_secs=5.0,
                               poll_secs=0.01)
    results = {}

    def run(c, tag):
        results[tag] = c.barrier(4)

    with pc, jc:
        t = threading.Thread(target=run, args=(jc, "jax"), daemon=True)
        t.start()
        run(pc, "port")
        t.join(timeout=20.0)
        rj, rp = results["jax"], results["port"]
        assert rj.leader == rp.leader == 0
        assert rj.members == rp.members == [0, 1]
        assert rj.epoch == rp.epoch == 1
        assert {rj.is_leader, rp.is_leader} == {True, False}
        blob = tmp_path / "0004.model"
        blob.write_bytes(b"m" * 32)
        sha = jax_coord.file_sha256(str(blob))
        assert sha == file_sha256(str(blob))
        leader, res = (pc, rp) if rp.is_leader else (jc, rj)
        rec = leader.publish(res, 4, str(blob), sha, 32)
        other, ores = (jc, rj) if rp.is_leader else (pc, rp)
        with pytest.raises(RuntimeError, match="leader is 0"):
            other.publish(ores, 4, str(blob), sha, 32)
        assert jplane.read_manifest() == pplane.read_manifest() == rec
        assert rec["writer"] == 0 and rec["generation"] == 3
        assert pplane.lease_fresh(jm, 5.0) and jplane.lease_fresh(
            port_member, 5.0)
    pplane.write_conviction(1, 0, "wedged")
    assert jplane.convictions([0, 1]) == pplane.convictions([0, 1])
    kinds = {(e["who"], e["kind"]) for e in _events(d)}
    for m in (0, 1):
        assert (f"m{m}", "barrier") in kinds
    assert ("m0", "publish") in kinds


def _events(coord_dir):
    out = []
    for path in sorted(glob.glob(os.path.join(coord_dir, "events.*.jsonl"))):
        with open(path) as f:
            out += [json.loads(ln) for ln in f if ln.strip()]
    return out


# ---------------------------------------------------------------------------
# rank-scoped fault modes
# ---------------------------------------------------------------------------
def test_current_rank_member_id_wins_over_worker_rank(monkeypatch):
    monkeypatch.setenv("CXN_WORKER_RANK", "0")
    monkeypatch.setenv("CXN_MEMBER_ID", "2")
    assert fault.current_rank() == 2
    monkeypatch.delenv("CXN_MEMBER_ID")
    assert fault.current_rank() == 0
    monkeypatch.delenv("CXN_WORKER_RANK")
    # no env and no process group: rank 0, and nothing was initialised
    assert fault.current_rank() == 0
    assert not distributed.is_initialized()


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CXN_MEMBER_ID", "CXN_WORKER_RANK", "CXXNET_FAULT")}
    env.update(PYTHONPATH=REPO, **kw)
    return env


def test_kill_rank_fires_only_on_named_rank():
    code = ("from cxxnet_tpu_torch.utils import fault; "
            "fault.fault_point('x'); print('survived')")
    for rank, expect in (("1", fault.KILL_EXIT_CODE), ("0", 0)):
        p = subprocess.run([sys.executable, "-c", code],
                           env=_env(CXXNET_FAULT="x:kill_rank=1",
                                    CXN_WORKER_RANK=rank),
                           cwd=REPO, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == expect, (rank, p.stdout, p.stderr)
        assert ("survived" in p.stdout) == (expect == 0)


def test_kill_rank_names_the_member_not_the_rank():
    """Under the supervisor CXN_MEMBER_ID wins: generation rank 0 of a
    reshaped pod is member 1, and a spec naming member 0 spares it."""
    code = ("from cxxnet_tpu_torch.utils import fault; "
            "fault.fault_point('x'); print('survived')")
    p = subprocess.run([sys.executable, "-c", code],
                       env=_env(CXXNET_FAULT="x:kill_rank=0",
                                CXN_WORKER_RANK="0", CXN_MEMBER_ID="1"),
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and "survived" in p.stdout


def test_delay_collective_rank_scoped(monkeypatch):
    monkeypatch.setenv("CXN_WORKER_RANK", "0")
    fault.clear()
    try:
        fault.inject("c", "delay_collective", "1:30.0")
        t0 = time.perf_counter()
        assert fault.fault_point("c") is None   # rank 0 != 1: no sleep
        assert time.perf_counter() - t0 < 5.0
        fault.inject("d", "delay_collective", "0:0.2")
        t0 = time.perf_counter()
        assert fault.fault_point("d") is None   # rank 0: sleeps
        assert time.perf_counter() - t0 >= 0.2
    finally:
        fault.clear()


def test_hang_rank_wedges_named_rank_only(monkeypatch):
    fault.clear()
    try:
        monkeypatch.setenv("CXN_WORKER_RANK", "0")
        fault.inject("h", "hang_rank", "1")
        assert fault.fault_point("h") is None
    finally:
        fault.clear()
    code = ("from cxxnet_tpu_torch.utils import fault; "
            "fault.fault_point('h'); print('survived')")
    p = subprocess.Popen([sys.executable, "-c", code],
                         env=_env(CXXNET_FAULT="h:hang_rank=0",
                                  CXN_WORKER_RANK="0"),
                         cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        time.sleep(2.0)
        assert p.poll() is None, "hang_rank process exited"
    finally:
        p.kill()
        out = p.communicate(timeout=60)[0]
    assert "survived" not in out
    assert "hanging rank 0" in out


def test_reshape_exit_code_is_the_jax_packages():
    from cxxnet_tpu.utils import fault as jax_fault
    assert fault.RESHAPE_EXIT_CODE == jax_fault.RESHAPE_EXIT_CODE == 118
    assert fault.KILL_EXIT_CODE == jax_fault.KILL_EXIT_CODE


# ---------------------------------------------------------------------------
# the trainer's collective fault point
# ---------------------------------------------------------------------------
NET = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 4
layer[1->1] = softmax
netconfig=end
input_shape = 1,1,6
batch_size = 4
silent = 1
"""


def test_collective_point_once_a_step_and_once_a_chunk():
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    tr = NetTrainer(cfg=NET, device="cpu")
    tr.init_model()
    rng = np.random.RandomState(0)

    def batch():
        return DataBatch(data=rng.randn(4, 1, 1, 6).astype(np.float32),
                         label=rng.randint(0, 4, (4, 1)).astype(np.float32))
    fault.clear()
    try:
        # an armed fault elsewhere makes the registry count every point
        fault.inject("never", "delay", "0", at=10 ** 6)
        for _ in range(3):
            tr.update(batch())
        assert fault.hits("collective") == 3
        tr.update_chunk([batch() for _ in range(4)])
        assert fault.hits("collective") == 4
    finally:
        fault.clear()


# ---------------------------------------------------------------------------
# bounded membership read
# ---------------------------------------------------------------------------
def test_read_membership_retries_until_record_appears(tmp_path):
    path = tmp_path / "generation.json"

    def writer():
        time.sleep(0.15)
        path.write_text(json.dumps({"generation": 1, "members": [1, 2]}))

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    rec = distributed.read_membership(str(tmp_path), attempts=20,
                                      backoff=0.05)
    t.join(timeout=10.0)
    assert rec["members"] == [1, 2]


def test_read_membership_exhaustion_is_config_error(tmp_path):
    from cxxnet_tpu.parallel.distributed import ConfigError as JaxConfigError
    from cxxnet_tpu.parallel.distributed import \
        read_membership as jax_read_membership
    for read, err in ((distributed.read_membership, ConfigError),
                      (jax_read_membership, JaxConfigError)):
        (tmp_path / "generation.json").unlink(missing_ok=True)
        with pytest.raises(err, match="generation.json"):
            read(str(tmp_path), attempts=2, backoff=0.01)
        (tmp_path / "generation.json").write_text("{nope")
        with pytest.raises(err, match="after 2 attempts"):
            read(str(tmp_path), attempts=2, backoff=0.01)


# ---------------------------------------------------------------------------
# supervisor: loss classification, worker command lines, the hook
# ---------------------------------------------------------------------------
KILL = fault.KILL_EXIT_CODE
RESHAPE = fault.RESHAPE_EXIT_CODE
WEDGED = {"member": 2, "by": 0, "reason": "wedged"}

CLASSIFY_CASES = [
    # preemption: the peers die in the cascade, collateral
    ([0, 1, 2], {0: KILL, 1: -6, 2: -6}, {}, [0]),
    # a wedged member convicted, SIGKILLed by teardown
    ([0, 1, 2], {0: RESHAPE, 1: RESHAPE, 2: -9}, {2: WEDGED}, [2]),
    # a conviction of a member that completed is ignored
    ([0, 1], {0: 0, 1: 0}, {1: WEDGED}, []),
    # no culprit: every crasher charged
    ([0, 1], {0: 1, 1: -15}, {}, [0, 1]),
    ([0, 1], {0: 0, 1: 3}, {}, [1]),
    # a survivor's reshape exit is not a crash
    ([0, 1], {0: RESHAPE, 1: None}, {}, []),
    ([0, 1, 2], {0: KILL, 1: RESHAPE, 2: KILL}, {}, [0, 2]),
    ([0, 1], {0: -15, 1: 0}, {0: WEDGED}, [0]),
]


@pytest.mark.parametrize("members,codes,conv,want", CLASSIFY_CASES)
def test_classify_lost_equals_jax(members, codes, conv, want):
    got = classify_lost(members, codes, conv)
    assert got == jax_elastic.classify_lost(members, codes, conv) == want


def _pod_conf(tmp_path, extra=""):
    conf = tmp_path / "pod.conf"
    conf.write_text(f"model_dir = {tmp_path}/models\n"
                    f"num_round = 4\n{extra}\n")
    return str(conf)


def _port_names(argv):
    """A JAX command line in the port's module names."""
    return [a.replace("cxxnet_tpu.", "cxxnet_tpu_torch.") for a in argv]


ARGV_CASES = [
    ("elastic_nproc = 3", 1, 0, [0, 1, 2], False),
    ("elastic_nproc = 3", 1, 1, [1, 2], False),
    ("elastic_absence_secs = 0", 0, 0, [0, 1], False),
    ("elastic_nproc = 1", 0, 0, [0], False),
    ("coord_dir = {d}/c\nelastic_stale_secs = 0", 2, 3, [2], True),
]


@pytest.mark.parametrize("extra,member,gen,members,ckpt", ARGV_CASES)
def test_worker_argv_equals_jax(tmp_path, extra, member, gen, members,
                                ckpt):
    conf = _pod_conf(tmp_path, extra.format(d=tmp_path))
    if ckpt:
        os.makedirs(tmp_path / "models", exist_ok=True)
        (tmp_path / "models" / "0002.model").write_bytes(b"x")
    got = ElasticPod(conf, ["dev=cpu"])._worker_argv(member, gen, members)
    want = jax_elastic.ElasticPod(conf, ["dev=cpu"])._worker_argv(
        member, gen, members)
    assert got == _port_names(want)
    # the port spawns and alerts with its own modules, never the JAX
    # package's
    joined = " ".join(got)
    assert "-m cxxnet_tpu.main" not in joined
    assert "cxxnet_tpu.parallel" not in joined
    assert got[1:3] == ["-m", "cxxnet_tpu_torch.main"]


def test_worker_argv_carries_elastic_wiring(tmp_path):
    pod = ElasticPod(_pod_conf(tmp_path, "elastic_nproc = 3"))
    argv = pod._worker_argv(1, generation=0, members=[0, 1, 2])
    joined = " ".join(argv)
    assert "elastic=1" in argv
    assert "param_server=dist" in argv
    assert f"coord_dir={pod.coord_dir}" in argv
    assert "metrics.m1.jsonl" in joined
    assert "continue=1" not in argv          # gen 0, no checkpoint
    assert "-m cxxnet_tpu_torch.parallel.elastic --self-convict" in joined
    argv1 = pod._worker_argv(1, generation=1, members=[1, 2])
    assert "continue=1" in argv1             # rollback replay


def test_worker_argv_absence_alert_disabled(tmp_path):
    pod = ElasticPod(_pod_conf(tmp_path, "elastic_absence_secs = 0"))
    argv = pod._worker_argv(0, generation=0, members=[0, 1])
    assert "--self-convict" not in " ".join(argv)


def test_pod_keys_and_defaults_equal_jax(tmp_path):
    conf = _pod_conf(tmp_path)
    for extra in ([], ["elastic_nproc=5", "elastic_respawn=0",
                       "elastic_max_generations=3", "elastic_grace_secs=1",
                       "elastic_poll_secs=0.5", "elastic_absence_secs=7",
                       "elastic_stale_secs=9", "elastic_fault=a:kill@2"]):
        got, want = ElasticPod(conf, extra), jax_elastic.ElasticPod(
            conf, extra)
        for attr in ("nproc", "respawn", "max_generations", "grace_secs",
                     "poll_secs", "absence_secs", "stale_secs",
                     "fault_spec", "model_dir", "coord_dir", "num_round"):
            assert getattr(got, attr) == getattr(want, attr), attr


def test_self_convict_hook_records_only_when_firing(tmp_path, monkeypatch):
    plane = ControlPlane(str(tmp_path))
    monkeypatch.setenv("ALERT_STATE", "resolved")
    assert _self_convict(str(tmp_path), 1) == 0
    assert plane.convictions([1]) == {}
    monkeypatch.setenv("ALERT_STATE", "firing")
    monkeypatch.setenv("ALERT_NAME", "elastic_train_step_absent")
    assert _self_convict(str(tmp_path), 1) == 0
    rec = plane.convictions([1])[1]
    assert rec["reason"].startswith("absence-alert:")


def test_self_convict_through_the_alert_cmd_line(tmp_path):
    """The alert_cmd the supervisor hands its workers runs the port's
    hook (a subprocess, as the alert engine runs it)."""
    pod = ElasticPod(_pod_conf(tmp_path, f"coord_dir = {tmp_path}/c"))
    argv = pod._worker_argv(2, generation=0, members=[0, 1, 2])
    cmd = next(a for a in argv if a.startswith("alert_cmd="))
    cmd = cmd[len("alert_cmd="):].split()
    p = subprocess.run(cmd, env=_env(ALERT_STATE="firing",
                                     ALERT_NAME="elastic_train_step_absent"),
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    rec = ControlPlane(str(tmp_path / "c")).convictions([2])[2]
    assert rec == {**rec, "member": 2, "by": 2}
    # the JAX package's plane reads the port's conviction
    assert jax_coord.ControlPlane(str(tmp_path / "c")).convictions(
        [2])[2]["reason"] == rec["reason"]


# ---------------------------------------------------------------------------
# the CLI under elastic = 1 without a supervisor: rank-as-member
# ---------------------------------------------------------------------------
def test_cli_one_member_pod_publishes_every_round(tmp_path):
    from cxxnet_tpu_torch import main as port_main
    img, lbl = _write_digits(str(tmp_path / "data"))
    conf = tmp_path / "net.conf"
    conf.write_text(POD_NET.format(img=img, lbl=lbl) + "num_round = 2\n"
                    "max_round = 2\nsave_model = 1\ndev = cpu\nsilent = 1\n")
    mdir = tmp_path / "m"
    assert port_main.main([str(conf), f"model_dir={mdir}", "elastic=1",
                           "barrier_secs=5", "leader_lease_secs=2"]) == 0
    plane = ControlPlane(str(mdir / "coord"))
    man = plane.read_manifest()
    assert man["round"] == 2 and man["epoch"] == 3 and man["writer"] == 0
    assert man["sha256"] == jax_coord.file_sha256(str(mdir / "0002.model"))
    kinds = [(e["kind"], e.get("round")) for e in _events(str(mdir / "coord"))
             if e["kind"] in ("barrier", "publish")]
    assert kinds == [("barrier", 0), ("publish", 0), ("barrier", 1),
                     ("publish", 1), ("barrier", 2), ("publish", 2)]
    assert not glob.glob(str(mdir / "*.tmp*"))


# ---------------------------------------------------------------------------
# e2e: kill -> restart -> rejoin, the JAX pod and the port pod side by side
# ---------------------------------------------------------------------------
def _write_digits(dirname, n=48):
    import gzip
    import struct
    rng = np.random.RandomState(7)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = rng.randint(0, 255, size=(n, 12, 12)).astype(np.uint8)
    os.makedirs(dirname, exist_ok=True)
    img = os.path.join(dirname, "img.gz")
    lbl = os.path.join(dirname, "lbl.gz")
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 12, 12))
        f.write(images.tobytes())
    with gzip.open(lbl, "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())
    return img, lbl


POD_NET = """
data = train
iter = mnist
    path_img = "{img}"
    path_label = "{lbl}"
    input_flat = 1
iter = end
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 8
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 10
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,144
random_type = xavier
batch_size = 24
eta = 0.1
metric = error
"""

POD_CONF = POD_NET + """
num_round = 3
max_round = 3
save_model = 1
dev = cpu
silent = 1
model_dir = {model_dir}
barrier_secs = 60
leader_lease_secs = 5
elastic_nproc = 2
elastic_respawn = 1
elastic_stale_secs = 0
elastic_absence_secs = 0
elastic_fault = "collective:kill_rank=1@3"
"""

EVAL = re.compile(r"^\[(\d+)\]\ttrain-error:(\S+)$", re.M)


def _pod_result(model_dir):
    coord = os.path.join(model_dir, "coord")
    events = _events(coord)
    evals = {}
    for path in sorted(glob.glob(os.path.join(coord, "worker.*.log"))):
        with open(path, errors="replace") as f:
            for rnd, err in EVAL.findall(f.read()):
                evals.setdefault(int(rnd), set()).add(float(err))
    return events, evals


def test_e2e_rejoin_matches_the_jax_pod(tmp_path):
    """The JAX test's rejoin scenario: the non-leader (member 1) is
    killed at its 3rd dispatched step (round 2's first), has restart
    budget, and rejoins generation 1 from the published round-1
    checkpoint. Run as a JAX pod and as a port pod from one JAX-written
    0000.model: the same generations, respawns and one publisher a
    round, the eval lines within 1e-6, the final checkpoints within
    rtol 1e-5 / atol 1e-6."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
    from cxxnet_tpu_torch.nnet import checkpoint
    img, lbl = _write_digits(str(tmp_path / "data"))
    jt = JaxTrainer(cfg=POD_NET.format(img=img, lbl=lbl) + "silent = 1\n")
    jt.init_model()
    procs = {}
    for pkg in ("cxxnet_tpu", "cxxnet_tpu_torch"):
        mdir = tmp_path / pkg
        os.makedirs(mdir)
        with open(mdir / "0000.model", "wb") as f:
            jt.save_model(f)
        conf = tmp_path / f"{pkg}.conf"
        conf.write_text(POD_CONF.format(img=img, lbl=lbl,
                                        model_dir=str(mdir)))
        env = _env(JAX_PLATFORMS="cpu", XLA_FLAGS="", OMP_NUM_THREADS="1")
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.parallel.elastic", str(conf)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    outs = {}
    try:
        for pkg, p in procs.items():
            outs[pkg] = p.communicate(timeout=420)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    res = {}
    for pkg, p in procs.items():
        events, evals = _pod_result(str(tmp_path / pkg))
        assert p.returncode == 0, (pkg, outs[pkg][-3000:], events[-5:])
        gens = {e["generation"]: e["members"] for e in events
                if e["kind"] == "generation_start"}
        respawns = [e["member"] for e in events
                    if e["kind"] == "member_respawn"]
        pubs = {}
        for e in events:
            if e["kind"] == "publish":
                pubs.setdefault(e["round"], []).append(e["who"])
        lost = [(e["member"], e["exit"]) for e in events
                if e["kind"] == "member_lost"]
        res[pkg] = (gens, respawns, pubs, lost, evals)
    jgens, jresp, jpubs, jlost, jevals = res["cxxnet_tpu"]
    pgens, presp, ppubs, plost, pevals = res["cxxnet_tpu_torch"]
    assert pgens == jgens == {0: [0, 1], 1: [0, 1]}
    assert presp == jresp == [1]
    assert plost == jlost == [(1, fault.KILL_EXIT_CODE)]
    assert all(len(w) == 1 for w in ppubs.values()), ppubs
    assert ppubs == jpubs and sorted(ppubs) == [1, 2, 3], (ppubs, jpubs)
    assert sorted(pevals) == sorted(jevals) == [1, 2, 3]
    for rnd in pevals:
        # every member printed one value a round (the repeated round 2
        # too: the rollback re-trains it from the same checkpoint)
        assert len(pevals[rnd]) == len(jevals[rnd]) == 1, (pevals, jevals)
        assert abs(pevals[rnd].pop() - jevals[rnd].pop()) <= 1e-6
    with open(tmp_path / "cxxnet_tpu" / "0003.model", "rb") as f:
        want = checkpoint.load_model(f)["params"]
    with open(tmp_path / "cxxnet_tpu_torch" / "0003.model", "rb") as f:
        got = checkpoint.load_model(f)["params"]
    assert sorted(got) == sorted(want)
    for lk in want:
        for pn in want[lk]:
            np.testing.assert_allclose(got[lk][pn], want[lk][pn],
                                       rtol=1e-5, atol=1e-6)
    for pkg in res:
        man = json.load(open(tmp_path / pkg / "coord" / "published.json"))
        assert man["round"] == 3 and man["generation"] == 1
