"""Coordinated checkpoint barriers, leases, and leader election
(counterpart of cxxnet_tpu/parallel/coordinator.py: the same names, and
the same record files and fields, so a JAX worker and a port worker can
meet at one barrier in one `coord_dir`).

A job on `param_server = dist` has a fixed worker set: one lost peer
stalls its collectives, and N ranks that checkpoint independently race
on one `%04d.model`. This module is the coordination layer that
replaces those per-process heroics (TensorFlow's coordinated-checkpoint
fault tolerance, arXiv:1605.08695 §4.3): at every round boundary the
pod reaches a **barrier**, a deterministic **leader** (lowest live
member over the control plane) publishes ONE atomic checkpoint with a
pod-wide epoch stamp, and a member that never arrives is **convicted**
so the elastic supervisor (parallel/elastic.py) can roll back one
round, rebuild the job without it, and continue.

The control plane is a shared directory (``coord_dir``), not a gloo
collective: the training collectives die with their slowest member -
exactly the failure being coordinated around - so membership must ride
a channel that survives a dead peer. Records are tiny JSON files
written through ``atomic_writer`` (a reader sees a complete record or
the previous one, never a torn write); on a cluster this is the same
shared filesystem the checkpoints already use.

Records under ``coord_dir``:

- ``lease.<member>.json``  - liveness lease, renewed by a heartbeat
  thread every ``lease_secs / 3``; a lease older than ``lease_secs``
  is stale and its member counts as dead (vs wedged: alive lease,
  absent from the barrier).
- ``generation.json``      - the membership record: which members form
  pod generation g (written by the supervisor before each launch).
- ``barrier/g<G>.r<R>.m<M>.json`` - member M arrived at round R's
  barrier in generation G.
- ``published.json``       - the publish manifest: the ONE checkpoint
  the pod agrees on (path, sha256, round, generation, monotonically
  increasing pod epoch, writer member).
- ``convict.<member>.json`` - a conviction: who convicted the member
  and why (a barrier timeout, the member's own absence alert, the
  supervisor's stale-metrics verdict).
- ``events.<name>.jsonl``  - per-process append-only event log
  (arrivals, elections, publishes, convictions).

Telemetry goes through cxxnet_tpu_torch.telemetry: the gauges
``coord.generation``, ``coord.member``, ``coord.leader``,
``coord.is_leader`` and ``coord.epoch``, the counters
``coord.barriers``, ``coord.convictions`` and ``coord.publishes``, and
the beacon ``coord.barrier``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from cxxnet_tpu_torch.utils.fault import atomic_writer, fault_point

# the lease a member renews, and how long a barrier waits for every
# member before it convicts the absent ones (a convicting worker exits
# with utils.fault.RESHAPE_EXIT_CODE)
LEASE_SECS = 10.0
BARRIER_SECS = 30.0


class PodReshapeRequired(RuntimeError):
    """A barrier timed out with members missing: the pod must be
    rebuilt without (or with a restarted copy of) the absentees. The
    worker exits with RESHAPE_EXIT_CODE; the supervisor rolls back to
    the published checkpoint and relaunches."""

    def __init__(self, round_no: int, missing: List[int],
                 dead: List[int]):
        self.round_no = round_no
        self.missing = list(missing)    # never arrived
        self.dead = list(dead)          # ... and their lease is stale
        wedged = [m for m in missing if m not in dead]
        parts = []
        if dead:
            parts.append(f"dead (stale lease): {dead}")
        if wedged:
            parts.append(f"wedged (live lease, absent): {wedged}")
        super().__init__(
            f"checkpoint barrier for round {round_no} timed out; "
            + "; ".join(parts))


@dataclass
class BarrierResult:
    """One completed checkpoint barrier."""

    round_no: int
    generation: int
    members: List[int]      # who arrived (== the generation members)
    leader: int             # lowest live member - the one publisher
    is_leader: bool
    epoch: int              # pod epoch the NEXT publish will stamp


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ControlPlane:
    """The shared-directory record store. All methods are process-safe
    (atomic replace writes, whole-file reads); instances are cheap and
    carry no daemon state - the heartbeat lives in Coordinator."""

    def __init__(self, root: str,
                 clock: Callable[[], float] = time.time):
        self.root = root
        # wall clock by default: lease timestamps are compared ACROSS
        # processes (possibly across hosts), which a per-process
        # monotonic clock cannot do; injectable for fake-clock tests
        self.clock = clock
        os.makedirs(os.path.join(root, "barrier"), exist_ok=True)

    # -- raw records -------------------------------------------------------
    def _write_json(self, path: str, rec: Dict, fsync: bool) -> None:
        with atomic_writer(path, "w", fsync=fsync) as fo:
            json.dump(rec, fo)

    @staticmethod
    def read_json(path: str) -> Optional[Dict]:
        """One record, or None when absent. Torn/garbage content is
        impossible locally (atomic replace) but treated as absent
        anyway - NFS-style close-to-open races must not crash the
        reader, the next poll sees the complete record."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except OSError:
            return None
        except ValueError:
            return None

    # -- leases ------------------------------------------------------------
    def lease_path(self, member: int) -> str:
        return os.path.join(self.root, f"lease.{member}.json")

    def write_lease(self, member: int, generation: int,
                    pid: Optional[int] = None) -> None:
        # leases renew ~3x per lease_secs: skip the fsync (a lost
        # lease write costs one stale-by-a-beat read, not correctness)
        self._write_json(self.lease_path(member), {
            "member": member, "generation": generation,
            "pid": os.getpid() if pid is None else pid,
            "ts": self.clock()}, fsync=False)

    def lease_fresh(self, member: int, lease_secs: float,
                    now: Optional[float] = None) -> bool:
        rec = self.read_json(self.lease_path(member))
        if rec is None:
            return False
        now = self.clock() if now is None else now
        return now - float(rec.get("ts", 0.0)) <= lease_secs

    def live_members(self, members: List[int], lease_secs: float,
                     now: Optional[float] = None) -> List[int]:
        now = self.clock() if now is None else now
        return [m for m in members
                if self.lease_fresh(m, lease_secs, now)]

    # -- membership (generation) record ------------------------------------
    def generation_path(self) -> str:
        return os.path.join(self.root, "generation.json")

    def write_generation(self, generation: int,
                         members: List[int]) -> None:
        self._write_json(self.generation_path(), {
            "generation": generation,
            "members": sorted(members),
            "ts": self.clock()}, fsync=True)

    def read_generation(self) -> Optional[Dict]:
        return self.read_json(self.generation_path())

    # -- barrier arrivals ---------------------------------------------------
    def _barrier_path(self, generation: int, round_no: int,
                      member: int) -> str:
        return os.path.join(
            self.root, "barrier",
            f"g{generation}.r{round_no}.m{member}.json")

    def write_arrival(self, generation: int, round_no: int,
                      member: int) -> None:
        self._write_json(
            self._barrier_path(generation, round_no, member),
            {"member": member, "round": round_no,
             "generation": generation, "ts": self.clock()},
            fsync=False)

    def arrivals(self, generation: int, round_no: int,
                 members: List[int]) -> List[int]:
        return [m for m in members
                if self.read_json(
                    self._barrier_path(generation, round_no, m))
                is not None]

    # -- publish manifest ---------------------------------------------------
    def manifest_path(self) -> str:
        return os.path.join(self.root, "published.json")

    def read_manifest(self) -> Optional[Dict]:
        return self.read_json(self.manifest_path())

    def write_manifest(self, rec: Dict) -> None:
        self._write_json(self.manifest_path(), rec, fsync=True)

    # -- conviction records (absence-alert hook + barrier verdicts) ---------
    def conviction_path(self, member: int) -> str:
        return os.path.join(self.root, f"convict.{member}.json")

    def write_conviction(self, member: int, by: int,
                         reason: str) -> None:
        self._write_json(self.conviction_path(member), {
            "member": member, "by": by, "reason": reason,
            "ts": self.clock()}, fsync=False)

    def convictions(self, members: List[int]) -> Dict[int, Dict]:
        out: Dict[int, Dict] = {}
        for m in members:
            rec = self.read_json(self.conviction_path(m))
            if rec is not None:
                out[m] = rec
        return out

    # -- event log (coordinator beacons) ------------------------------------
    def log_event(self, who: str, kind: str, **fields) -> None:
        rec = {"ts": self.clock(), "who": who, "kind": kind}
        rec.update(fields)
        path = os.path.join(self.root, f"events.{who}.jsonl")
        # single writer per file: O_APPEND keeps lines whole without
        # the atomic-replace dance (and readers tail incrementally)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")


class Coordinator:
    """One worker process's half of the barrier protocol. Owns the
    lease heartbeat thread; ``barrier()`` is called from the training
    thread at every round boundary."""

    def __init__(self, plane: ControlPlane, member: int,
                 members: List[int], generation: int = 0,
                 barrier_secs: float = BARRIER_SECS,
                 lease_secs: float = LEASE_SECS,
                 poll_secs: float = 0.05):
        self.plane = plane
        self.member = member
        self.members = sorted(members)
        self.generation = generation
        self.barrier_secs = barrier_secs
        self.lease_secs = lease_secs
        self.poll_secs = poll_secs
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # heartbeat-thread/trainer-thread shared state, moves only
        # under the lock (the concurrency lint's GL016)
        # guarded-by: self._lock
        self._renewals = 0
        # guarded-by: self._lock
        self._last_renew = 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Write the first lease synchronously (the pod must see this
        member live before any barrier), then start the renewal
        thread."""
        self.plane.write_lease(self.member, self.generation)
        self.plane.log_event(
            f"m{self.member}", "join", member=self.member,
            generation=self.generation, members=self.members)
        from cxxnet_tpu_torch import telemetry
        telemetry.set_gauge("coord.generation", float(self.generation))
        telemetry.set_gauge("coord.member", float(self.member))
        t = threading.Thread(target=self._heartbeat,
                             name=f"coord-lease-m{self.member}",
                             daemon=True)
        self._thread = t
        t.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Coordinator":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _heartbeat(self) -> None:
        """Lease renewal loop. Note what this does NOT prove: a wedged
        main thread keeps its lease fresh (the thread is alive), which
        is exactly why conviction distinguishes dead (stale lease)
        from wedged (fresh lease, absent from the barrier) - and why
        the absence alert on the train.step beacon, not the lease, is
        the wedged-worker detector."""
        period = max(self.lease_secs / 3.0, 0.01)
        while not self._stop.wait(period):
            self.plane.write_lease(self.member, self.generation)
            with self._lock:
                self._renewals += 1
                self._last_renew = self.plane.clock()

    @property
    def renewals(self) -> int:
        with self._lock:
            return self._renewals

    # -- election ----------------------------------------------------------
    def live_members(self, now: Optional[float] = None) -> List[int]:
        live = self.plane.live_members(self.members, self.lease_secs,
                                       now)
        if self.member not in live:
            # self-evidently live (the lease file may lag a beat)
            live = sorted(live + [self.member])
        return live

    def leader(self, now: Optional[float] = None) -> int:
        """Deterministic lease-based election: the lowest member with
        a fresh lease. Within a generation every completed barrier
        contains ALL generation members, so the elected leader is
        stable; it changes exactly when a reshape drops the old one."""
        return min(self.live_members(now))

    def is_leader(self, now: Optional[float] = None) -> bool:
        return self.leader(now) == self.member

    # -- the barrier -------------------------------------------------------
    def barrier(self, round_no: int) -> BarrierResult:
        """Arrive at round ``round_no``'s checkpoint barrier and wait
        for every generation member. Completion elects the publisher:
        leader = lowest member of the arrival set (a pure function of
        the set - every process computes the same one). A member still
        missing after ``barrier_secs`` is convicted - dead when its
        lease is stale, wedged when the lease is fresh - and
        PodReshapeRequired is raised; the caller exits with
        RESHAPE_EXIT_CODE and the supervisor rebuilds the pod."""
        fault_point("barrier")
        plane = self.plane
        plane.write_arrival(self.generation, round_no, self.member)
        plane.log_event(f"m{self.member}", "arrive", round=round_no,
                        generation=self.generation)
        from cxxnet_tpu_torch import telemetry
        telemetry.beacon("coord.barrier")
        telemetry.inc("coord.barriers")
        deadline = plane.clock() + self.barrier_secs
        while True:
            arrived = plane.arrivals(self.generation, round_no,
                                     self.members)
            if len(arrived) == len(self.members):
                break
            now = plane.clock()
            if now > deadline:
                missing = [m for m in self.members
                           if m not in arrived]
                dead = [m for m in missing
                        if not plane.lease_fresh(
                            m, self.lease_secs, now)]
                for m in missing:
                    reason = "dead" if m in dead else "wedged"
                    plane.write_conviction(m, self.member, reason)
                plane.log_event(
                    f"m{self.member}", "convict", round=round_no,
                    missing=missing, dead=dead)
                telemetry.inc("coord.convictions", len(missing))
                raise PodReshapeRequired(round_no, missing, dead)
            self._stop.wait(self.poll_secs)
        leader = min(arrived)
        manifest = plane.read_manifest()
        epoch = (int(manifest["epoch"]) + 1) if manifest else 1
        res = BarrierResult(
            round_no=round_no, generation=self.generation,
            members=sorted(arrived), leader=leader,
            is_leader=(leader == self.member), epoch=epoch)
        plane.log_event(
            f"m{self.member}", "barrier", round=round_no,
            generation=self.generation, leader=leader,
            is_leader=res.is_leader, epoch=epoch)
        telemetry.set_gauge("coord.leader", float(leader))
        telemetry.set_gauge("coord.is_leader", float(res.is_leader))
        return res

    # -- publishing --------------------------------------------------------
    def publish(self, result: BarrierResult, round_no: int,
                path: str, sha256: str, nbytes: int) -> Dict:
        """Record the checkpoint the pod agrees on. Leader-only by
        protocol; asserted here so a caller bug becomes a loud failure
        instead of a silent return to N-independent-writers races."""
        if not result.is_leader:
            raise RuntimeError(
                f"member {self.member} tried to publish round "
                f"{round_no} but the leader is {result.leader}")
        rec = {
            "epoch": result.epoch, "round": round_no,
            "generation": self.generation, "path": path,
            "sha256": sha256, "bytes": nbytes,
            "writer": self.member, "ts": self.plane.clock(),
        }
        self.plane.write_manifest(rec)
        self.plane.log_event(
            f"m{self.member}", "publish", round=round_no,
            epoch=result.epoch, path=path, sha256=sha256)
        from cxxnet_tpu_torch import telemetry
        telemetry.inc("coord.publishes")
        telemetry.set_gauge("coord.epoch", float(result.epoch))
        return rec
