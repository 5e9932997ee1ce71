"""Elastic pod supervisor: preemption recovery and reshape (counterpart
of cxxnet_tpu/parallel/elastic.py).

    python -m cxxnet_tpu_torch.parallel.elastic train.conf elastic_nproc=3

A torch.distributed job has a fixed process set from
``init_process_group``: a member cannot join or leave a live gloo or
NCCL group, so "elastic" training is built from **generations** - the
coordinated-checkpoint recipe of arXiv:1605.08695 §4.3 and the elastic
recipe of arXiv:2004.13336. Each generation is one fixed-membership
pod launched by this supervisor (every worker runs the ordinary
``python -m cxxnet_tpu_torch.main`` CLI with ``elastic=1``, and with
``param_server=dist`` when it has peers); inside a generation the
coordinator (parallel/coordinator.py) barriers every round boundary
and the elected leader publishes ONE checkpoint. When a member is lost
the supervisor ends the generation and starts the next one from the
published checkpoint:

- **detection** - redundant signals, any one convicts: (1) the worker
  process exits (preemption: exit 117 from the ``kill`` / ``kill_rank``
  injectors, or any crash); (2) a surviving worker's barrier times out
  and it exits RESHAPE_EXIT_CODE after writing a conviction record;
  (3) the worker's own absence alert (telemetry/alerts.py: no
  ``train.step`` beacon progress) fires and its alert_cmd hook writes
  a conviction record - the wedged-but-alive case a process poll can
  never see; (4) the supervisor's cross-worker aggregation
  (tools/agg.py) returns a STALE ``restart`` verdict for the member's
  metrics stream (its telemetry heartbeat died).
- **decision** - a lost member with restart budget left
  (``elastic_respawn``) stays in the member set: the restarted process
  re-reads the membership record, replays the published checkpoint via
  the ordinary ``continue=1`` walkback, and rejoins at the next
  barrier. A member out of budget is dropped: the pod **reshapes** to
  N-1 members.
- **rollback** - nothing bespoke: the published checkpoint IS the
  rollback point (at most one round of progress is lost), and the next
  generation's ``continue=1`` resume re-trains from it.

Each generation's workers are fresh processes: the store of
torch.distributed lives in generation rank 0 (the lowest member), on a
fresh port each generation, and CXN_MEMBER_ID keeps a worker's member
id across generations, so a rank-scoped fault spec names one member
(and ``elastic_fault`` reaches generation 0 only). The teardown's
SIGTERM, then SIGKILL after the grace, ends ranks blocked in a
collective whose peer is gone.

The supervisor never imports torch, so it can outlive any number of
wedged generations.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from cxxnet_tpu_torch.parallel.coordinator import ControlPlane
from cxxnet_tpu_torch.utils.fault import KILL_EXIT_CODE, RESHAPE_EXIT_CODE


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def classify_lost(members: List[int],
                  exit_codes: Dict[int, Optional[int]],
                  convictions: Dict[int, Dict]) -> List[int]:
    """Which members a finished generation charges a restart to.

    ROOT CAUSES only: preemption (KILL_EXIT_CODE) and convicted
    members (barrier timeout, self-conviction, supervisor STALE
    verdict - a conviction may name a member the exit poll never saw
    die: wedged, then SIGKILLed by teardown). Every OTHER nonzero
    exit in a generation that has a culprit is collateral: a peer's
    collective fails when its partner's connection closes, and
    teardown SIGTERMs survivors blocked in collectives - those
    members rejoin the next generation at no budget cost. With no
    preemption and no conviction, any crash is the member's own
    (e.g. a bad config kills everyone; the generation cap bounds the
    retry loop)."""
    culprits = [m for m in members
                if exit_codes.get(m) == KILL_EXIT_CODE]
    culprits += [m for m in convictions
                 if m not in culprits and exit_codes.get(m) != 0]
    if not culprits:
        culprits = [m for m in members
                    if exit_codes.get(m)
                    not in (0, RESHAPE_EXIT_CODE, None)]
    return sorted(culprits)


class GenerationResult:
    """Outcome of one pod generation."""

    def __init__(self) -> None:
        self.done = False           # every member exited 0
        self.lost: List[int] = []   # members to respawn or drop
        self.exit_codes: Dict[int, Optional[int]] = {}
        self.convictions: Dict[int, Dict] = {}


class ElasticPod:
    """The generation loop. Config keys (the same ``k = v`` surface
    as every other component - the schema gate registers them from
    this handler):

    - ``elastic_nproc``        pod size N (default 2)
    - ``elastic_respawn``      per-member restart budget before the
                               member is dropped and the pod reshapes
                               to N-1 (default 1; 0 = always reshape)
    - ``elastic_max_generations`` hard cap on relaunches (default 8)
    - ``elastic_grace_secs``   SIGTERM->SIGKILL teardown grace (5)
    - ``elastic_poll_secs``    supervisor poll period (0.2)
    - ``elastic_absence_secs`` worker-side absence alert on the
                               train.step beacon; fires the
                               self-conviction hook (default 60;
                               0 disables the alert wiring)
    - ``elastic_stale_secs``   supervisor-side agg STALE conviction
                               threshold over the members' metrics
                               streams (default 60; 0 disables)
    - ``elastic_fault``        CXXNET_FAULT spec exported to
                               GENERATION 0 ONLY (deterministic e2e
                               murder - a spec that recurred in every
                               generation would kill the pod forever)
    """

    def __init__(self, conf: str, overrides: Optional[List[str]] = None):
        self.conf = conf
        self.overrides = list(overrides or [])
        self.nproc = 2
        self.respawn = 1
        self.max_generations = 8
        self.grace_secs = 5.0
        self.poll_secs = 0.2
        self.absence_secs = 60.0
        self.stale_secs = 60.0
        self.fault_spec = ""
        self.model_dir = "models"
        self.coord_dir = ""
        self.num_round = 10
        self._pairs: List[Tuple[str, str]] = []
        from cxxnet_tpu_torch.utils.config import (parse_config_file,
                                                   parse_config_string)
        for k, v in parse_config_file(conf):
            self.set_param(k, v)
        for arg in self.overrides:
            if "=" in arg:
                k, v = arg.split("=", 1)
                for kk, vv in parse_config_string(
                        f"{k.strip()} = {v.strip()}"):
                    self.set_param(kk, vv)
        self.coord_dir = self.coord_dir or os.path.join(
            self.model_dir, "coord")
        self.plane = ControlPlane(self.coord_dir)

    def set_param(self, name: str, val: str) -> None:
        if name == "elastic_nproc":
            self.nproc = int(val)
        if name == "elastic_respawn":
            self.respawn = int(val)
        if name == "elastic_max_generations":
            self.max_generations = int(val)
        if name == "elastic_grace_secs":
            self.grace_secs = float(val)
        if name == "elastic_poll_secs":
            self.poll_secs = float(val)
        if name == "elastic_absence_secs":
            self.absence_secs = float(val)
        if name == "elastic_stale_secs":
            self.stale_secs = float(val)
        if name == "elastic_fault":
            self.fault_spec = val
        if name == "model_dir":
            self.model_dir = val
        if name == "coord_dir":
            self.coord_dir = val
        if name == "num_round":
            self.num_round = int(val)
        self._pairs.append((name, val))

    # -- helpers -----------------------------------------------------------
    def _log(self, kind: str, **fields) -> None:
        self.plane.log_event("supervisor", kind, **fields)

    def _have_checkpoint(self) -> bool:
        import re
        try:
            names = os.listdir(self.model_dir)
        except OSError:
            return False
        return any(re.fullmatch(r"\d{4,}\.model", n) for n in names)

    def _member_metrics(self, member: int) -> str:
        return os.path.join(self.coord_dir, f"metrics.m{member}.jsonl")

    def _alert_rules_path(self) -> str:
        return os.path.join(self.coord_dir, "alerts.json")

    def _write_alert_rules(self) -> None:
        import json
        rules = [{
            "type": "absence", "name": "elastic_train_step_absent",
            "beacon": "train.step", "for_secs": self.absence_secs,
            "startup_grace_secs": max(self.absence_secs, 120.0),
        }]
        from cxxnet_tpu_torch.utils.fault import atomic_writer
        with atomic_writer(self._alert_rules_path(), "w") as fo:
            json.dump(rules, fo)

    def _worker_argv(self, member: int, generation: int,
                     members: List[int]) -> List[str]:
        argv = [sys.executable, "-m", "cxxnet_tpu_torch.main", self.conf]
        argv += self.overrides
        argv += [
            "elastic=1",
            f"coord_dir={self.coord_dir}",
            # per-member telemetry stream: the supervisor's agg
            # verdict reads these; a SHARED metrics_file would
            # interleave processes
            f"metrics_file={self._member_metrics(member)}",
            "heartbeat_secs=1.0",
        ]
        if len(members) > 1:
            argv.append("param_server=dist")
        if generation > 0 or self._have_checkpoint():
            # roll back to the published checkpoint: the ordinary
            # validated continue=1 walkback IS the rollback path
            argv.append("continue=1")
        if self.absence_secs > 0:
            # the worker convicts ITSELF when its train.step beacon
            # stalls: the alert thread outlives a wedged main thread
            argv += [
                f"alert_rules={self._alert_rules_path()}",
                "alert_cmd=" + (
                    f"{sys.executable} -m cxxnet_tpu_torch.parallel.elastic "
                    f"--self-convict {self.coord_dir} {member}"),
            ]
        return argv

    def _spawn(self, generation: int,
               members: List[int]) -> Dict[int, subprocess.Popen]:
        port = _free_port()
        if self.absence_secs > 0:
            self._write_alert_rules()
        procs: Dict[int, subprocess.Popen] = {}
        for rank, member in enumerate(sorted(members)):
            env = dict(os.environ)
            env["CXN_COORDINATOR"] = f"127.0.0.1:{port}"
            env["CXN_NUM_WORKER"] = str(len(members))
            env["CXN_WORKER_RANK"] = str(rank)
            env["CXN_MEMBER_ID"] = str(member)
            if self.fault_spec:
                if generation == 0:
                    env["CXXNET_FAULT"] = self.fault_spec
                else:
                    env.pop("CXXNET_FAULT", None)
            log_path = os.path.join(
                self.coord_dir, f"worker.m{member}.g{generation}.log")
            logf = open(log_path, "w")
            try:
                procs[member] = subprocess.Popen(
                    self._worker_argv(member, generation, members),
                    env=env, stdout=logf, stderr=subprocess.STDOUT)
            finally:
                logf.close()  # the child owns the fd now
        return procs

    def _teardown(self, procs: Dict[int, subprocess.Popen]) -> None:
        """End a generation: survivors are likely blocked inside a
        collective whose peer is gone - SIGTERM them, escalate to
        SIGKILL after the grace."""
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + self.grace_secs
        for p in procs.values():
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            try:
                p.wait(timeout=self.grace_secs)
            except subprocess.TimeoutExpired:
                pass

    def _stale_members(self, agg, procs) -> List[int]:
        """Map the aggregator's STALE restart verdicts (host/pid keys)
        back to members via the workers' pids."""
        if agg is None:
            return []
        agg.poll()
        pid_to_member = {p.pid: m for m, p in procs.items()}
        out = []
        for rec in agg.verdict().get("restart", []):
            if rec.get("reason") != "stale":
                continue
            key = str(rec.get("host", ""))
            try:
                pid = int(key.rsplit("/", 1)[1])
            except (IndexError, ValueError):
                continue
            m = pid_to_member.get(pid)
            if m is not None:
                out.append(m)
        return out

    # -- one generation ----------------------------------------------------
    def run_generation(self, generation: int,
                       members: List[int]) -> GenerationResult:
        members = sorted(members)
        self.plane.write_generation(generation, members)
        # conviction records are per-generation evidence: stale ones
        # from the previous teardown must not instantly re-convict
        for m in members:
            try:
                os.remove(self.plane.conviction_path(m))
            except OSError:
                pass
        self._log("generation_start", generation=generation,
                  members=members)
        procs = self._spawn(generation, members)
        agg = None
        if self.stale_secs > 0:
            from cxxnet_tpu_torch.tools.agg import Aggregator, make_source
            agg = Aggregator(
                [make_source(self._member_metrics(m)) for m in members],
                stale_secs=self.stale_secs)
        res = GenerationResult()
        live = dict(procs)
        lost: List[int] = []
        while live and not lost:
            time.sleep(self.poll_secs)
            for m, p in list(live.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del live[m]
                res.exit_codes[m] = rc
                if rc == 0:
                    self._log("member_done", member=m,
                              generation=generation)
                elif rc == RESHAPE_EXIT_CODE:
                    # a survivor convicting a peer is itself healthy;
                    # the convicted member shows up in the records
                    self._log("member_reshape_exit", member=m,
                              generation=generation)
                else:
                    cause = ("preempted" if rc == KILL_EXIT_CODE
                             else "crashed")
                    self._log("member_lost", member=m, exit=rc,
                              cause=cause, generation=generation)
                    lost.append(m)
            if lost:
                break
            convicted = self.plane.convictions(members)
            fresh = [m for m in convicted
                     if m in live or m not in res.exit_codes]
            for m in fresh:
                self._log("member_convicted", member=m,
                          generation=generation,
                          reason=convicted[m].get("reason"),
                          by=convicted[m].get("by"))
            lost.extend(m for m in fresh if m not in lost)
            for m in self._stale_members(agg, procs):
                if m not in lost and m in live:
                    # record the verdict as a conviction so the
                    # post-teardown classification charges it
                    self.plane.write_conviction(
                        m, -1, "stale-metrics")
                    self._log("member_stale", member=m,
                              generation=generation)
                    lost.append(m)
        t_down = time.monotonic()
        self._teardown(procs)
        teardown_secs = time.monotonic() - t_down
        for m, p in procs.items():
            res.exit_codes.setdefault(m, p.poll())
        res.convictions = self.plane.convictions(members)
        res.lost = classify_lost(members, res.exit_codes,
                                 res.convictions)
        res.done = (not lost and res.exit_codes
                    and all(rc == 0 for rc in res.exit_codes.values()))
        self._log("generation_end", generation=generation,
                  done=res.done, lost=res.lost,
                  teardown_secs=round(teardown_secs, 3),
                  exit_codes={str(k): v
                              for k, v in res.exit_codes.items()})
        return res

    # -- the pod -----------------------------------------------------------
    def run(self) -> int:
        os.makedirs(self.coord_dir, exist_ok=True)
        members = list(range(self.nproc))
        restarts = {m: 0 for m in members}
        self._log("pod_start", nproc=self.nproc,
                  respawn=self.respawn, conf=self.conf)
        for generation in range(self.max_generations):
            res = self.run_generation(generation, members)
            if res.done:
                manifest = self.plane.read_manifest()
                self._log("pod_done", generation=generation,
                          members=members, manifest=manifest)
                return 0
            if not res.lost:
                # ended without a culprit (every member crashed, or
                # teardown raced completion): retry the same set -
                # the generation cap bounds a crash loop
                self._log("pod_retry", generation=generation)
                continue
            next_members = []
            for m in members:
                if m not in res.lost:
                    next_members.append(m)
                elif restarts[m] < self.respawn:
                    # preemption recovery: the member rejoins - its
                    # restarted process replays the published
                    # checkpoint and meets the pod at the next barrier
                    restarts[m] += 1
                    next_members.append(m)
                    self._log("member_respawn", member=m,
                              restarts=restarts[m])
                else:
                    # out of budget: reshape the pod to N-1 around it
                    self._log("member_dropped", member=m)
            if not next_members:
                self._log("pod_failed", reason="no members left")
                return 1
            members = next_members
        self._log("pod_failed", reason="max generations exceeded",
                  max_generations=self.max_generations)
        return 1


def _self_convict(coord_dir: str, member: int) -> int:
    """alert_cmd hook target: record this worker's own absence alert
    as a conviction (state comes from the ALERT_* env the alert engine
    sets; only a FIRING absence convicts - the resolve hook run is a
    no-op)."""
    if os.environ.get("ALERT_STATE") != "firing":
        return 0
    plane = ControlPlane(coord_dir)
    plane.write_conviction(
        member, member,
        f"absence-alert:{os.environ.get('ALERT_NAME', '?')}")
    plane.log_event(f"m{member}", "self_convict",
                    alert=os.environ.get("ALERT_NAME"),
                    message=os.environ.get("ALERT_MESSAGE"))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.stdout.write(__doc__ + "\n")
        return 1
    if argv[0] == "--self-convict":
        return _self_convict(argv[1], int(argv[2]))
    return ElasticPod(argv[0], argv[1:]).run()


if __name__ == "__main__":
    sys.exit(main())
