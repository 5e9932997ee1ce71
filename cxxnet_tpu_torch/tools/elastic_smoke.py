#!/usr/bin/env python3
"""elastic_smoke: the elastic pod's end-to-end proof (the port's
counterpart of cxxnet_tpu/tools/elastic_smoke.py).

    python -m cxxnet_tpu_torch.tools.elastic_smoke [--out DIR] [--dev DEV]
        [--nproc N] [--rounds R] [--kill-hit K]
        [--conf CONF --train N --test N] [--json PATH]

Drives the elastic supervisor (parallel/elastic.py) over real ``python
-m cxxnet_tpu_torch.main`` worker processes through a deterministic
worker murder, and asserts what the JAX tool asserts:

1. an N-process pod trains with coordinated checkpoint barriers; the
   ``collective:kill_rank=0@K`` injector kills the LEADER (member 0,
   whose process serves the job's store) at its K-th dispatched step;
2. the supervisor reshapes: generation 1 runs with the N-1 surviving
   members, a NEW leader (the lowest live member) is elected, and
   training continues from the published rollback checkpoint to the end;
3. exactly ONE process published every checkpoint (manifest + event
   logs + no orphan ``*.tmp`` in the model dir);
4. the final checkpoint is byte-identical (sha256) to an UNINTERRUPTED
   N-1 process run resumed from the same rollback checkpoint, and the
   per-round eval lines after the rollback match line for line.

The default pod is the JAX tool's: a b24 MLP on 48 synthetic 12x12
images, 3 members, 6 rounds, the leader killed at hit 7 (round 4's
first step), so a 3 -> 2 reshape. ``--conf`` runs a conf of the repo
instead (its ``./data/`` paths pointed at ``--train`` + ``--test``
synthetic 28x28 mnist images written under DIR): chip_smoke.py runs
``examples/LongSeq/seq_mnist.conf`` as shipped with 2 members, 3 rounds
and the leader killed at hit 3, a 2 -> 1 reshape. ``--dev`` is the
workers' ``dev`` (default ``gpu:0``: every member on card 0, over gloo
where members share it; ``cpu`` runs here); with no card the default
raises, naming ``--dev cpu``.

Besides the checks it prints each generation's members, leader and
publishers, both sha256s, the eval lines, each generation's seconds from
spawn to its first step (the first heartbeat of a member's metrics
stream that counts a trained batch: 1 s resolution) and its teardown
seconds, and each member's kernel launches in each generation (from
its per-round metrics records: a member killed mid-round leaves its last
whole round's); ``--json`` writes them.
Exit 0 iff every check passes.
"""

from __future__ import annotations

import glob
import gzip
import hashlib
import json
import os
import re
import shutil
import struct
import sys
import tempfile
from typing import Dict, List, Optional

def _write_dataset(dirname: str, n: int = 48) -> Dict[str, str]:
    """The JAX tool's tiny deterministic MNIST-format set (12x12)."""
    import numpy as np
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
    return {"img": img, "lbl": lbl}


CONF = """
data = train
iter = mnist
    path_img = "{img}"
    path_label = "{lbl}"
    input_flat = 1
iter = end
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 10
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,144
random_type = xavier
batch_size = 24
eta = 0.1
momentum = 0.9
metric = error
eval_train = 1
silent = 1
"""

# the pod keys: every worker's barrier and lease, the supervisor's
# budget, and no absence / stale detection (a worker killed on purpose
# is detected by its exit)
POD_KEYS = """
num_round = {rounds}
max_round = {rounds}
save_model = 1
dev = {dev}
model_dir = {model_dir}
barrier_secs = 60
leader_lease_secs = 5
elastic_nproc = {nproc}
elastic_respawn = 0
elastic_stale_secs = 0
elastic_absence_secs = 0
telemetry_steps = 1
{extra}
"""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _run_pod(conf_path: str) -> int:
    from cxxnet_tpu_torch.parallel.elastic import ElasticPod
    return ElasticPod(conf_path).run()


def _events(coord_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(coord_dir,
                                              "events.*.jsonl"))):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


def _eval_lines(coord_dir: str) -> Dict[int, str]:
    """round -> eval stderr line, from the worker logs (any member's
    copy; every member prints the same line for the same round)."""
    out: Dict[int, str] = {}
    for path in sorted(glob.glob(os.path.join(coord_dir,
                                              "worker.*.log"))):
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                m = re.match(r"^\[(\d+)\]\ttrain-error:", line)
                if m:
                    out[int(m.group(1))] = line.rstrip("\n")
    return out


def _launches(coord_dir: str, events: List[Dict]) -> Dict[str, Dict]:
    """"m<member>.g<generation>" -> {"round": the member's last trained
    round in that generation, "steps": its steps over that
    generation's rounds, "launches": its process's kernel launches at
    that round's end} from the members' per-round metrics records (a
    member killed mid-round leaves its last whole round's)."""
    starts = sorted((e["ts"], e["generation"], e["members"]) for e in events
                    if e["kind"] == "generation_start")
    out: Dict[str, Dict] = {}
    for i, (t0, g, members) in enumerate(starts):
        t1 = starts[i + 1][0] if i + 1 < len(starts) else float("inf")
        for m in members:
            path = os.path.join(coord_dir, f"metrics.m{m}.jsonl")
            if not os.path.exists(path):
                continue
            rec = None
            steps = 0
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    try:
                        r = json.loads(line)
                    except ValueError:
                        continue
                    if (r.get("kind") == "round"
                            and t0 <= float(r.get("ts", 0.0)) < t1):
                        rec = r
                        steps += int(r.get("steps", 0))
            if rec is not None:
                out[f"m{m}.g{g}"] = {"round": rec.get("round"),
                                     "steps": steps,
                                     "launches": rec.get("launches", {})}
    return out


def _first_step_ts(metrics_path: str, t0: float) -> Optional[float]:
    """Wall time of the first record at or after `t0` in a member's
    metrics stream whose registry counts a trained batch
    (`train.images` > 0). A generation's processes are torn down before
    the next one spawns, so the records after its spawn are its own."""
    try:
        f = open(metrics_path, "r", encoding="utf-8")
    except OSError:
        return None
    with f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if float(rec.get("ts", 0.0)) < t0:
                continue
            val = (rec.get("metrics") or {}).get("train.images")
            if isinstance(val, dict):
                val = val.get("value", 0)
            if val:
                return float(rec["ts"])
    return None


def _timing(coord_dir: str, events: List[Dict]) -> Dict[str, Dict]:
    """Each generation's seconds from spawn to its first trained step
    (the earliest member's) and its teardown seconds."""
    starts = {e["generation"]: e for e in events
              if e["kind"] == "generation_start"}
    ends = {e["generation"]: e for e in events
            if e["kind"] == "generation_end"}
    out = {}
    for g, st in sorted(starts.items()):
        firsts = []
        for m in st["members"]:
            ts = _first_step_ts(
                os.path.join(coord_dir, f"metrics.m{m}.jsonl"), st["ts"])
            if ts is not None:
                firsts.append(ts - st["ts"])
        out[str(g)] = {
            "members": st["members"],
            "spawn_to_first_step_s": min(firsts) if firsts else None,
            "teardown_s": ends.get(g, {}).get("teardown_secs")}
    return out


def _pod_conf(path: str, body: str, **keys) -> None:
    with open(path, "w") as f:
        f.write(body + POD_KEYS.format(**keys))


def run_smoke(out: str, dev: str = "gpu:0", nproc: int = 3,
              rounds: int = 6, kill_hit: int = 7, conf: str = "",
              n_train: int = 200, n_test: int = 100) -> Dict:
    """Run A (the interrupted pod), then B (the uninterrupted N-1 pod
    from A's rollback checkpoint); returns the summary with "ok"."""
    os.makedirs(out, exist_ok=True)
    if conf:
        from cxxnet_tpu_torch.tools.fused_smoke import write_digits
        data = os.path.join(out, "data")
        os.makedirs(data, exist_ok=True)
        write_digits(data, n_train, 3, "train")
        write_digits(data, n_test, 4, "t10k")
        with open(conf) as f:
            body = f.read().replace('"./data/', f'"{data}/')
    else:
        d = _write_dataset(os.path.join(out, "data"))
        body = CONF.format(img=d["img"], lbl=d["lbl"])
    checks = []

    def check(label: str, ok: bool, detail: str = "") -> bool:
        checks.append((label, bool(ok)))
        print(f"  [{'ok' if ok else 'FAIL'}] {label}"
              + (f": {detail}" if detail else ""))
        return bool(ok)

    # ---- run A: the interrupted pod ------------------------------------
    dir_a = os.path.join(out, "run_a")
    conf_a = os.path.join(out, "a.conf")
    _pod_conf(conf_a, body, rounds=rounds, dev=dev, model_dir=dir_a,
              nproc=nproc, extra=('elastic_fault = '
                                  f'"collective:kill_rank=0@{kill_hit}"'))
    print(f"elastic-smoke: run A ({nproc}-process pod, leader killed at "
          f"collective hit {kill_hit})")
    rc_a = _run_pod(conf_a)
    summary: Dict = {"nproc": nproc, "rounds": rounds,
                     "kill_hit": kill_hit, "dev": dev}
    check("interrupted pod recovered", rc_a == 0, f"rc={rc_a}")
    coord_a = os.path.join(dir_a, "coord")
    events = _events(coord_a)
    gens = {e["generation"]: e for e in events
            if e["kind"] == "generation_start"}
    summary["generations"] = {str(g): gens[g]["members"] for g in gens}
    g0 = gens.get(0, {}).get("members", [])
    g1 = gens.get(1, {}).get("members", [])
    check("reshape without member 0",
          len(gens) >= 2 and len(g1) == nproc - 1 and 0 not in g1,
          f"generations {summary['generations']}")
    leaders = sorted({(e["generation"], e["leader"]) for e in events
                      if e["kind"] == "barrier"})
    summary["leaders"] = leaders
    check("leader re-elected",
          (0, 0) in leaders and bool(g1) and (1, min(g1)) in leaders,
          f"(generation, leader) {leaders}")
    pubs: Dict[int, List[Dict]] = {}
    for e in events:
        if e["kind"] == "publish":
            pubs.setdefault(e["round"], []).append(e)
    summary["publishers"] = {str(r): [p["who"] for p in recs]
                             for r, recs in sorted(pubs.items())}
    check("one publisher a round, every round published",
          all(len(r) == 1 for r in pubs.values())
          and all(r in pubs for r in range(rounds + 1)),
          f"publishers {summary['publishers']}")
    orphans = glob.glob(os.path.join(dir_a, "*.tmp*"))
    check("no orphan temporary file", not orphans, str(orphans))
    g0_pubs = [r for r, recs in pubs.items() if recs[0]["who"] == "m0"]
    rollback = max(g0_pubs) if g0_pubs else -1
    summary["rollback_round"] = rollback
    check("the kill round was not published", 0 <= rollback < rounds,
          f"rollback point = round {rollback}")
    summary["timing"] = _timing(coord_a, events)
    summary["launches_a"] = _launches(coord_a, events)

    # ---- run B: uninterrupted N-1 run from the rollback point ----------
    dir_b = os.path.join(out, "run_b")
    os.makedirs(dir_b, exist_ok=True)
    ok = rollback >= 0 and rc_a == 0
    if ok:
        shutil.copy(os.path.join(dir_a, f"{rollback:04d}.model"),
                    os.path.join(dir_b, f"{rollback:04d}.model"))
        conf_b = os.path.join(out, "b.conf")
        _pod_conf(conf_b, body, rounds=rounds, dev=dev, model_dir=dir_b,
                  nproc=nproc - 1, extra="")
        print(f"elastic-smoke: run B (uninterrupted {nproc - 1}-process "
              f"pod from round {rollback})")
        rc_b = _run_pod(conf_b)
        check("reference pod completed", rc_b == 0, f"rc={rc_b}")
        final_a = os.path.join(dir_a, f"{rounds:04d}.model")
        final_b = os.path.join(dir_b, f"{rounds:04d}.model")
        sha_a = _sha256(final_a) if os.path.exists(final_a) else ""
        sha_b = _sha256(final_b) if os.path.exists(final_b) else ""
        summary["sha256"] = {"interrupted": sha_a, "uninterrupted": sha_b}
        check("final checkpoint sha256 identical",
              bool(sha_a) and sha_a == sha_b, f"{sha_a} vs {sha_b}")
        ev_a = _eval_lines(coord_a)
        ev_b = _eval_lines(os.path.join(dir_b, "coord"))
        summary["eval_lines"] = {"interrupted": ev_a, "uninterrupted": ev_b}
        after = range(rollback + 1, rounds + 1)
        check("eval lines equal after the rollback",
              all(r in ev_a and r in ev_b and ev_a[r] == ev_b[r]
                  for r in after),
              f"rounds {rollback + 1}..{rounds}")
        coord_b = os.path.join(dir_b, "coord")
        summary["launches_b"] = _launches(coord_b, _events(coord_b))
    manifest = os.path.join(coord_a, "published.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            summary["manifest"] = json.load(f)
    summary["checks"] = [{"check": c, "ok": v} for c, v in checks]
    summary["ok"] = all(v for _, v in checks)
    for g, t in summary["timing"].items():
        print(f"elastic-smoke: generation {g} members {t['members']}: "
              f"spawn to first step {t['spawn_to_first_step_s']} s, "
              f"teardown {t['teardown_s']} s")
    print(f"elastic-smoke: {'PASS' if summary['ok'] else 'FAIL'}")
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    opts = {"--out": "", "--dev": "gpu:0", "--nproc": "3", "--rounds": "6",
            "--kill-hit": "7", "--conf": "", "--train": "200",
            "--test": "100", "--json": ""}
    keep = "--keep" in args
    if keep:
        args.remove("--keep")
    while args:
        k = args.pop(0)
        if k not in opts or not args:
            print(__doc__)
            return 2
        opts[k] = args.pop(0)
    from cxxnet_tpu_torch.tools.common import tool_device
    tool_device(opts["--dev"])  # raises with no card, naming --dev cpu
    out = opts["--out"]
    tmp = out or tempfile.mkdtemp(prefix="elastic_smoke_")
    try:
        summary = run_smoke(
            tmp, opts["--dev"], int(opts["--nproc"]), int(opts["--rounds"]),
            int(opts["--kill-hit"]), opts["--conf"], int(opts["--train"]),
            int(opts["--test"]))
        if opts["--json"]:
            with open(opts["--json"], "w") as f:
                json.dump(summary, f, indent=2)
        return 0 if summary["ok"] else 1
    finally:
        if not out and not keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
