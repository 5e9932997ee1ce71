"""ZeRO smoke: zero_stage = 2 / 3 against 0 must be the SAME run (the
port's counterpart of cxxnet_tpu/tools/zero_smoke.py).

    python -m cxxnet_tpu_torch.tools.zero_smoke [--out DIR] [--keep]
        [--dev DEV]

Trains the tiny synthetic-MNIST MLP through the port's CLI as a
two-rank job under tools/launch_dist (`mesh = data:2`, param_server =
dist) four times, the four jobs side by side - stage 0 (replicated),
stage 2, stage 2 fused with steps_per_dispatch = 4 (chunked staging
and the round-boundary short chunk) and stage 3 - then checks:

- every job's ranks print the same per-round eval lines as stage 0's;
- every job's final checkpoint has stage 0's sha256: the reduce-scatter,
  the cut update and the all-gather are bitwise the replicated update
  (with two ranks each sum has two terms, which add the same in either
  order), and stage 3's gather-on-save keeps the file byte-compatible.

`--dev` is the CLI's `dev` (default `gpu:0`: both ranks on card 0,
over gloo; `cpu` runs here). Prints one `[ok]` / `[FAIL]` line a check
and a summary line; exit 0 iff every check passes.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
from typing import Dict, List

from cxxnet_tpu_torch.tools.telemetry_smoke import write_synth_mnist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONF = """
data = train
iter = mnist
    path_img = "{d}/train-img.gz"
    path_label = "{d}/train-lbl.gz"
    shuffle = 1
iter = end
eval = test
iter = mnist
    path_img = "{d}/test-img.gz"
    path_label = "{d}/test-lbl.gz"
iter = end

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
mesh = data:2
param_server = dist
save_model = 1
save_optimizer = 1
num_round = 3
max_round = 3
eta = 0.3
metric = error
eval_train = 1
silent = 1
"""

RUNS = {"z0": ["zero_stage=0"], "z2": ["zero_stage=2"],
        "z2k4": ["zero_stage=2", "steps_per_dispatch=4"],
        "z3": ["zero_stage=3"]}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(out_dir: str, tag: str, overrides: List[str], dev: str):
    """One two-rank CLI job under launch_dist (not waited for)."""
    mdir = os.path.join(out_dir, f"models_{tag}")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "cxxnet_tpu_torch.tools.launch_dist",
           "-n", "2", "--coordinator", f"127.0.0.1:{_free_port()}", "--",
           sys.executable, "-m", "cxxnet_tpu_torch.main",
           os.path.join(out_dir, "zero_smoke.conf"), f"dev={dev}",
           f"model_dir={mdir}"] + overrides
    return subprocess.Popen(cmd, cwd=out_dir, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, out_dir: str, tag: str) -> dict:
    out, err = proc.communicate(timeout=900)
    path = os.path.join(out_dir, f"models_{tag}", "0003.model")
    sha = ""
    if os.path.exists(path):
        with open(path, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
    return {"rc": proc.returncode, "stderr": err, "sha": sha,
            "evals": sorted(ln for ln in err.splitlines()
                            if re.match(r"\[\d+\]", ln))}


def run_smoke(out_dir: str, dev: str = "gpu:0") -> Dict[str, dict]:
    """Run the four jobs side by side; returns {tag: {rc, sha, evals,
    stderr}} with "ok" (every check passed) under "_checks"."""
    # 288 instances = 9 batches a round at b32, so the K = 4 job chunks
    # as 4 + 4 + 1 and every round crosses the short-chunk path
    write_synth_mnist(out_dir, 288, 0, "train")
    write_synth_mnist(out_dir, 64, 1, "test")
    with open(os.path.join(out_dir, "zero_smoke.conf"), "w") as f:
        f.write(CONF.format(d=out_dir))
    procs = {tag: _start(out_dir, tag, ov, dev) for tag, ov in RUNS.items()}
    runs = {tag: _finish(p, out_dir, tag) for tag, p in procs.items()}
    base = runs["z0"]
    checks = [(f"{tag} run completed", r["rc"] == 0 and bool(r["sha"]))
              for tag, r in runs.items()]
    checks += [
        (f"{tag} final checkpoint sha256 == zero_stage=0",
         bool(base["sha"]) and r["sha"] == base["sha"])
        for tag, r in runs.items() if tag != "z0"]
    checks += [
        (f"{tag} per-round eval lines == zero_stage=0",
         len(base["evals"]) == 6 and r["evals"] == base["evals"])
        for tag, r in runs.items() if tag != "z0"]
    ok = True
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
        ok = ok and bool(passed)
    if not ok:
        for tag, r in runs.items():
            if r["rc"] != 0:
                print(f"--- {tag} stderr tail ---")
                print(r["stderr"][-2000:])
    shas = {tag: r["sha"][:12] for tag, r in runs.items()}
    print(f"zero_smoke: {'PASS' if ok else 'FAIL'} {shas}")
    runs["_checks"] = {"ok": ok, "n": len(checks)}
    return runs


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    dev = "gpu:0"
    if "--dev" in args:
        i = args.index("--dev")
        dev = args[i + 1]
        del args[i:i + 2]
    out = None
    if "--out" in args:
        i = args.index("--out")
        if i + 1 >= len(args):
            print("usage: zero_smoke [--out DIR] [--keep] [--dev DEV]")
            return 2
        out = args[i + 1]
        os.makedirs(out, exist_ok=True)
    keep = "--keep" in args
    tmp = out or tempfile.mkdtemp(prefix="zero_smoke_")
    try:
        return 0 if run_smoke(tmp, dev)["_checks"]["ok"] else 1
    finally:
        if out is None and not keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
