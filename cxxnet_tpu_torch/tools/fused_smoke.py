"""Fused-dispatch smoke: steps_per_dispatch = 4 against 1 must be the
SAME training run (the port's copy of cxxnet_tpu/tools/fused_smoke.py).

    python -m cxxnet_tpu_torch.tools.fused_smoke [--out DIR] [--keep]
        [--dev DEV] [--conf CONF] [--train-n N] [k=v ...]

Trains twice through the port's CLI (`python -m cxxnet_tpu_torch.main`),
the two runs side by side - once streamed (steps_per_dispatch = 1), once
fused (= 4, through the chunked staging prefetcher and the
round-boundary short chunk) - with telemetry armed, then checks:

- identical final checkpoint SHA-256;
- identical per-round eval lines on stderr;
- the fused run's event stream carries `train.chunk` spans with one
  loss per microstep, as many microsteps as the streamed run's
  `train.step` spans, and a short chunk where a round's batch count is
  not a multiple of 4.

The default workload is a tiny synthetic-MNIST MLP (288 training
images: 9 batches a round, chunks of 4 + 4 + 1). `--conf` runs a conf
file instead from DIR, whose `./data/` then holds synthetic MNIST-format
`train-*` (N images, `--train-n`) and `t10k-*` (200) sets - what
examples/MNIST and examples/LongSeq confs read. Both runs print their
kernel launch counts (silent = 0), returned by `run_smoke`. `--dev`
is passed to the CLI as `dev` (default: the conf's own, the card);
trailing `k=v` pairs reach both runs. Exit 0 iff every check passes.
"""

from __future__ import annotations

import ast
import gzip
import hashlib
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
from typing import Dict, List

import numpy as np

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
save_model = 1
num_round = 3
max_round = 3
eta = 0.3
metric = error
eval_train = 1
"""


def write_digits(dirname: str, n: int, seed: int, prefix: str) -> None:
    """A 28 x 28 MNIST-format set (`<prefix>-images-idx3-ubyte.gz` and
    labels): noise plus a class-dependent bright block."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = np.clip(rng.randn(n, 28, 28) * 60 + 100, 0, 255)
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 5)
        images[i, r * 10 + 2:r * 10 + 10, c * 5 + 1:c * 5 + 6] += 60
    _write_idx(dirname, f"{prefix}-images-idx3-ubyte.gz",
               f"{prefix}-labels-idx1-ubyte.gz",
               np.clip(images, 0, 255).astype(np.uint8), labels)


def _write_idx(dirname, img_name, lbl_name, images, labels) -> None:
    n, h, w = images.shape
    with gzip.open(os.path.join(dirname, img_name), "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, h, w))
        f.write(images.tobytes())
    with gzip.open(os.path.join(dirname, lbl_name), "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())


def read_events(path: str) -> List[dict]:
    from cxxnet_tpu_torch.telemetry.sink import read_jsonl
    return list(read_jsonl(path)) if os.path.exists(path) else []


def _run_cli(out_dir: str, conf: str, tag: str, k: int,
             extra: List[str]) -> dict:
    """One CLI child; returns its artifacts."""
    mdir = os.path.join(out_dir, f"models_{tag}")
    log = os.path.join(out_dir, f"events_{tag}.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", conf,
         f"model_dir={mdir}", f"steps_per_dispatch={k}", "silent=0",
         f"log_file={log}",
         f"metrics_file={os.path.join(out_dir, f'metrics_{tag}.jsonl')}"]
        + extra, cwd=out_dir, env=env, capture_output=True, text=True,
        timeout=900)
    models = sorted(n for n in os.listdir(mdir)
                    if re.fullmatch(r"\d{4}\.model", n)) \
        if os.path.isdir(mdir) else []
    sha = ""
    if models:
        with open(os.path.join(mdir, models[-1]), "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
    m = re.search(r"kernel launches (\{.*\})", r.stdout)
    return {
        "rc": r.returncode, "stdout": r.stdout, "stderr": r.stderr,
        "sha": sha, "log": log,
        "launches": ast.literal_eval(m.group(1)) if m else {},
        "evals": [ln for ln in r.stderr.splitlines()
                  if ln.startswith("[")],
    }


def _round_steps(events: List[dict], name: str) -> Dict[int, List[int]]:
    """{round: [microsteps of each span named `name`]}."""
    out: Dict[int, List[int]] = {}
    for e in events:
        if e.get("kind") == "span" and e.get("name") == name:
            out.setdefault(e.get("round"), []).append(e.get("steps", 1))
    return out


def run_smoke(out_dir: str, dev: str = "", conf: str = "",
              train_n: int = 288, extra=()) -> dict:
    """Both runs and the checks; returns {"ok", "checks", "k1", "k4"}
    (each run's artifacts, launch counts among them)."""
    extra = list(extra) + ([f"dev={dev}"] if dev else [])
    if conf:
        data = os.path.join(out_dir, "data")
        os.makedirs(data, exist_ok=True)
        write_digits(data, train_n, 3, "train")
        write_digits(data, 200, 4, "t10k")
        path = os.path.join(out_dir, os.path.basename(conf))
        if os.path.abspath(conf) != os.path.abspath(path):
            shutil.copyfile(conf, path)
    else:
        write_synth_mnist(out_dir, train_n, 0, "train")
        write_synth_mnist(out_dir, 64, 1, "test")
        path = os.path.join(out_dir, "fused_smoke.conf")
        with open(path, "w") as f:
            f.write(CONF.format(d=out_dir))
    # the two runs share nothing but their inputs: side by side
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(_run_cli, out_dir, path, tag, k, extra)
                for tag, k in (("k1", 1), ("k4", 4))]
        streamed, fused = (f.result() for f in runs)
    steps = _round_steps(read_events(streamed["log"]), "train.step")
    chunks = _round_steps(read_events(fused["log"]), "train.chunk")
    flat = [c for r in sorted(chunks) for c in chunks[r]]
    loss_ok = all(len(e.get("loss", [])) == e.get("steps")
                  for e in read_events(fused["log"])
                  if e.get("name") == "train.chunk")
    want_short = any(len(v) % 4 for v in steps.values())
    checks = [
        ("K=1 run completed", streamed["rc"] == 0 and bool(streamed["sha"])),
        ("K=4 run completed", fused["rc"] == 0 and bool(fused["sha"])),
        ("identical final checkpoint sha256",
         bool(streamed["sha"]) and streamed["sha"] == fused["sha"]),
        ("identical per-round eval lines",
         bool(streamed["evals"]) and streamed["evals"] == fused["evals"]),
        ("train.chunk spans cover the streamed run's microsteps, round "
         "by round",
         bool(flat) and {r: sum(v) for r, v in chunks.items()}
         == {r: len(v) for r, v in steps.items()}
         and all(0 < c <= 4 for c in flat)),
        ("chunk spans carry one loss per microstep", bool(flat) and loss_ok),
        ("round-boundary short chunk present where a round's batches "
         "are not a multiple of 4",
         any(c < 4 for c in flat) == want_short),
    ]
    ok = all(bool(p) for _, p in checks)
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
    if not ok:
        for tag, run in (("k1", streamed), ("k4", fused)):
            if run["rc"] != 0:
                print(f"--- {tag} stderr tail ---")
                print(run["stderr"][-2000:])
    print(f"fused_smoke: {'PASS' if ok else 'FAIL'} "
          f"(sha {streamed['sha'][:12]} vs {fused['sha'][:12]}, "
          f"{len(flat)} chunk spans {flat}, launches K=1 "
          f"{streamed['launches']} K=4 {fused['launches']})")
    return {"ok": ok, "checks": checks, "k1": streamed, "k4": fused,
            "chunks": flat}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--out", "--dev", "--conf", "--train-n"):
        if flag in args:
            i = args.index(flag)
            if i + 1 >= len(args):
                print("usage: fused_smoke [--out DIR] [--keep] [--dev DEV] "
                      "[--conf CONF] [--train-n N] [k=v ...]")
                return 2
            opts[flag] = args[i + 1]
            del args[i:i + 2]
    keep = "--keep" in args
    extra = [a for a in args if "=" in a]
    kw = dict(dev=opts.get("--dev", ""), conf=opts.get("--conf", ""),
              train_n=int(opts.get("--train-n", 288)), extra=extra)
    if "--out" in opts:
        os.makedirs(opts["--out"], exist_ok=True)
        return 0 if run_smoke(opts["--out"], **kw)["ok"] else 1
    if keep:
        d = tempfile.mkdtemp(prefix="fused_smoke_")
        ok = run_smoke(d, **kw)["ok"]
        print(f"fused_smoke: artifacts kept in {d}")
        return 0 if ok else 1
    with tempfile.TemporaryDirectory() as d:
        return 0 if run_smoke(d, **kw)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
