"""Serving smoke (the port's copy of cxxnet_tpu/tools/serve_smoke.py):
`task = serve` must be `task = pred` with a queue.

    python -m cxxnet_tpu_torch.tools.serve_smoke [--out DIR] [--keep]
        [--dev DEV]

Trains the tiny synthetic-MNIST MLP once through the port's CLI
(`python -m cxxnet_tpu_torch.main`), then predicts the test set twice from
the saved checkpoint - once batch-at-a-time (`task = pred`) and once
through the continuous-batching server (`task = serve`,
`serve_rows = 0`: the ragged request-size cycle, so every bucket size
and the round-padding path are exercised) - and asserts:

- identical prediction files line for line (the serving layer's
  bucketing/padding/coalescing provably changes no answer at the
  product surface);
- the serve run's metrics stream carries the `serve.latency_s`
  histogram (p50/p99) and the `serve.queue_depth` gauge - the SLO
  surface of docs/SERVING.md;
- the event stream shows warmup before traffic and a summary after,
  and ragged mode really exercised padding.

Every child runs on the card unless `--dev cpu` asks for the CPU.
Exit 0 iff all checks pass.
"""

from __future__ import annotations

import os
import subprocess
import sys

from cxxnet_tpu_torch.tools.common import cli_dev, run_cli, smoke_main
from cxxnet_tpu_torch.tools.telemetry_smoke import write_synth_mnist

CONF = """
data = train
iter = mnist
    path_img = "{d}/train-img.gz"
    path_label = "{d}/train-lbl.gz"
    shuffle = 1
iter = end
pred = {d}/out.txt
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
dev = {dev}
save_model = 1
num_round = 2
max_round = 2
eta = 0.3
metric = error
silent = 1
"""


def _run_cli(out_dir: str, *overrides: str) -> subprocess.CompletedProcess:
    return run_cli(os.path.join(out_dir, "serve_smoke.conf"), *overrides)


def run_smoke(out_dir: str, device: str) -> int:
    from cxxnet_tpu_torch.telemetry.sink import read_jsonl
    write_synth_mnist(out_dir, 192, 0, "train")
    # 96 test instances = 3 full batches (the mnist iterator only
    # serves whole batches; the ragged REQUEST sizes below are what
    # exercise the serving layer's padding)
    write_synth_mnist(out_dir, 96, 1, "test")
    with open(os.path.join(out_dir, "serve_smoke.conf"), "w") as f:
        f.write(CONF.format(d=out_dir, dev=cli_dev(device)))
    mdir = os.path.join(out_dir, "models")
    model = os.path.join(mdir, "0002.model")
    direct = os.path.join(out_dir, "pred_direct.txt")
    served = os.path.join(out_dir, "pred_serve.txt")
    log = os.path.join(out_dir, "serve_events.jsonl")
    metrics = os.path.join(out_dir, "serve_metrics.jsonl")

    train = _run_cli(out_dir, f"model_dir={mdir}")
    pred = _run_cli(out_dir, "task=pred", f"model_in={model}",
                    f"pred={direct}")
    serve = _run_cli(out_dir, "task=serve", f"model_in={model}",
                     f"pred={served}", "serve_rows=0",
                     "serve_max_batch=8", "serve_replicas=2",
                     f"log_file={log}", f"metrics_file={metrics}")

    def lines(path):
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read().splitlines()

    d_lines, s_lines = lines(direct), lines(served)
    serve_recs = ([r for r in read_jsonl(metrics)
                   if r.get("kind") == "serve"]
                  if os.path.exists(metrics) else [])
    m = serve_recs[-1]["metrics"] if serve_recs else {}
    lat = m.get("serve.latency_s") or {}
    events = ([e for e in read_jsonl(log) if e.get("kind") == "serve"]
              if os.path.exists(log) else [])
    ops = [e.get("op") for e in events]

    checks = [
        ("train run completed", train.returncode == 0
         and os.path.exists(model)),
        ("pred run completed", pred.returncode == 0
         and bool(d_lines)),
        ("serve run completed", serve.returncode == 0
         and bool(s_lines)),
        ("identical predictions (96 lines)",
         d_lines is not None and d_lines == s_lines
         and len(d_lines) == 96),
        ("latency histogram on the metrics stream (p50/p99)",
         lat.get("count", 0) > 0 and lat.get("p50") is not None
         and lat.get("p99") is not None),
        ("queue-depth gauge on the metrics stream",
         "serve.queue_depth" in m),
        ("ragged mode exercised padding",
         m.get("serve.padding_rows", 0) > 0),
        ("event stream: warmup before traffic, summary after",
         "warmup" in ops and "summary" in ops
         and ops.index("warmup") < ops.index("summary")),
    ]
    ok = True
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
        ok = ok and bool(passed)
    if not ok:
        for tag, r in (("train", train), ("pred", pred),
                       ("serve", serve)):
            if r.returncode != 0:
                print(f"--- {tag} stderr tail ---")
                print(r.stderr[-2000:])
    n = len(s_lines or [])
    print(f"serve_smoke: {'PASS' if ok else 'FAIL'} "
          f"({n} predictions, p50 {lat.get('p50')}s, "
          f"p99 {lat.get('p99')}s)")
    return 0 if ok else 1


def main(argv=None) -> int:
    return smoke_main("serve_smoke", run_smoke, argv)


if __name__ == "__main__":
    sys.exit(main())
