"""Telemetry end-to-end smoke (the port's copy of
cxxnet_tpu/tools/telemetry_smoke.py): train 2 rounds on synthetic
digits through the port's CLI with log_file/metrics_file armed, inject
one transient io fault, then validate the streams and render the
metrics report.

    python -m cxxnet_tpu_torch.tools.telemetry_smoke [--out DIR] [--keep]
        [--dev DEV]

Exit 0 iff: both streams are valid JSONL; the event stream contains
step AND data span timings, a checkpoint save with a duration, and a
fault retry event; the metrics stream yields per-round rows with a
nonzero fault.retry counter; and metrics_report renders them. It runs on
the card unless `--dev cpu` asks for the CPU. `write_synth_mnist` is the
synthetic set every smoke of the port trains on (the JAX package's
bytes).
"""

from __future__ import annotations

import gzip
import os
import struct
import sys

import numpy as np

from cxxnet_tpu_torch.tools.common import cli_dev, smoke_main


def write_synth_mnist(dirname: str, n: int, seed: int,
                      prefix: str) -> None:
    """Separable 3-class idx-format set: class = f(mean intensity)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, size=n).astype(np.uint8)
    images = np.zeros((n, 6, 6), dtype=np.uint8)
    for i, y in enumerate(labels):
        base = 40 + 80 * int(y)
        images[i] = np.clip(rng.randn(6, 6) * 10 + base, 0, 255)
    with gzip.open(os.path.join(dirname, f"{prefix}-img.gz"), "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 6, 6))
        f.write(images.tobytes())
    with gzip.open(os.path.join(dirname, f"{prefix}-lbl.gz"), "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.tobytes())


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
dev = {dev}
save_model = 1
num_round = 2
max_round = 2
eta = 0.3
metric = error
eval_train = 1
silent = 1
model_dir = {d}/models
log_file = {d}/events.jsonl
metrics_file = {d}/metrics.jsonl
"""


def run_smoke(out_dir: str, device: str) -> int:
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.telemetry.sink import read_jsonl
    from cxxnet_tpu_torch.tools import metrics_report
    from cxxnet_tpu_torch.utils import fault

    write_synth_mnist(out_dir, 256, 0, "train")
    write_synth_mnist(out_dir, 64, 1, "test")
    conf = os.path.join(out_dir, "smoke.conf")
    with open(conf, "w") as f:
        f.write(CONF.format(d=out_dir, dev=cli_dev(device)))

    # one transient io error on the third next(): exercises the retry
    # path so the streams carry a real fault counter/event
    fault.clear()
    fault.inject("io.next", "ioerror", at=3)
    try:
        rc = LearnTask().run([conf, "io_retry_backoff=0.0"])
    finally:
        fault.clear()
    if rc != 0:
        print(f"telemetry_smoke: training failed rc={rc}")
        return 1

    events = list(read_jsonl(os.path.join(out_dir, "events.jsonl")))
    metrics = list(read_jsonl(os.path.join(out_dir, "metrics.jsonl")))
    span_names = {e.get("name") for e in events if e.get("kind") == "span"}
    checks = [
        ("train.step span events", "train.step" in span_names),
        ("train.data span events", "train.data" in span_names),
        ("checkpoint save event with duration",
         any(e.get("kind") == "checkpoint" and e.get("op") == "save"
             and e.get("secs", 0) > 0 for e in events)),
        ("fault retry event",
         any(e.get("kind") == "fault" and e.get("type") == "retry"
             for e in events)),
        ("eval events with parsed values",
         any(e.get("kind") == "eval" and e.get("values")
             for e in events)),
        ("per-round metrics records",
         sum(1 for m in metrics if m.get("kind") == "round") >= 2),
        ("nonzero fault.retry counter in final snapshot",
         any(m.get("kind") == "final"
             and (m.get("metrics") or {}).get("fault.retry", 0) >= 1
             for m in metrics)),
        ("host/pid tags on every record",
         all("host" in r and "pid" in r for r in events + metrics)),
    ]
    ok = True
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
        ok = ok and passed

    agg = metrics_report.aggregate(os.path.join(out_dir, "metrics.jsonl"))
    report = metrics_report.render(agg)
    print(report)
    if not agg["rounds"]:
        print("telemetry_smoke: metrics_report found no rounds")
        ok = False
    print(f"telemetry_smoke: {'PASS' if ok else 'FAIL'} "
          f"({len(events)} events, {len(metrics)} metric records)")
    return 0 if ok else 1


def main(argv=None) -> int:
    return smoke_main("telemetry_smoke", run_smoke, argv)


if __name__ == "__main__":
    sys.exit(main())
