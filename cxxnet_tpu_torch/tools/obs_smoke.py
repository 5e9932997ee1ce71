"""Observability-plane end-to-end smoke (the port's copy of
cxxnet_tpu/tools/obs_smoke.py; docs/OBSERVABILITY.md).

    python -m cxxnet_tpu_torch.tools.obs_smoke [--out DIR] [--keep]
        [--dev DEV] [--parity-base DIR]

A short training through the port's CLI
with the live plane armed (``metrics_port`` + ``watchdog_secs`` + an
absence alert rule) and a STALL injected mid-run (a ``delay`` fault at
the ``stage_batch`` fault point - the prefetch worker sleeps, the
update thread starves, ``train.step`` beacons stop: exactly the shape
of the hung-TPU rounds that motivated the watchdog). A poller thread
scrapes ``/healthz`` + ``/metrics`` + ``/varz`` throughout.

Exit 0 iff:

- every ``/metrics`` scrape parses as Prometheus text exposition
  (promtool-style line grammar) with the right content type;
- ``/healthz`` flips 200 -> 503 during the stall and recovers to 200
  once training resumes (the watchdog + alert hysteresis contract);
- the event stream carries the watchdog ``stall_dump`` (with thread
  stacks naming the sleeping fault point) and the alert rule's
  ``firing`` AND ``resolved`` events;
- the metrics stream ends with a ``final`` snapshot and a nonzero
  ``watchdog.stalls`` / ``alert.fired``;
- with ``--parity-base DIR`` (CI passes a checkout of the base
  commit): an UNARMED run of the same conf produces byte-identical
  stdout+stderr under this tree and the base tree - the pinned
  contract that the whole plane costs nothing when off.

It runs on the card unless `--dev cpu` asks for the CPU.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from cxxnet_tpu_torch.tools.common import REPO, cli_dev, cli_env, tool_device
from cxxnet_tpu_torch.tools.telemetry_smoke import write_synth_mnist

STALL_SECS = 8.0
# watchdog strictly below the absence rule's for_secs: the stack dump
# must land BEFORE the alert fires (the ordering the issue pins)
WATCHDOG_SECS = 2.0
ABSENCE_SECS = 4.0


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
num_round = 5
max_round = 5
eta = 0.3
metric = error
eval_train = 1
silent = 1
model_dir = {d}/models
"""

RULES = [{
    "name": "train-stalled",
    "type": "absence",
    "beacon": "train.step",
    "for_secs": ABSENCE_SECS,
}]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Poller(threading.Thread):
    """Samples /healthz (code timeline), /metrics (bodies + content
    type) and /varz while the run is live."""

    def __init__(self, port: int) -> None:
        super().__init__(name="obs-smoke-poller", daemon=True)
        self.base = f"http://127.0.0.1:{port}"
        self.stop = threading.Event()
        # sample fields shared with the main thread (read after
        # stop+join, but the lock makes the handoff explicit - the
        # GL012 lock-discipline rule flags bare cross-thread writes)
        self._lock = threading.Lock()
        self.codes = []          # de-duplicated /healthz code timeline
        self.metrics_bodies = []  # (healthz_code_at_sample, body)
        self.content_type = ""
        self.varz = None
        self.errors = 0

    def _healthz(self):
        try:
            with urllib.request.urlopen(self.base + "/healthz",
                                        timeout=1.0) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
        except OSError:
            return None

    def run(self) -> None:
        while not self.stop.wait(0.1):
            code = self._healthz()
            if code is None:
                continue  # server not up yet / already gone
            if not self.codes or self.codes[-1] != code:
                self.codes.append(code)
            try:
                with urllib.request.urlopen(self.base + "/metrics",
                                            timeout=1.0) as r:
                    ctype = r.headers.get("Content-Type", "")
                    body = r.read().decode()
                with self._lock:
                    self.content_type = ctype
                    if (len(self.metrics_bodies) < 200
                            and (not self.metrics_bodies
                                 or self.metrics_bodies[-1][0] != code)):
                        self.metrics_bodies.append((code, body))
                    self.metrics_bodies[-1] = (code, body)  # keep newest
                with urllib.request.urlopen(self.base + "/varz",
                                            timeout=1.0) as r:
                    varz = json.load(r)
                with self._lock:
                    self.varz = varz
            except (OSError, ValueError):
                with self._lock:
                    self.errors += 1


def run_armed(out_dir: str, device: str) -> int:
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.telemetry.http import validate_exposition
    from cxxnet_tpu_torch.telemetry.sink import read_jsonl
    from cxxnet_tpu_torch.utils import fault

    conf = os.path.join(out_dir, "obs_smoke.conf")
    with open(conf, "w") as f:
        f.write(CONF.format(d=out_dir, dev=cli_dev(device)))
    rules = os.path.join(out_dir, "rules.json")
    with open(rules, "w") as f:
        json.dump(RULES, f)
    port = _free_port()

    # the injected hang: the prefetch worker sleeps inside
    # stage_batch, train.step beacons stop, the watchdog dumps stacks
    # showing exactly that frame - the forensics the hung-TPU rounds
    # never had. Hit 4 lands mid-round-1 (8 batches/round), leaving
    # 4+ rounds of live run for the recovery half of the proof
    fault.clear()
    fault.inject("stage_batch", "delay", arg=str(STALL_SECS), at=4)
    # pace the remaining batches (a tiny-MLP CPU round is ~30 ms -
    # nothing like a real training cadence): a modest per-batch delay
    # keeps the run alive long enough after the stall for the
    # recovery half of the proof (watchdog clears, alert resolves,
    # /healthz back to 200) to be OBSERVED by the poller, not just
    # recorded in the streams
    for hit in range(5, 5 * 8 + 1):
        fault.inject("stage_batch", "delay", arg="0.08", at=hit)
    poller = _Poller(port)
    poller.start()
    try:
        rc = LearnTask().run([
            conf,
            f"log_file={out_dir}/events.jsonl",
            f"metrics_file={out_dir}/metrics.jsonl",
            f"metrics_port={port}",
            f"watchdog_secs={WATCHDOG_SECS}",
            f"alert_rules={rules}",
        ])
    finally:
        fault.clear()
        time.sleep(0.25)  # let the poller observe the recovered tail
        poller.stop.set()
        poller.join(timeout=5.0)
    if rc != 0:
        print(f"obs_smoke: training failed rc={rc}")
        return 1

    events = list(read_jsonl(os.path.join(out_dir, "events.jsonl")))
    metrics = list(read_jsonl(os.path.join(out_dir, "metrics.jsonl")))
    dumps = [e for e in events if e.get("kind") == "watchdog"
             and e.get("op") == "stall_dump"]
    recovers = [e for e in events if e.get("kind") == "watchdog"
                and e.get("op") == "recovered"]
    alerts = [e for e in events if e.get("kind") == "alert"]
    finals = [m for m in metrics if m.get("kind") == "final"]

    def subsequence(seq, want):
        it = iter(seq)
        return all(any(x == w for x in it) for w in want)

    bad_lines = []
    for _, body in poller.metrics_bodies:
        bad_lines.extend(validate_exposition(body))
    last_metrics = (poller.metrics_bodies[-1][1]
                    if poller.metrics_bodies else "")
    checks = [
        ("healthz scraped", len(poller.codes) >= 1),
        ("healthz flipped 200 -> 503 -> 200",
         subsequence(poller.codes, [200, 503, 200])),
        ("prometheus content type",
         poller.content_type.startswith("text/plain")
         and "version=0.0.4" in poller.content_type),
        ("every /metrics scrape parses (promtool line grammar)",
         bool(poller.metrics_bodies) and not bad_lines),
        ("/metrics carries the step summary + checkpoint counter",
         "cxxnet_train_step_s" in last_metrics
         and "cxxnet_checkpoint_saves_total" in last_metrics),
        ("/varz is a metrics-stream-schema record",
         isinstance(poller.varz, dict)
         and poller.varz.get("kind") == "varz"
         and isinstance(poller.varz.get("metrics"), dict)
         and "ts" in poller.varz and "host" in poller.varz),
        ("watchdog stall dump event with thread stacks",
         any("stage_batch" in (d.get("stacks") or "")
             for d in dumps)),
        ("watchdog recovered event", len(recovers) >= 1),
        ("alert fired", any(a.get("state") == "firing"
                            and a.get("name") == "train-stalled"
                            for a in alerts)),
        ("alert resolved", any(a.get("state") == "resolved"
                               and a.get("name") == "train-stalled"
                               for a in alerts)),
        ("stall dump precedes the alert firing",
         bool(dumps) and any(
             a.get("state") == "firing"
             and a.get("ts", 0) >= dumps[0].get("ts", 0)
             for a in alerts)),
        ("final metrics snapshot with stall counters",
         bool(finals)
         and finals[-1]["metrics"].get("watchdog.stalls", 0) >= 1
         and finals[-1]["metrics"].get("alert.fired", 0) >= 1),
    ]
    failed = [name for name, ok in checks if not ok]
    for name, ok in checks:
        print(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if bad_lines:
        print("  malformed exposition lines:")
        for line in bad_lines[:10]:
            print(f"    {line!r}")
    if failed:
        print(f"obs_smoke: FAILED: {failed}")
        print(f"  healthz timeline: {poller.codes}")
        return 1
    print(f"obs_smoke: armed run ok (healthz timeline "
          f"{poller.codes}, {len(dumps)} stall dump(s), "
          f"{len(alerts)} alert event(s))")
    return 0


def run_parity(out_dir: str, base_dir: str, device: str) -> int:
    """Unarmed byte-parity A/B: the same conf (no observability keys)
    run under THIS tree and under `base_dir` (a checkout of the base
    commit) must produce byte-identical stdout and stderr."""
    here = REPO
    if not os.path.isdir(os.path.join(base_dir, "cxxnet_tpu_torch")):
        print(f"obs_smoke: parity base {base_dir!r} has no "
              "cxxnet_tpu_torch/ - skipping the A/B leg")
        return 0
    outs = []
    for tag, tree in (("head", here), ("base", base_dir)):
        d = os.path.join(out_dir, f"parity-{tag}")
        os.makedirs(d, exist_ok=True)
        write_synth_mnist(d, 256, 0, "train")
        write_synth_mnist(d, 64, 1, "test")
        conf = os.path.join(d, "parity.conf")
        with open(conf, "w") as f:
            f.write(CONF.format(d=d, dev=cli_dev(device)).replace(
                "num_round = 5", "num_round = 2").replace(
                "max_round = 5", "max_round = 2"))
        env = dict(cli_env(), PYTHONPATH=os.path.abspath(tree))
        p = subprocess.run(
            [sys.executable, "-m", "cxxnet_tpu_torch.main", conf],
            capture_output=True, env=env, cwd=d, timeout=600)
        if p.returncode != 0:
            print(f"obs_smoke: parity run [{tag}] failed "
                  f"rc={p.returncode}:\n{p.stderr.decode()[-2000:]}")
            return 1
        outs.append((tag, p.stdout, p.stderr))
    (_, out_a, err_a), (_, out_b, err_b) = outs
    if out_a != out_b or err_a != err_b:
        print("obs_smoke: UNARMED OUTPUT DIVERGED from base:")
        if out_a != out_b:
            print(f"  stdout head: {out_a[:400]!r}")
            print(f"  stdout base: {out_b[:400]!r}")
        if err_a != err_b:
            print(f"  stderr head: {err_a[:400]!r}")
            print(f"  stderr base: {err_b[:400]!r}")
        return 1
    print("obs_smoke: unarmed run byte-identical to base "
          f"({len(out_a)} stdout + {len(err_a)} stderr bytes)")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = ""
    base_dir = ""
    keep = "--keep" in argv
    if "--out" in argv:
        out_dir = argv[argv.index("--out") + 1]
    if "--parity-base" in argv:
        base_dir = argv[argv.index("--parity-base") + 1]
    device = tool_device(argv[argv.index("--dev") + 1]
                         if "--dev" in argv else "")
    tmp = None
    if not out_dir:
        tmp = tempfile.TemporaryDirectory(prefix="obs_smoke_")
        out_dir = tmp.name
    os.makedirs(out_dir, exist_ok=True)
    try:
        write_synth_mnist(out_dir, 256, 0, "train")
        write_synth_mnist(out_dir, 64, 1, "test")
        rc = run_armed(out_dir, device)
        if rc == 0 and base_dir:
            rc = run_parity(out_dir, base_dir, device)
        return rc
    finally:
        if tmp is not None and not keep:
            tmp.cleanup()


if __name__ == "__main__":
    sys.exit(main())
