"""Canaried-rollout smoke: both judge verdicts under live load.
(The port's copy of cxxnet_tpu/tools/canary_smoke.py.)

    python -m cxxnet_tpu_torch.tools.canary_smoke [--out DIR] [--keep]
        [--dev DEV]

Trains the tiny synthetic-MNIST MLP through the real CLI (two rounds,
two consecutive checkpoints - bitwise-different weights that agree on
nearly every argmax, the realistic canary shape), then drives a live
HTTP server with `canary_frac`/`canary_window` armed through both
verdicts of docs/SERVING.md "Canary runbook":

- service time is pinned with the `serve_dispatch_delay` fault
  injector (as in serve_http_smoke: makes "2x the sustainable rate"
  deterministic across CI machines), and an OPEN-LOOP Poisson storm
  at ~2x sustainable runs long enough to straddle the whole canary
  window;
- PROMOTE leg: the round-2 checkpoint atomically published MID-STORM
  starts a canary (a deterministic request fraction served by the
  candidate through the SAME warmed bucket executables - the
  executable cache must stay flat), the judge auto-promotes at the
  window, zero requests drop (every response a 200, `errors == 0`),
  and post-promote answers match a cold Server restarted on the new
  checkpoint bit for bit;
- ROLLBACK leg: the same checkpoint republished with the
  `canary_divergence` fault armed ("corrupt" NaN-poisons the shadow
  outputs) must be auto-rolled-back (`swap.rolled_back`), with the
  incumbent still serving bitwise-identical answers afterwards;
- every /metrics scrape along the way must be exposition-valid.

Exit 0 iff all checks pass; CI uploads the tallies as artifacts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from cxxnet_tpu_torch.tools.common import cli_dev, run_cli, smoke_main
from cxxnet_tpu_torch.tools.telemetry_smoke import write_synth_mnist

CONF = """
data = train
iter = mnist
    path_img = "{d}/train-img.gz"
    path_label = "{d}/train-lbl.gz"
    shuffle = 1
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

# the same net, sans data/training keys: the in-process servers load
# the CLI-trained checkpoints into this config
NET_CFG = """
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
silent = 1
"""


def _run_cli(out_dir: str, *overrides: str) -> subprocess.CompletedProcess:
    return run_cli(os.path.join(out_dir, "canary_smoke.conf"), *overrides)


def _post(port: int, payload: dict, timeout: float = 120.0):
    """POST /predict; returns (status, headers, parsed body)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _scrape(port: int) -> str:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        return r.read().decode()


def run_smoke(out_dir: str, device: str) -> int:
    from cxxnet_tpu_torch import telemetry
    from cxxnet_tpu_torch.nnet import checkpoint
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Server
    from cxxnet_tpu_torch.telemetry.http import validate_exposition
    from cxxnet_tpu_torch.utils import fault

    write_synth_mnist(out_dir, 192, 0, "train")
    conf = os.path.join(out_dir, "canary_smoke.conf")
    with open(conf, "w") as f:
        f.write(CONF.format(d=out_dir, dev=cli_dev(device)))
    mdir = os.path.join(out_dir, "models")
    ck_old = os.path.join(mdir, "0001.model")
    ck_new = os.path.join(mdir, "0002.model")
    publish = os.path.join(out_dir, "publish.model")

    train = _run_cli(out_dir, f"model_dir={mdir}")
    trained = (train.returncode == 0 and os.path.exists(ck_old)
               and os.path.exists(ck_new))

    checks = [("train run produced two checkpoints", trained)]
    tally = {"200": 0, "other": 0}
    bad_scrapes = []
    stats = {}
    canary_routed = 0
    promoted = cache_flat = post_matches_cold = False
    rolled_back = incumbent_intact = False

    if trained:
        tr = NetTrainer(cfg=NET_CFG, device=device)
        with open(ck_old, "rb") as f:
            tr.load_model(f)
        srv = Server(tr, device=device, max_batch=4, max_wait_ms=2.0, replicas=1,
                     http_port=0, swap_watch=publish,
                     swap_poll_ms=25.0, canary_frac=0.5,
                     canary_window=1.5)
        srv.warmup()
        n_warm = srv.executable_cache_size()
        # pin the service time (50ms/dispatch): sustainable capacity
        # is then deterministic on every CI machine
        fault.clear()
        for k in range(4000):
            fault.inject("serve_dispatch_delay", "delay", "0.05",
                         at=k + 1)
        srv.start()
        port = srv.metrics_server.port
        rng = np.random.RandomState(31)
        probe = rng.randn(4, 36).astype(np.float32).tolist()
        payload = {"data": probe, "raw": True}
        lock = threading.Lock()
        pre_swap = _post(port, payload)[2].get("outputs")
        bad_scrapes.extend(validate_exposition(_scrape(port)))

        # --- promote leg: 2x-sustainable Poisson storm straddling the
        # whole canary window, checkpoint published mid-storm --------
        sustainable_rps = (1 * 4 / 0.05) / 4.0  # 4-row requests
        n_req = 120
        gaps = rng.exponential(1.0 / (2.0 * sustainable_rps), n_req)
        arrivals = np.cumsum(gaps)

        def fire(i):
            code, _, _ = _post(port, payload)
            with lock:
                tally["200" if code == 200 else "other"] += 1

        threads = []
        t_start = time.perf_counter()
        for i in range(n_req):
            pause = t_start + float(arrivals[i]) - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            if i == n_req // 4:
                # mid-storm: atomically publish the round-2 weights -
                # the watcher starts a canary while the storm runs
                checkpoint.publish_model(ck_new, publish)
            t = threading.Thread(target=fire, args=(i,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=300)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if srv.stats()["canary_promoted"] >= 1:
                break
            time.sleep(0.05)
        mid = srv.stats()
        promoted = (mid["canary_promoted"] == 1 and mid["swaps"] == 1
                    and mid["canary_rolled_back"] == 0)
        canary_routed = mid["canary_requests"]
        cache_flat = srv.executable_cache_size() == n_warm
        post_swap = _post(port, payload)[2].get("outputs")
        bad_scrapes.extend(validate_exposition(_scrape(port)))

        # --- rollback leg: republish with poisoned shadow outputs ---
        fault.clear()
        for k in range(50):
            fault.inject("canary_divergence", "corrupt", at=k + 1)
        checkpoint.publish_model(ck_new, publish)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if srv.stats()["canary_rolled_back"] >= 1:
                break
            # a light trickle keeps shadow samples flowing
            _post(port, payload)
            time.sleep(0.05)
        fault.clear()
        end = srv.stats()
        rolled_back = (end["canary_rolled_back"] == 1
                       and end["swaps"] == 1)
        post_rollback = _post(port, payload)[2].get("outputs")
        incumbent_intact = post_rollback == post_swap
        bad_scrapes.extend(validate_exposition(_scrape(port)))
        stats = srv.stop()

        # cold reference: a fresh server over the promoted checkpoint
        tr_new = NetTrainer(cfg=NET_CFG, device=device)
        with open(ck_new, "rb") as f:
            tr_new.load_model(f)
        srv2 = Server(tr_new, device=device, max_batch=4, max_wait_ms=2.0,
                      replicas=1, http_port=0)
        srv2.warmup()
        srv2.start()
        cold = _post(srv2.metrics_server.port, payload)[2].get(
            "outputs")
        srv2.stop()
        post_matches_cold = (post_swap == cold
                             and post_swap != pre_swap)
        telemetry.reset_for_tests()

        checks += [
            ("mid-storm publish canaried + auto-promoted at window "
             "(swaps == 1)", promoted),
            ("canary traffic routed to the candidate side",
             canary_routed > 0),
            ("zero drops across storm + both verdicts (all 200s, "
             "errors == 0)",
             tally["other"] == 0 and stats.get("errors") == 0),
            ("executable cache flat (both sides share warmed "
             "executables)", cache_flat),
            ("post-promote answers == cold restart on the new "
             "checkpoint", post_matches_cold),
            ("poisoned republish auto-rolled-back (swaps stays 1)",
             rolled_back),
            ("incumbent bitwise-unchanged after rollback",
             incumbent_intact),
            ("every /metrics scrape exposition-valid",
             not bad_scrapes),
        ]

    ok = True
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
        ok = ok and bool(passed)
    if not trained:
        print("--- train stderr tail ---")
        print(train.stderr[-2000:])
    for line in bad_scrapes[:5]:
        print(f"  bad exposition line: {line}")
    with open(os.path.join(out_dir, "canary_summary.json"), "w") as f:
        json.dump({"codes": tally, "canary_requests": canary_routed,
                   "server_stats": stats}, f, indent=1, default=str)
    print(f"canary_smoke: {'PASS' if ok else 'FAIL'} "
          f"(codes {tally}, canary_requests {canary_routed})")
    return 0 if ok else 1


def main(argv=None) -> int:
    return smoke_main("canary_smoke", run_smoke, argv)


if __name__ == "__main__":
    sys.exit(main())
