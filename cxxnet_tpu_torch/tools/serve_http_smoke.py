"""Production serving-front smoke: overload + hot-swap end to end.
(The port's copy of cxxnet_tpu/tools/serve_http_smoke.py.)

    python -m cxxnet_tpu_torch.tools.serve_http_smoke [--out DIR] [--keep]
        [--dev DEV]

Trains the tiny synthetic-MNIST MLP through the real CLI (two rounds,
two checkpoints with genuinely different weights), then drives a live
HTTP server (`Server(http_port=..., queue_limit=..., swap_watch=...)`)
through the overload matrix of docs/SERVING.md "Serving over HTTP":

- the `serve_dispatch_delay` fault injector pins every dispatch to a
  fixed service time first: the tiny MLP is otherwise so fast that a
  GIL-bound python client can never exceed capacity, and "2x the
  sustainable rate" would depend on the CI machine. With service time
  pinned, sustainable capacity is deterministic everywhere;
- an uncontended leg measures the baseline p99 (sequential) and the
  sustainable rate (concurrent closed-loop burst - a single blocked
  client measures latency, not capacity), and every /metrics scrape
  must be exposition-valid;
- an OPEN-LOOP storm at ~2x sustainable past `queue_limit` must shed
  (429 + Retry-After observed) while the ACCEPTED requests keep p99
  within 3x uncontended - bounded latency is what shedding buys. Both
  legs read latency on the client's clock, so TCP accept and the listen
  backlog count too, and both legs' clients run in a process of their
  own (CLIENT): the storm's 160 client threads do not share the
  server's interpreter lock, so what the bound reads is the server's
  queue and the pinned service, not the client's own work;
- a fresh checkpoint atomically published MID-STORM must be picked up
  live (swap event, zero errored requests - every response a 200 or a
  429, never a 5xx) and the post-swap answers must match a cold
  Server restarted on the new checkpoint bit for bit;
- a torn publish (CXXNET_FAULT `swap_torn_checkpoint:corrupt` writes
  half the bytes, trailer missing) must be REJECTED (`swap.rejected`)
  with serving uninterrupted on the last good weights.

Exit 0 iff all checks pass; CI uploads the response-code tallies and
latency summaries as artifacts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


# the pinned service time of a dispatch. The JAX tool pins 30 ms; here
# 100 ms, so that the pin and not the host sets the latencies the storm
# bound compares: an accepted request waits at most about two service
# times against one uncontended, and a host busy with other work (a
# test run beside it) adds its own delays to both legs, which 30 ms
# does not dwarf. An unbounded queue at 2x overload still waits tens of
# service times.
SERVICE_S = 0.1


# The client of the uncontended and storm legs, run in a process of its
# own (stdlib only; its spec is argv[1] as JSON). It prints "publish"
# when the storm reaches its mid-storm publish, for the server's process
# to publish the new checkpoint, then one JSON line of readings.
CLIENT = r"""
import json, sys, threading, time, urllib.error, urllib.request

spec = json.loads(sys.argv[1])
body = json.dumps(spec["payload"]).encode()


def post():
    req = urllib.request.Request(
        "http://127.0.0.1:%d/predict" % spec["port"], data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120.0) as r:
            r.read()
            return r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, dict(e.headers)
    except OSError:
        return 0, {}


lock = threading.Lock()
tally = {"200": 0, "429": 0, "other": 0}
uncont, storm = [], []
shed = [0]
retry_after = [False]


def timed(sink, t_start=None):
    ts = time.perf_counter()
    code, headers = post()
    dt = (time.perf_counter() - ts) * 1e3
    with lock:
        tally[str(code) if str(code) in tally else "other"] += 1
        if code == 200:
            sink.append(dt if t_start is None else
                        (round(ts - t_start, 4), round(dt, 2)))
        elif code == 429 and t_start is not None:
            shed[0] += 1
            if "Retry-After" in headers:
                retry_after[0] = True


for _ in range(spec["n_seq"]):
    timed(uncont)
threads = []
t_start = time.perf_counter()
t_publish = None
for i, at in enumerate(spec["arrivals"]):
    pause = t_start + at - time.perf_counter()
    if pause > 0:
        time.sleep(pause)
    if i == spec["publish_at"]:
        t_publish = time.perf_counter() - t_start
        print("publish", flush=True)
    t = threading.Thread(target=timed, args=(storm, t_start), daemon=True)
    t.start()
    threads.append(t)
for t in threads:
    t.join(timeout=300)
print(json.dumps({"uncont": uncont, "storm": storm, "tally": tally,
                  "shed": shed[0], "retry_after": retry_after[0],
                  "t_publish": t_publish}), flush=True)
"""


def _run_clients(port: int, payload: dict, n_seq: int, arrivals,
                 publish_at: int, publish) -> dict:
    """Run CLIENT in its own process against `port`; call `publish()`
    when it reaches the storm's request `publish_at`; its readings."""
    spec = {"port": port, "payload": payload, "n_seq": n_seq,
            "arrivals": [float(a) for a in arrivals],
            "publish_at": publish_at}
    proc = subprocess.Popen([sys.executable, "-c", CLIENT, json.dumps(spec)],
                            stdout=subprocess.PIPE, text=True)
    try:
        out = None
        for line in proc.stdout:
            if line.strip() == "publish":
                publish()
            else:
                out = json.loads(line)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or out is None:
        raise RuntimeError(f"serve_http_smoke: the client process failed "
                           f"(exit code {proc.returncode})")
    return out


def _run_cli(out_dir: str, *overrides: str) -> subprocess.CompletedProcess:
    return run_cli(os.path.join(out_dir, "serve_http_smoke.conf"), *overrides)


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


def _p99(lat_ms: list) -> float:
    if not lat_ms:
        return 0.0
    s = sorted(lat_ms)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def run_smoke(out_dir: str, device: str) -> int:
    from cxxnet_tpu_torch import telemetry
    from cxxnet_tpu_torch.nnet import checkpoint
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Server
    from cxxnet_tpu_torch.telemetry.http import validate_exposition
    from cxxnet_tpu_torch.utils import fault

    write_synth_mnist(out_dir, 192, 0, "train")
    conf = os.path.join(out_dir, "serve_http_smoke.conf")
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
    tally = {"200": 0, "429": 0, "other": 0}
    storm_p99 = uncont_p99 = 0.0
    t_publish = None
    # (start after the storm began, ms) of each accepted request
    acc_at = []
    bad_scrapes = []
    stats = {}
    swap_before_storm_end = post_matches_cold = served_through_torn = \
        saw_retry_after = False

    if trained:
        tr = NetTrainer(cfg=NET_CFG, device=device)
        with open(ck_old, "rb") as f:
            tr.load_model(f)
        srv = Server(tr, device=device, max_batch=8, max_wait_ms=2.0, replicas=2,
                     http_port=0, queue_limit=8,
                     swap_watch=publish, swap_poll_ms=25.0)
        srv.warmup()
        # pin the service time (SERVICE_S a dispatch), armed for far
        # more hits than the whole smoke dispatches
        fault.clear()
        for k in range(2000):
            fault.inject("serve_dispatch_delay", "delay", str(SERVICE_S),
                         at=k + 1)
        srv.start()
        port = srv.metrics_server.port
        rng = np.random.RandomState(29)
        probe = rng.randn(4, 36).astype(np.float32).tolist()
        payload = {"data": probe, "raw": True}
        pre_swap = _post(port, payload)[2].get("outputs")
        bad_scrapes.extend(validate_exposition(_scrape(port)))

        # --- leg 1: uncontended p99, sequential ----------------------
        # --- leg 2: open-loop storm at ~2x + mid-storm publish ------
        # both from the client process. With service time pinned at
        # SERVICE_S a dispatch, sustainable capacity is known
        # analytically: replicas * max_batch rows per dispatch window,
        # in 4-row requests
        sustainable_rps = (2 * 8 / SERVICE_S) / 4.0
        n_req = 160
        gaps = rng.exponential(1.0 / (2.0 * sustainable_rps), n_req)
        # mid-storm: atomically publish the round-2 weights to the
        # watched path - the poller must pick it up while the storm is
        # still running
        got = _run_clients(port, payload, 40, np.cumsum(gaps), n_req // 3,
                           lambda: checkpoint.publish_model(ck_new, publish))
        tally.update(got["tally"])
        uncont_p99 = _p99(got["uncont"])
        acc_at = [tuple(r) for r in got["storm"]]
        acc_lat = [dt for _, dt in acc_at]
        storm_shed, saw_retry_after = got["shed"], got["retry_after"]
        t_publish = got["t_publish"]
        swap_before_storm_end = srv.stats()["swaps"] >= 1
        storm_p99 = _p99(acc_lat)
        bad_scrapes.extend(validate_exposition(_scrape(port)))

        # --- leg 3: post-swap answers == cold restart on ck_new -----
        post_swap = _post(port, payload)[2].get("outputs")

        # --- leg 4: torn publish rejected, serving uninterrupted ----
        # clear first: hit counters only tick while faults are armed,
        # and the delay entries armed above mean the mid-storm publish
        # already consumed this point's hit 1
        fault.clear()
        fault.inject("swap_torn_checkpoint", "corrupt")
        try:
            checkpoint.publish_model(ck_new, publish)
        finally:
            fault.clear()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if srv.stats()["swap_rejected"] >= 1:
                break
            time.sleep(0.05)
        code, _, body = _post(port, payload)
        served_through_torn = (
            srv.stats()["swap_rejected"] >= 1 and code == 200
            and body.get("outputs") == post_swap)
        bad_scrapes.extend(validate_exposition(_scrape(port)))
        stats = srv.stop()

        tr_new = NetTrainer(cfg=NET_CFG, device=device)
        with open(ck_new, "rb") as f:
            tr_new.load_model(f)
        srv2 = Server(tr_new, device=device, max_batch=8, max_wait_ms=2.0,
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
            ("storm shed: 429s observed with Retry-After",
             storm_shed > 0 and saw_retry_after),
            ("storm accepted requests resolved (200s on both sides "
             "of the swap)", tally["200"] >= 41 and bool(acc_lat)),
            ("no 5xx / dropped requests across the storm + swap",
             tally["other"] == 0 and stats.get("errors") == 0),
            ("accepted p99 bounded: storm within 3x uncontended",
             0 < storm_p99 <= 3.0 * uncont_p99),
            ("mid-storm publish swapped live (swap event, no drain)",
             swap_before_storm_end and stats.get("swaps") == 1),
            ("post-swap answers == cold restart on the new "
             "checkpoint", post_matches_cold),
            ("torn publish rejected; serving uninterrupted",
             served_through_torn
             and stats.get("swap_rejected") == 1),
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
    with open(os.path.join(out_dir, "storm_summary.json"), "w") as f:
        json.dump({"codes": tally, "uncontended_p99_ms": uncont_p99,
                   "storm_p99_ms": storm_p99,
                   "storm_publish_at_s": t_publish,
                   "storm_slowest_accepted": sorted(
                       acc_at, key=lambda r: -r[1])[:5],
                   "server_stats": stats}, f, indent=1, default=str)
    print(f"serve_http_smoke: {'PASS' if ok else 'FAIL'} "
          f"(codes {tally}, p99 uncontended {uncont_p99:.1f}ms "
          f"storm {storm_p99:.1f}ms)")
    return 0 if ok else 1


def main(argv=None) -> int:
    return smoke_main("serve_http_smoke", run_smoke, argv)


if __name__ == "__main__":
    sys.exit(main())
