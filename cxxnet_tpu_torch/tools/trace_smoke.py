"""Request-tracing + executable-introspection smoke (the port's copy of
cxxnet_tpu/tools/trace_smoke.py).

    python -m cxxnet_tpu_torch.tools.trace_smoke [--out DIR] [--keep]
        [--dev DEV]

Arms the observability plane (event sink + ephemeral `/metrics`
server), drives an in-process serve storm over a tiny MLP - ragged
request sizes including oversize requests that split - and asserts
the third observability tier end-to-end (docs/OBSERVABILITY.md):

- `/executables` lists exactly the warmed bucket executables, each
  with a compile wall-time, and the entry SET stays flat over the
  storm (the registry twin of the zero-recompile audit) while
  dispatch counts accumulate;
- every submitted request appears in the exported Chrome trace as a
  COMPLETE span tree (all split parts present, each with queue +
  device child spans), and the trace file parses as trace-event JSON
  loadable in Perfetto;
- the storm's p99 decomposes into queue vs device time (both
  histograms populated, summary carries the numbers);
- every `/metrics` scrape - including the new per-executable series
  and the `serve.request_rows` histogram - passes the promtool-style
  exposition grammar;
- the flight recorder's ring holds the storm's dispatches and the
  stall-dump path can name them (`format_tail` smoke).

Exit 0 iff every check passes; the events JSONL, Chrome trace and
summary land in `--out`. It runs on the card unless `--dev cpu` asks for
the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import urllib.request

import numpy as np

from cxxnet_tpu_torch.tools.common import smoke_main

MLP_CFG = """
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
eta = 0.3
silent = 1
seed = 7
"""

# ragged storm: every bucket size hit, several OVERSIZE requests
# (rows > max_batch=8) that split into parts - the trace must re-join
# them into one span tree per request
STORM_SIZES = [1, 3, 8, 2, 12, 5, 7, 20, 4, 6, 1, 9, 2, 16, 8, 3]


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return r.read()


def run_smoke(out_dir: str, device: str) -> int:
    from cxxnet_tpu_torch import telemetry
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Server
    from cxxnet_tpu_torch.telemetry.http import validate_exposition
    from cxxnet_tpu_torch.tools import trace_export

    events = os.path.join(out_dir, "trace_events.jsonl")
    trace_path = os.path.join(out_dir, "trace.json")
    summary_path = os.path.join(out_dir, "trace_summary.json")

    telemetry.configure(log_file=events)
    http = telemetry.arm_observability(metrics_port=0,
                                       metrics_host="127.0.0.1")
    base = f"http://127.0.0.1:{http.port}"

    tr = NetTrainer(cfg=MLP_CFG, device=device)
    tr.init_model()
    srv = Server(tr, max_batch=8, max_wait_ms=2.0, replicas=2,
                 device=device)
    srv.warmup()

    # /executables after warmup: exactly the bucket set, compile times
    execs0 = json.loads(_get(base + "/executables"))
    serve0 = {e["fingerprint"]: e
              for e in execs0.get("executables", [])
              if e.get("kind") == "serve"}
    scrape_ok = []
    for _ in range(2):
        bad = validate_exposition(_get(base + "/metrics").decode())
        scrape_ok.append(not bad)

    rng = np.random.RandomState(5)
    srv.start()
    futs = [srv.submit(rng.rand(n, 1, 1, 36).astype(np.float32))
            for n in STORM_SIZES]
    for f in futs:
        f.result(timeout=120)
    bad = validate_exposition(_get(base + "/metrics").decode())
    scrape_ok.append(not bad)
    metrics_txt = _get(base + "/metrics").decode()
    execs1 = json.loads(_get(base + "/executables"))
    serve1 = {e["fingerprint"]: e
              for e in execs1.get("executables", [])
              if e.get("kind") == "serve"}
    varz = json.loads(_get(base + "/varz"))
    flight_tail_txt = telemetry.flight().format_tail(8)
    n_flight = len(telemetry.flight().snapshot())
    stats = srv.stop()
    telemetry.close()

    summary = trace_export.export(events, trace_path, summary_path)
    with open(trace_path, "r", encoding="utf-8") as f:
        trace = json.load(f)
    tev = trace.get("traceEvents", [])
    spans = [e for e in tev if e.get("ph") == "X"]
    # expected split parts: ceil(n / max_batch) per request
    want_parts = sum(-(-n // 8) for n in STORM_SIZES)

    checks = [
        ("/executables lists the warmed bucket executables",
         len(serve0) == len(srv.buckets)
         and all(e.get("compile_s") is not None
                 for e in serve0.values())),
        ("executable cost analysis recorded (flops/bytes)",
         all(e.get("flops") is not None for e in serve0.values())),
        ("executable set flat after the storm",
         set(serve1) == set(serve0)),
        ("dispatch counts accumulated over the storm",
         sum(e["dispatches"] for e in serve1.values())
         >= stats["batches"] > 0),
        ("every /metrics scrape parses (incl. executable series)",
         all(scrape_ok)),
        ("serve.request_rows histogram exported",
         "cxxnet_serve_request_rows_bucket" in metrics_txt),
        ("/varz carries the flight tail",
         bool(varz.get("flight"))),
        ("flight ring recorded the storm's dispatches",
         n_flight >= stats["batches"]
         and "fp=" in flight_tail_txt),
        ("chrome trace parses with span events",
         isinstance(tev, list) and len(spans) == 3 * want_parts),
        ("every submitted request is a complete span tree",
         summary.get("requests") == len(STORM_SIZES)
         and summary.get("complete_requests") == len(STORM_SIZES)
         and summary.get("parts") == want_parts),
        ("p99 decomposes into queue vs device time",
         summary.get("queue_p99_ms") is not None
         and summary.get("device_p99_ms") is not None
         and summary.get("total_p99_ms") is not None),
        ("server stats carry the queue/device breakdown",
         stats.get("queue_p99_ms") is not None
         and stats.get("device_p99_ms") is not None),
        ("no dispatch errors", stats["errors"] == 0),
    ]
    ok = True
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
        ok = ok and bool(passed)
    print(f"trace_smoke: {'PASS' if ok else 'FAIL'} "
          f"({summary.get('parts')} parts / "
          f"{summary.get('requests')} requests, queue p99 "
          f"{summary.get('queue_p99_ms')} ms, device p99 "
          f"{summary.get('device_p99_ms')} ms, buckets "
          f"{summary.get('dispatches_by_bucket')})")
    return 0 if ok else 1


def main(argv=None) -> int:
    return smoke_main("trace_smoke", run_smoke, argv)


if __name__ == "__main__":
    sys.exit(main())
