"""Where the AlexNet train step goes: the top ops of a profiled run
(the port's copy of cxxnet_tpu/tools/profile_step.py, on torch.profiler).

    python -m cxxnet_tpu_torch.tools.profile_step [--steps N]
        [--out FILE.md] [--trace-dir DIR] [--dev DEV] [--batch B]
        [--conf CONF] [--top N]

Trains examples/ImageNet/AlexNet.conf (or `--conf`) on one staged
synthetic batch - b256 on the card, `--batch` to change it - for two
warm steps, then `--steps` steps (default 20) under torch.profiler
(CPU and CUDA activities), and tabulates `key_averages()`: on the card
each op's self device time (the kernels it launched), on the CPU its
self CPU time. `--trace-dir` also writes the Chrome trace. Prints the
markdown table and, with `--out`, writes it to a file.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ALEXNET_CONF = os.path.join(REPO, "examples", "ImageNet", "AlexNet.conf")


def _self_time_us(ev, device: bool) -> float:
    """An averaged event's self time in microseconds: on the device
    (the attribute's name changed across torch releases) or the CPU."""
    if not device:
        return float(ev.self_cpu_time_total)
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    raise AttributeError("torch.profiler event has no self device time")


def capture(conf: str = ALEXNET_CONF, steps: int = 20, dev: str = "",
            batch: int = 0, trace_dir: str = ""):
    """Profile `steps` train steps; returns (rows [(op, ms, calls)]
    sorted by time, total ms, step ms, device name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_file
    from cxxnet_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                               device_from_spec)
    pairs = [(k, v) for k, v in parse_config_file(conf)
             if k not in ("data", "eval", "pred", "iter")]
    tr = NetTrainer(device=device_from_spec(dev) if dev else DEFAULT_DEVICE)
    for k, v in pairs:
        tr.set_param(k, v)
    for k, v in (("silent", "1"), ("eval_train", "0")):
        tr.set_param(k, v)
    if batch:
        tr.set_param("batch_size", str(batch))
    tr.init_model()
    on_card = tr.device.type == "cuda"
    c, h, w = tr.net_cfg.input_shape
    final = tr.net.node_shapes[tr.net_cfg.num_nodes - 1]
    nclass = max(2, int(np.prod(final[1:])))
    rng = np.random.RandomState(0)
    staged = tr.stage_batch(DataBatch(
        data=rng.rand(tr.batch_size, c, h, w).astype(np.float32),
        label=rng.randint(0, nclass, (tr.batch_size, 1)).astype(
            np.float32)))
    for _ in range(2):
        tr.update(staged)
    tr._sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(steps):
            tr.update(staged)
        tr._sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "profile_step.json"))
    rows: List[Tuple[str, float, int]] = []
    for ev in prof.key_averages():
        us = _self_time_us(ev, on_card)
        if us > 0:
            rows.append((ev.key, us / 1e3, int(ev.count)))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    name = torch.cuda.get_device_name(tr.device) if on_card else "cpu"
    return rows, total, step_ms, name


def summarize(rows, total: float, steps: int, top: int = 25,
              device: str = "") -> str:
    """Markdown table of the top `top` rows."""
    what = "self CPU" if device == "cpu" else "self device"
    out = [f"| op | {what} ms, {steps} steps | % | calls |",
           "|---|---|---|---|"]
    for name, ms, calls in rows[:top]:
        out.append(f"| `{name[:70]}` | {ms:.3f} | "
                   f"{100.0 * ms / max(total, 1e-9):.1f}% | {calls} |")
    out.append(f"\nTotal {what} time {total:.3f} ms over {steps} steps "
               f"on {device}")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    def opt(flag, default):
        if flag in argv:
            return argv[argv.index(flag) + 1]
        return default
    steps = int(opt("--steps", 20))
    top = int(opt("--top", 25))
    rows, total, step_ms, device = capture(
        opt("--conf", ALEXNET_CONF), steps, opt("--dev", ""),
        int(opt("--batch", 0)), opt("--trace-dir", ""))
    md = summarize(rows, total, steps, top, device)
    print(md)
    print(f"step {step_ms:.3f} ms (host clock, profiler on)")
    out_file = opt("--out", "")
    if out_file:
        with open(out_file, "w") as fo:
            fo.write(f"# Train-step profile ({device})\n\n{steps} steps, "
                     f"{step_ms:.3f} ms a step with the profiler on.\n\n"
                     + md + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
