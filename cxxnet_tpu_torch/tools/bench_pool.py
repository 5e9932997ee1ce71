"""bench_pool: the max-pool backward, the reference's tie rule against
the single-winner rule, on AlexNet's three pooling shapes (the port's
counterpart of cxxnet_tpu/tools/bench_pool.py).

    python -m cxxnet_tpu_torch.tools.bench_pool [--steps N] [--batch B]
        [--dev DEV]

The tie-duplicating backward (`pool_grad = ties`, the default:
`ops/pooling.py` `_MaxPoolTies`, separable one-axis unpools as torch
ops) hands the gradient to every input that equals its window's max;
`pool_grad = winner` is torch's max_pool2d backward, one winner a
window. Each is timed forward + backward in bfloat16 at batch 256 (the
conf's), and the tool prints one JSON line per shape with both times
and their ratio. On the card the times are CUDA events around
back-to-back calls; it runs on the card unless `--dev cpu` asks for the
CPU (shrink `--batch` there).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from cxxnet_tpu_torch.tools.common import device_name, time_ms, tool_device

# (name, input shape without the batch, k, stride): AlexNet's pools
SHAPES = (("pool1", (96, 55, 55), 3, 2),
          ("pool2", (256, 27, 27), 3, 2),
          ("pool3", (256, 13, 13), 3, 2))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else 30
    batch = int(argv[argv.index("--batch") + 1]) if "--batch" in argv \
        else 256
    device = tool_device(argv[argv.index("--dev") + 1]
                         if "--dev" in argv else "")

    import torch

    from cxxnet_tpu_torch.ops.pooling import pool2d

    card = device_name(device)
    rng = np.random.RandomState(0)
    for name, chw, k, st in SHAPES:
        x = (torch.from_numpy(rng.randn(batch, *chw).astype(np.float32))
             .to(device=device, dtype=torch.bfloat16).requires_grad_(True))
        row = {"shape": name, "input": [batch, *chw], "k": k, "stride": st,
               "dtype": "bfloat16", "device": card}
        for gm in ("ties", "winner"):
            def step(gm=gm):
                y = pool2d(x, "max", k, k, st, grad_mode=gm)
                return torch.autograd.grad(y.float().sum(), x)
            row[gm + "_ms"] = round(time_ms(step, steps, device), 4)
        row["winner_speedup"] = round(
            row["ties_ms"] / max(row["winner_ms"], 1e-9), 3)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
