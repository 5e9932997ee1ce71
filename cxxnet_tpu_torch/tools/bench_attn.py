"""bench_attn: the flash-attention kernels K2 against SDPA (the port's
counterpart of cxxnet_tpu/tools/bench_attn.py).

    python -m cxxnet_tpu_torch.tools.bench_attn [--quick]
        [--shape b,h,s,d] [--steps N] [--dev DEV]

Times K2-fwd (`fwd`) and K2-fwd + K2-dq + K2-dkv (`fwd_bwd`, the
training cost: the gradients of all of q, k, v) in bfloat16, causal and
not, at the JAX tool's shape (4, 8, 4096, 128), with
`F.scaled_dot_product_attention` timed beside each on the same inputs as
the library yardstick (timed only: no path of the port calls it). It
prints one JSON line per config: the times, TFLOP/s (causal rows count
the realized half of the work), the ratio to SDPA and the tile plan.

The JAX tool sweeps the Pallas kernel's (BLOCK_Q, BLOCK_K); K2's tile
plans are fixed when its sources are built (`ops/flash_attention.py`
`tc_plan`: 64 query rows a warpgroup, the key tile and the head padded
to a power of two; past head_dim 256 the wide route: up to 512 the
whole-head plan of K2-fwd and K2-dkv, else 128-column chunks), so this
tool reports the one plan of each kernel at this
head_dim, under the config name `k2`. `--shape 4,8,4096,512` times the
wide route (SDPA's flash backend refuses head_dims past 256, and PyTorch
then picks another). `--quick` times the same configs with fewer steps. On the card the times are CUDA events around
back-to-back calls; it runs on the card unless `--dev cpu` asks for the
CPU (where the kernels' plain versions run, at whatever shape is given).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from cxxnet_tpu_torch.tools.common import device_name, time_ms, tool_device


def _arg(argv, flag, default):
    return argv[argv.index(flag) + 1] if flag in argv else default


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    shape = tuple(int(t) for t in
                  _arg(argv, "--shape", "4,8,4096,128").split(","))
    steps = int(_arg(argv, "--steps", "3" if "--quick" in argv else "10"))
    device = tool_device(_arg(argv, "--dev", ""))

    import torch
    import torch.nn.functional as F

    from cxxnet_tpu_torch.ops import flash_attention as FA

    b, h, s, d = shape
    rng = np.random.RandomState(0)
    dt = torch.bfloat16 if device != "cpu" else torch.float32
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               .to(device=device, dtype=dt) for _ in range(3))
    plan = {}
    if device != "cpu":
        plan = {name: FA.tc_plan(name, d, s)
                if name == "attn_fwd" else FA.tc_plan(name, d)
                for name in ("attn_fwd", "attn_dq", "attn_dkv")}
    flops = {"fwd": 4.0 * b * h * s * s * d,
             "fwd_bwd": 14.0 * b * h * s * s * d}
    card = device_name(device)

    def fwd(core, causal):
        def run():
            with torch.no_grad():
                return core(q, k, v, causal)
        return run

    def fwd_bwd(core, causal):
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        def run():
            out = core(qg, kg, vg, causal)
            return torch.autograd.grad(out.float().sum(), (qg, kg, vg))
        return run

    def k2(q_, k_, v_, causal):
        return FA.flash_attention(q_, k_, v_, causal)

    def sdpa(q_, k_, v_, causal):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal)

    for causal in (False, True):
        for kind, make in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            work = flops[kind] / (2.0 if causal else 1.0)
            row = {"config": "k2" + ("_causal" if causal else ""),
                   "pass": kind, "shape": list(shape),
                   "dtype": str(dt).replace("torch.", ""), "device": card}
            try:
                ms = time_ms(make(k2, causal), steps, device)
                lib = time_ms(make(sdpa, causal), steps, device)
                row.update({
                    "ms": round(ms, 4), "sdpa_ms": round(lib, 4),
                    "tflops": round(work / (ms * 1e-3) / 1e12, 2),
                    "vs_sdpa": round(ms / lib, 3), "plan": plan})
            except Exception as e:  # noqa: BLE001 - the sweep survives
                row["error"] = f"{type(e).__name__}: {e}"[:200]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
