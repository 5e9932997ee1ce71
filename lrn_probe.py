"""Where K1's time goes: K1-fwd and K1-bwd at AlexNet's b256 bfloat16
LRN shapes (n = 5, the plan of ops/lrn.py:lrn_plan), each built four
ways from the sources in cxxnet_tpu_torch/csrc/ and timed back to back
with CUDA events (L2 warm):

- full: the kernel as it ships;
- no_compute: the slab is loaded and stored, the per-position walk is
  skipped (what the copies alone cost);
- no_load: the walk and the store run on whatever shared memory holds
  (what the arithmetic and the stores cost);
- no_store: the output is not written back.

The variants are built aside in a temporary directory by editing the
copied sources; nothing in the package changes. Needs one NVIDIA H100
and nvcc:

    python3 lrn_probe.py
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

import chip_smoke as smoke
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.ops import lrn as lrn_ops

WALK = "for (int p = threadIdx.x; p < k.len; p += blockDim.x) {"
VARIANTS = {
    "full": [],
    "no_compute": [(WALK, WALK.replace("p < k.len", "p < 0"))],
    "no_load": [("lrn::load_slab(sx", "if (0) lrn::load_slab(sx"),
                ("lrn::load_slab(sg", "if (0) lrn::load_slab(sg")],
    "no_store": [("lrn::store_slab(", "if (k.len < 0) lrn::store_slab(")],
}
ALPHA, BETA, KNORM, N = 0.001, 0.75, 1.0, 5


def build(tmp):
    """{(variant, kernel): ctypes library}, every nvcc started at once."""
    procs = []
    for variant, edits in VARIANTS.items():
        d = os.path.join(tmp, variant)
        shutil.copytree(kernels.CSRC, d)
        for name in ("lrn_fwd", "lrn_bwd"):
            path = os.path.join(d, name + ".cu")
            with open(path) as f:
                src = f.read()
            for old, new in edits:
                if old in src:
                    src = src.replace(old, new)
            with open(path, "w") as f:
                f.write(src)
            out = os.path.join(d, f"lib{name}.so")
            procs.append(((variant, name), out, subprocess.Popen(
                [kernels.nvcc_path()] + kernels.NVCC_FLAGS
                + ["-o", out, path], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(out)
        kernels._bind(key[1], lib)
        libs[key] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("lrn_probe: no CUDA device", file=sys.stderr)
        return 1
    print(smoke.card_line(), flush=True)
    tmp = tempfile.mkdtemp()
    try:
        libs = build(tmp)
        gen = torch.Generator(device="cuda").manual_seed(3)
        stream = torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device())
        for name in ("lrn_fwd", "lrn_bwd"):
            backward = name == "lrn_bwd"
            for shape in smoke.TRAIN_LRN_SHAPES:
                x = (torch.randn(shape, generator=gen, device="cuda")
                     * 4).bfloat16()
                g = torch.randn(shape, generator=gen,
                                device="cuda").bfloat16()
                out = torch.empty_like(x)
                b, c, h, w = shape
                p = lrn_ops.lrn_plan(shape, N, torch.bfloat16, backward)
                plan = (p["chunk"], p["seg"], p["threads"], p["smem_bytes"])
                row = []
                for variant in VARIANTS:
                    lib = libs[(variant, name)]
                    if backward:
                        def fn(lib=lib):
                            return lib.lrn_bwd(
                                x.data_ptr(), g.data_ptr(), out.data_ptr(),
                                1, b, c, h * w, N, ALPHA / N, -BETA,
                                2 * ALPHA * BETA / N, KNORM, *plan, stream)
                    else:
                        def fn(lib=lib):
                            return lib.lrn_fwd(
                                x.data_ptr(), out.data_ptr(), 1, b, c,
                                h * w, N, ALPHA / N, -BETA, KNORM, *plan,
                                stream)
                    if fn() != 0:
                        raise RuntimeError(f"{name} {variant} did not launch")
                    row.append(f"{variant} {smoke.time_warm(torch, fn):.4f}")
                print(f"{name} {shape} bfloat16 n={N} (chunk {p['chunk']}, "
                      f"{p['threads']} threads): " + ", ".join(row) + " ms",
                      flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
