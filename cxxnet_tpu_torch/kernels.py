"""Hand-written CUDA kernels: build, load and launch accounting.

Every kernel source lives in `csrc/` as one `.cu` file with a plain C
entry point; headers shared between sources are `csrc/*.cuh`. It is
compiled with `nvcc` for `sm_90a` (Hopper) into a shared library under
`build/` (listed in .gitignore) the first time a wrapper needs it, and
bound with `ctypes`. The library name carries a hash of the source, the
shared headers and the flags, so an edited source or header rebuilds
and a stale library is never loaded. Nothing here runs at import time:
the package imports on a machine with no `nvcc` and no card, and the
CPU paths never reach this module's loader.

Each wrapper counts its launches in `LAUNCHES` (one per kernel launch,
nowhere else), so a run can show that its main path went through the
kernels: `reset_launches()` before the run, `launches()` after it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

# kernel name -> source file in csrc/ (one shared library each)
SOURCES: Dict[str, str] = {
    "lrn_fwd": "lrn_fwd.cu",
    "lrn_bwd": "lrn_bwd.cu",
    "attn_fwd": "attn_fwd.cu",
    "attn_dq": "attn_dq.cu",
    "attn_dkv": "attn_dkv.cu",
    "int8_mm": "int8_mm.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    with _lock:
        return dict(LAUNCHES)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else the one on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "cxxnet_tpu_torch are compiled from csrc/ at first use")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile_cmd(name: str, out: str) -> List[str]:
    return [nvcc_path()] + NVCC_FLAGS + [
        "-o", out, os.path.join(CSRC, SOURCES[name])]


def build_all(names: Optional[List[str]] = None
              ) -> Dict[str, Tuple[float, str]]:
    """Compile the named kernels (default: all) in parallel, one `nvcc`
    process per source, all started together. Returns {name: (seconds,
    compiler output incl. the -Xptxas -v register/shared-memory
    lines)}; an up-to-date library is not rebuilt (0 s, "cached")."""
    names = list(SOURCES) if names is None else names
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    out: Dict[str, Tuple[float, str]] = {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            out[name] = (0.0, "cached")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), tmp, path)
    for name, (p, tmp, path) in procs.items():
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} (rc "
                               f"{p.returncode}):\n{so}{se}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
        out[name] = (time.perf_counter() - t0, so + se)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            _bind(name, lib)
            _libs[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    """Declare argtypes/restype of each C entry point: pointers and the
    stream as c_void_p (ctypes would otherwise pass a 32-bit int and
    cut them)."""
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_longlong, ctypes.c_float)
    if name == "lrn_fwd":
        lib.lrn_fwd.argtypes = [vp, vp, i32, i64, i32, i64, i32, f32,
                                f32, f32, vp]
        lib.lrn_fwd.restype = i32
    if name == "lrn_bwd":
        lib.lrn_bwd.argtypes = [vp, vp, vp, i32, i64, i32, i64, i32, f32,
                                f32, f32, f32, vp]
        lib.lrn_bwd.restype = i32
    # attention: (pointers..., dtype, B*H, Sq, Sk, D, causal, scale, stream)
    dims = [i32, i64, i32, i32, i32, i32, f32, vp]
    if name == "attn_fwd":
        lib.attn_fwd.argtypes = [vp] * 5 + dims
        lib.attn_fwd.restype = i32
    if name == "attn_dq":
        lib.attn_dq.argtypes = [vp] * 7 + dims
        lib.attn_dq.restype = i32
        lib.attn_dq_plan.argtypes = [i32, vp]  # (d, int[3] out)
        lib.attn_dq_plan.restype = i32
    if name == "attn_dkv":
        lib.attn_dkv.argtypes = [vp] * 8 + dims
        lib.attn_dkv.restype = i32
        lib.attn_dkv_plan.argtypes = [i32, vp]
        lib.attn_dkv_plan.restype = i32
    if name == "int8_mm":
        # (x, w, out, m, n, k, splits, aligned, stream)
        lib.int8_mm.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
        lib.int8_mm.restype = i32


def check(name: str, rc: int) -> None:
    """Raise on a refused launch (the C entry returns
    cudaGetLastError()); count it otherwise - once per launch, and under
    the lock, since Server replicas launch from several threads."""
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {rc}")
    with _lock:
        LAUNCHES[name] += 1
