"""Hand-written CUDA kernels: build, load and launch accounting.

Every kernel source lives in `csrc/` as one `.cu` file with a plain C
entry point; headers shared between sources are `csrc/*.cuh`. It is
compiled with `nvcc` for `sm_90a` (Hopper) into a shared library under
`build/` (listed in .gitignore) the first time a wrapper needs it, and
bound with `ctypes`. The library name carries a hash of the source, the
shared headers and the flags, so an edited source, header or flag
rebuilds and a stale library is never loaded. Nothing here runs at
import time: the package imports on a machine with no `nvcc` and no
card, and the CPU paths never reach this module's loader.

One source is more than a kernel: `nvjpeg_io.cu`, the image decoder of
`io/native.py` (a page-reader thread, nvJPEG decode workers and their
kernel YccToRgb), which links `-lnvjpeg` and the thread library
(`source_flags`).

Each wrapper counts its launches in `LAUNCHES` (one per kernel launch,
nowhere else), so a run can show that its main path went through the
kernels: `reset_launches()` before the run, `launches()` after it. The
decoder launches its kernel YccToRgb from its own worker threads, so its
library keeps that count itself, where it launches (one per image it
decoded), with its raw hand-backs (blobs it left to the host's decoder)
beside it; `launches()` and `raw_handbacks()` read them from the library
and `reset_launches()` zeroes them there. Before the library is loaded
both read 0.
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
    "nvjpeg_decode": "nvjpeg_io.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
# the kernel whose count its library keeps (csrc/nvjpeg_io.cu)
DECODER = "nvjpeg_decode"


def _decoder_counts() -> Tuple[int, int]:
    """(YccToRgb launches, raw hand-backs) as the decoder's library
    counts them; (0, 0) before it is loaded. Called under _lock."""
    lib = _libs.get(DECODER)
    if lib is None:
        return 0, 0
    out = (ctypes.c_longlong * 2)()
    lib.cxio_counters(out)
    return out[0], out[1]


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        lib = _libs.get(DECODER)
        if lib is not None:
            lib.cxio_reset_counters()


def launches() -> Dict[str, int]:
    with _lock:
        LAUNCHES[DECODER] = _decoder_counts()[0]
        return dict(LAUNCHES)


def raw_handbacks() -> int:
    """Blobs the image decoder handed back raw for the host to decode."""
    with _lock:
        return _decoder_counts()[1]


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


def nvjpeg_dirs() -> Tuple[Optional[str], Optional[str]]:
    """(include dir holding nvjpeg.h, library dir holding libnvjpeg.so*):
    the CUDA toolkit's directories, then the NVIDIA wheels beside torch
    (site-packages/nvidia/*/include|lib); None where not found."""
    import glob
    import site
    home = os.path.dirname(os.path.dirname(nvcc_path()))
    incs = [os.path.join(home, "include"), "/usr/local/cuda/include",
            "/usr/include"]
    libs = [os.path.join(home, "lib64"), "/usr/local/cuda/lib64",
            os.path.join(home, "targets", "x86_64-linux", "lib"),
            "/usr/lib/x86_64-linux-gnu"]
    for sp in site.getsitepackages():
        incs += sorted(glob.glob(os.path.join(sp, "nvidia", "*", "include")))
        libs += sorted(glob.glob(os.path.join(sp, "nvidia", "*", "lib")))

    def find(dirs, pattern):
        for d in dirs:
            if glob.glob(os.path.join(d, pattern)):
                return d
        return None
    return find(incs, "nvjpeg.h"), find(libs, "libnvjpeg.so*")


def source_flags(name: str) -> List[str]:
    """nvcc's flags for one source: NVCC_FLAGS, and for the decoder the
    nvjpeg include and library directories, an rpath to the library
    (it may sit outside the loader's path), -lnvjpeg and -pthread."""
    if name != "nvjpeg_decode":
        return list(NVCC_FLAGS)
    inc, lib = nvjpeg_dirs()
    if inc is None or lib is None:
        raise RuntimeError(
            f"nvjpeg not found (nvjpeg.h: {inc or 'absent'}, libnvjpeg: "
            f"{lib or 'absent'}): the image decoder of cxxnet_tpu_torch "
            "(csrc/nvjpeg_io.cu) links against it")
    return NVCC_FLAGS + ["-I" + inc, "-L" + lib, "-Xlinker", "-rpath," + lib,
                         "-Xcompiler", "-pthread", "-lnvjpeg", "-lpthread"]


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(source_flags(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile_cmd(name: str, out: str) -> List[str]:
    return [nvcc_path()] + source_flags(name) + [
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
    # LRN: (..., chunk, seg, threads, smem bytes, stream) - the plan of
    # ops/lrn.py:lrn_plan; *_smem(dtype, C, H*W, n, chunk, seg) -> bytes
    plan = [i32, i32, i32, i32, vp]
    if name == "lrn_fwd":
        lib.lrn_fwd.argtypes = [vp, vp, i32, i64, i32, i64, i32, f32,
                                f32, f32] + plan
        lib.lrn_fwd.restype = i32
    if name == "lrn_bwd":
        lib.lrn_bwd.argtypes = [vp, vp, vp, i32, i64, i32, i64, i32, f32,
                                f32, f32, f32] + plan
        lib.lrn_bwd.restype = i32
    if name in ("lrn_fwd", "lrn_bwd"):
        smem = getattr(lib, f"{name}_smem")
        smem.argtypes = [i32, i32, i64, i32, i32, i32]
        smem.restype = i64
    # attention: (pointers..., dtype, B*H, Sq, Sk, D, causal, scale, stream)
    dims = [i32, i64, i32, i32, i32, i32, f32, vp]
    if name == "attn_fwd":
        lib.attn_fwd.argtypes = [vp] * 5 + dims
        lib.attn_fwd.restype = i32
        lib.attn_fwd_plan.argtypes = [i32, i32, vp]  # (d, Sq, int[5] out)
        lib.attn_fwd_plan.restype = i32
    if name == "attn_dq":
        lib.attn_dq.argtypes = [vp] * 7 + dims
        lib.attn_dq.restype = i32
        lib.attn_dq_plan.argtypes = [i32, vp]  # (d, int[4] out)
        lib.attn_dq_plan.restype = i32
    if name == "attn_dkv":
        lib.attn_dkv.argtypes = [vp] * 8 + dims
        lib.attn_dkv.restype = i32
        lib.attn_dkv_plan.argtypes = [i32, vp]
        lib.attn_dkv_plan.restype = i32
    if name == "int8_mm":
        # (x, w, out, m, n, k, bn, splits, aligned, stream)
        lib.int8_mm.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                vp]
        lib.int8_mm.restype = i32
    if name == DECODER:
        # (paths, n_bins, n_threads, max_inflight, out_mode, device)
        lib.cxio_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), i32, i32,
                                  i32, i32, i32]
        lib.cxio_open.restype = vp
        lib.cxio_before_first.argtypes = [vp]
        lib.cxio_before_first.restype = None
        lib.cxio_next.argtypes = [vp, vp]  # (handle, CxioRecord*)
        lib.cxio_next.restype = i32
        lib.cxio_last_error.argtypes = [vp]
        lib.cxio_last_error.restype = ctypes.c_char_p
        lib.cxio_error_kind.argtypes = [vp]
        lib.cxio_error_kind.restype = i32
        lib.cxio_counters.argtypes = [vp]  # long long[2]
        lib.cxio_counters.restype = None
        lib.cxio_reset_counters.argtypes = []
        lib.cxio_reset_counters.restype = None
        lib.cxio_backend.argtypes = []
        lib.cxio_backend.restype = ctypes.c_char_p
        lib.cxio_version.argtypes = [vp]  # int[3]
        lib.cxio_version.restype = i32
        lib.cxio_hw_info.argtypes = [i32, vp]  # (device, unsigned[2])
        lib.cxio_hw_info.restype = i32
        lib.cxio_close.argtypes = [vp]
        lib.cxio_close.restype = None
        # (y, cb, cr, w, h, cw, ch, hf, vf, coding, out, stream)
        lib.cxio_ycc_to_rgb.argtypes = [vp, vp, vp] + [i32] * 7 + [vp, vp]
        lib.cxio_ycc_to_rgb.restype = i32


def check(name: str, rc: int) -> None:
    """Raise on a refused launch (the C entry returns
    cudaGetLastError()); count it otherwise - once per launch, and under
    the lock, since Server replicas launch from several threads. The
    decoder's library has counted its launch already."""
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {rc}")
    if name != DECODER:
        count(name)


def count(name: str) -> None:
    """One launch of `name` (not the decoder's: its library counts)."""
    with _lock:
        LAUNCHES[name] += 1
