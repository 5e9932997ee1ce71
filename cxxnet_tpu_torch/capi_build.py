"""Build of the C ABI library (csrc/cxxnet_wrapper.cc) and its C driver
(csrc/capi_driver.c) with the host C++ compiler.

The library embeds CPython and imports `cxxnet_tpu_torch.capi`, so it is
compiled against this interpreter's headers and linked against its
shared libpython, both found through `sysconfig` (the values
`python3-config --includes --embed` / `--ldflags --embed` print). It is
built the first time it is asked for, into `build/` (listed in
.gitignore) under a name that carries a hash of the sources and the
flags, written to a temporary name and renamed, so concurrent builders
(test workers) never load a half-written file. A missing `g++`,
`Python.h` or shared libpython raises; nothing falls back.

A program that loads the library runs the port in an embedded
interpreter: `driver_env()` gives the environment it needs
(PYTHONPATH = the repo and this interpreter's site-packages).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import Dict, List, Optional

from cxxnet_tpu_torch.kernels import BUILD, CSRC

LIB_SOURCES = ("cxxnet_wrapper.cc", "cxxnet_wrapper.h")
DRIVER_SOURCE = "capi_driver.c"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()


def embed_facts() -> Dict[str, object]:
    """What embedding this interpreter needs and whether it is there:
    the include directory and its Python.h, the shared libpython
    (LDLIBRARY in LIBDIR), and the compiler."""
    inc = sysconfig.get_config_var("INCLUDEPY") or ""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    return {
        "version": sys.version.split()[0],
        "INCLUDEPY": inc,
        "Python.h": os.path.exists(os.path.join(inc, "Python.h")),
        "LIBDIR": libdir,
        "LDLIBRARY": ldlib,
        "libpython": os.path.exists(os.path.join(libdir, ldlib)),
        "Py_ENABLE_SHARED": sysconfig.get_config_var("Py_ENABLE_SHARED"),
        "g++": shutil.which("g++") or "",
    }


def embed_flags() -> List[str]:
    """Compile and link flags for a library that embeds this
    interpreter; raises naming what is missing."""
    f = embed_facts()
    if not f["g++"]:
        raise RuntimeError("g++ not found: the C ABI library is built "
                           "with the host C++ compiler")
    if not f["Python.h"]:
        raise RuntimeError(f"Python.h not found in {f['INCLUDEPY']!r}: "
                           "the C ABI library embeds CPython")
    if not (f["libpython"] and str(f["LDLIBRARY"]).endswith(".so")):
        raise RuntimeError(
            f"no shared libpython ({f['LDLIBRARY']!r} in "
            f"{f['LIBDIR']!r}): the C ABI library embeds CPython")
    ver = (sysconfig.get_config_var("VERSION")
           + (sysconfig.get_config_var("ABIFLAGS") or ""))
    extra = " ".join(sysconfig.get_config_var(k) or ""
                     for k in ("LIBS", "SYSLIBS")).split()
    return [f"-I{f['INCLUDEPY']}", f"-L{f['LIBDIR']}", f"-lpython{ver}",
            f"-Wl,-rpath,{f['LIBDIR']}"] + extra


def _digest(sources, flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as fh:
            h.update(src.encode() + b"\0" + fh.read())
    return h.hexdigest()[:12]


def _compile(cmd: List[str], out: str) -> None:
    """Run `cmd` (whose output is `out`.tmp), then rename into place."""
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    p = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True,
                       errors="replace", timeout=600)
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"C ABI build failed (rc {p.returncode}): "
                           f"{' '.join(cmd)}\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)


def library_path() -> str:
    flags = CXX_FLAGS + embed_flags()
    return os.path.join(BUILD, f"libcxxnetwrapper-"
                               f"{_digest(LIB_SOURCES, flags)}.so")


def build_library() -> str:
    """The C ABI library, built on first use; returns its path."""
    with _lock:
        path = library_path()
        if not os.path.exists(path):
            _compile(["g++"] + CXX_FLAGS
                     + [os.path.join(CSRC, "cxxnet_wrapper.cc")]
                     + embed_flags(), path)
    return path


def build_driver() -> str:
    """The C driver (csrc/capi_driver.c) linked against the library,
    built on first use; returns the executable's path."""
    lib = build_library()
    libdir, name = os.path.split(lib)
    out = os.path.join(BUILD, f"capi_driver-"
                              f"{_digest((DRIVER_SOURCE,), [name])}")
    with _lock:
        if not os.path.exists(out):
            # the source is C, compiled as C++ by g++ (-x c++ for it
            # alone); the library is linked by path, its directory
            # also on the rpath
            _compile(["g++", "-O1", "-I", CSRC, "-x", "c++",
                      os.path.join(CSRC, DRIVER_SOURCE), "-x", "none",
                      lib, "-lm", f"-Wl,-rpath,{libdir}"], out)
    return out


def driver_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of a process that embeds the port through the C
    ABI: the repo and this interpreter's site-packages on PYTHONPATH."""
    env = dict(os.environ if env is None else env)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    site = sysconfig.get_paths()["purelib"]
    rest = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo, site] + rest)
    return env
