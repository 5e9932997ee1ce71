"""Decode-pipeline benchmark: the native decoder against the PIL path
(own copy of cxxnet_tpu/tools/bench_io.py).

Generates a synthetic imgbin (JPEG blobs of a given size), then streams
it through `ImageBinIterator` with `use_native = 1` (the page reader,
the nvJPEG decode workers and the reorder buffer of io/native.py on the
card; on the CPU its plain version, PIL decode in the same order) and
`use_native = 0` (the Python page-reader thread and the PIL decode
pool), reporting decoded images/s for each.

Usage: python -m cxxnet_tpu_torch.tools.bench_io [n_images] [size]
       [threads] [device]

`device` is the card by default (`cuda:0`); `cpu` measures the plain
version instead. Rates are host-clock images/s of the iterator alone
(decode and hand-off; no augmenter, no batching).
"""

from __future__ import annotations

import io
import os
import sys
import tempfile
import time
from typing import Optional, Tuple

import numpy as np

from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE


def make_dataset(tmp: str, n: int, size: int) -> Tuple[str, str]:
    """Write n JPEGs of (size x size) into an imgbin + list file."""
    from PIL import Image
    from cxxnet_tpu_torch.utils.binary_page import BinaryPageWriter

    rng = np.random.RandomState(0)
    # a handful of distinct images cycled, so dataset build stays fast
    # but blobs are real JPEG work to decode
    blobs = []
    for _ in range(min(n, 16)):
        arr = rng.randint(0, 255, (size, size, 3), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=90)
        blobs.append(buf.getvalue())
    bin_path = os.path.join(tmp, "bench.bin")
    lst_path = os.path.join(tmp, "bench.lst")
    with open(bin_path, "wb") as fo:
        w = BinaryPageWriter(fo)
        for i in range(n):
            w.push(blobs[i % len(blobs)])
        w.close()
    with open(lst_path, "w") as fo:
        for i in range(n):
            fo.write(f"{i}\t0\timg{i}.jpg\n")
    return lst_path, bin_path


def run_mode(lst: str, bin_path: str, use_native: int, threads: int,
             device: Optional[str]) -> float:
    """Images/s of one pass of the imgbin iterator alone."""
    from cxxnet_tpu_torch.io.iter_img import ImageBinIterator
    it = ImageBinIterator(device)
    it.set_param("image_list", lst)
    it.set_param("image_bin", bin_path)
    it.set_param("use_native", str(use_native))
    it.set_param("decode_threads", str(threads))
    it.set_param("silent", "1")
    it.init()
    n = 0
    t0 = time.perf_counter()
    it.before_first()
    while it.next():
        n += 1
    return n / (time.perf_counter() - t0)


def main(argv) -> int:
    n = int(argv[0]) if len(argv) > 0 else 2000
    size = int(argv[1]) if len(argv) > 1 else 256
    threads = int(argv[2]) if len(argv) > 2 else 4
    device = argv[3] if len(argv) > 3 else DEFAULT_DEVICE
    native = ("nvJPEG" if device.startswith(("cuda", "gpu", "tpu"))
              else "PIL in the native path's order")
    with tempfile.TemporaryDirectory() as tmp:
        lst, bin_path = make_dataset(tmp, n, size)
        py_ips = run_mode(lst, bin_path, 0, threads, device)
        print(f"python decode: {py_ips:.1f} images/sec "
              f"({n} x {size}x{size} JPEG)")
        nat_ips = run_mode(lst, bin_path, 1, threads, device)
        print(f"native decode ({native}, {threads} threads, {device}): "
              f"{nat_ips:.1f} images/sec ({nat_ips / py_ips:.2f}x "
              "python)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
