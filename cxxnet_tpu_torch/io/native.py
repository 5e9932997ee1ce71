"""The native image decoder (counterpart of cxxnet_tpu/io/native.py, the
`use_native` pipeline).

`NativeBinReader` binds `csrc/nvjpeg_io.cu` with ctypes: a page-reader
thread streams the 64 MiB BinaryPages of one or more .bin files, a pool
of `n_threads` workers decodes the JPEG blobs with nvJPEG on a CUDA
device (each worker with its own nvjpeg state, stream and buffers), and
records come back strictly in stream order through a reorder buffer
bounded by `max_inflight`. The library is built from the repo's source
by `kernels.py` at first use. Blobs the decoder does not take (PNG, PPM,
CMYK JPEGs, JPEGs nvJPEG rejects) come back raw and are decoded here with
`decode_image`, as the JAX package's reader decodes what libjpeg and
libpng leave (cxxnet_tpu/io/native.py:129-133). The library counts both
where they happen, in its workers: each image decoded is one launch of
its kernel (`kernels.launches()["nvjpeg_decode"]`), and each blob left
raw one hand-back (`kernels.raw_handbacks()`).

The library's own kernel is `YccToRgb`: the chroma upsampling and the
YCbCr -> RGB conversion of nvJPEG's planar output, in libjpeg's
arithmetic (its "fancy" triangular upsampling where libjpeg takes it,
sample replication elsewhere, and its integer tables), so that a record
sits from PIL's decode of the same blob by nvJPEG's IDCT alone; R, G, B
files skip the conversion and grayscale ones replicate Y. `ycc_to_rgb`
is its wrapper on tensors (the kernel on the card, `ycc_to_rgb_plain`
on the CPU).

`PlainBinReader` is the reader's plain version: the same interface and order,
pages read by `utils/binary_page.py` with the native reader's checks,
every blob decoded by `decode_image` on a thread pool. The CPU path
(`use_native = 1` on `device = "cpu"`) and the CPU tests use it, never
the card's main path.

Records are (c, h, w) CHW: float32 under out_mode 1, uint8 under
out_mode 2 (device_augment staging). Nothing falls back: a library that
does not build or load, or a CUDA / nvJPEG error while decoding, raises
and names `use_native = 0` (the host's PIL path).
"""

from __future__ import annotations

import collections
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.io.iter_img import decode_image
from cxxnet_tpu_torch.utils.binary_page import read_bin_blobs
from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

DECODER = kernels.DECODER
_ERR_DEVICE = 2  # cxio_error_kind: a CUDA / nvJPEG error

# How far nvJPEG's decode may sit from PIL's (libjpeg's) decode of the
# same blob, in uint8 levels, whatever the JPEG's kind: YccToRgb applies
# libjpeg's own upsampling and colour tables, so only the IDCTs differ.
PIL_BAR = {"max": 3, "mean": 0.5}


def pil_agreement(got: Sequence[np.ndarray],
                  want: Sequence[np.ndarray]) -> Dict[str, float]:
    """|got - want| over records of equal shapes: the largest, the mean
    and the share above 16 levels."""
    if len(got) != len(want) or not want:
        raise ValueError(f"{len(got)} records against {len(want)}")
    d = np.abs(np.stack(got).astype(np.float64)
               - np.stack(want).astype(np.float64))
    return {"max": float(d.max()), "mean": float(d.mean()),
            "over16": float((d > 16).mean())}


def within_bar(stats: Dict[str, float],
               bar: Dict[str, float] = PIL_BAR) -> bool:
    return all(stats[k] <= v for k, v in bar.items())


# the (horizontal, vertical) chroma factors YccToRgb takes
FACTORS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
           "4:4:0": (1, 2), "4:1:1": (4, 1)}
# how a JPEG's components are coded (YccToRgb's `coding`): Y, Cb, Cr; R,
# G, B (an Adobe marker with transform 0); grayscale (Y alone)
YCC, RGB, GRAY = 0, 1, 2

# The JPEG kinds the decoder takes, as encode_jpeg writes them: each
# subsampling of FACTORS, grayscale and R, G, B (4:4:4).
JPEG_KINDS = tuple(FACTORS) + ("gray", "rgb")


def encode_jpeg(arr: np.ndarray, kind: str, quality: int = 90) -> bytes:
    """An (h, w) JPEG of `kind` (JPEG_KINDS) from (h, w, 3) uint8 `arr`,
    baseline, written by PIL. PIL writes neither 4:4:0 nor 4:1:1: such a
    blob is a 4:2:2 (4:2:0) file of arr's pixels laid out with as many
    MCUs (8 x 16 for 4:4:0, 32 x 8 for 4:1:1), its frame header re-read
    at the other sampling and at (h, w), a valid JPEG whose pixels are
    those blocks in another arrangement, not arr's."""
    import io
    from PIL import Image
    h, w = arr.shape[:2]
    src = arr
    if kind in ("4:4:0", "4:1:1"):
        # the source's MCU grid (16 x 8 for 4:2:2, 16 x 16 for 4:2:0) has
        # as many columns and rows of MCUs as the target's
        (mh, mw) = (16, 8) if kind == "4:4:0" else (8, 32)
        sh = (8 if kind == "4:4:0" else 16) * -(-h // mh)
        sw = 16 * -(-w // mw)
        src = np.resize(arr, (sh, sw, 3))
    img = Image.fromarray(src[:, :, 0] if kind == "gray" else src)
    sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "4:4:0": 1, "4:1:1": 2,
           "rgb": 0}.get(kind, -1)
    extra = {"keep_rgb": True} if kind == "rgb" else {}
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality, subsampling=sub, **extra)
    blob = buf.getvalue()
    if kind == "rgb" and b"Adobe" not in blob:
        raise RuntimeError("this PIL does not write R, G, B JPEGs "
                           "(keep_rgb)")
    if src is arr:
        return blob
    b = bytearray(blob)
    i = 2
    while b[i + 1] != 0xC0:  # to the baseline frame header (SOF0)
        i += 2 + ((b[i + 2] << 8) | b[i + 3])
    b[i + 5:i + 9] = bytes([h >> 8, h & 255, w >> 8, w & 255])
    b[i + 11] = 0x12 if kind == "4:4:0" else 0x41  # luma's (h, v) factors
    return bytes(b)


def _check_planes(y: torch.Tensor, cb: Optional[torch.Tensor],
                  cr: Optional[torch.Tensor], hf: int, vf: int,
                  coding: int) -> None:
    if coding not in (YCC, RGB, GRAY):
        raise ValueError(f"coding {coding}: YCC, RGB or GRAY")
    if (coding == GRAY) != (cb is None) or (cb is None) != (cr is None):
        raise ValueError("chroma planes: both for YCC and RGB, none for "
                         "GRAY")
    for t in (y, cb, cr):
        if t is None:
            continue
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError("ycc_to_rgb takes contiguous 2-d uint8 planes")
    if coding == GRAY:
        return
    if (hf, vf) not in FACTORS.values():
        raise ValueError(f"chroma factors {(hf, vf)}: those of FACTORS "
                         f"only, {sorted(FACTORS)}")
    (h, w) = y.shape
    want = (-(-h // vf), -(-w // hf))
    if cb.shape != want or cr.shape != want:
        raise ValueError(f"chroma planes {tuple(cb.shape)}, "
                         f"{tuple(cr.shape)}: {want} at factors "
                         f"{(hf, vf)} of a {(h, w)} luma plane")
    if len({y.device, cb.device, cr.device}) != 1:
        raise ValueError("the planes lie on different devices")


def ycc_to_rgb_plain(y: torch.Tensor, cb: Optional[torch.Tensor],
                     cr: Optional[torch.Tensor], hf: int, vf: int,
                     coding: int = YCC) -> torch.Tensor:
    """The plain version of YccToRgb: uint8 planes Y (h, w), Cb and Cr
    (ceil(h / vf), ceil(w / hf)) -> (3, h, w) uint8 RGB. libjpeg's
    upsampling (jdsample.c: its fancy filters, 3/4 nearer + 1/4 further
    sample with edges repeated and its rounding biases, for h2v1 and h2v2
    on planes more than 2 samples wide and for h1v2; replication
    otherwise) and its YCbCr tables (jdcolor.c: FIX(x) = x * 2^16 rounded,
    G floored after adding one half). RGB coding takes the upsampled
    planes as they are; GRAY (no chroma planes) replicates Y."""
    _check_planes(y, cb, cr, hf, vf, coding)
    if coding == GRAY:
        return y.expand(3, *y.shape).clone()
    h, w = y.shape
    dev = y.device
    xs = torch.arange(w, device=dev)
    ys = torch.arange(h, device=dev)
    ix, iy = xs // hf, ys // vf
    odd_x = (xs & 1) == 1
    odd_y = ((ys & 1) == 1)[:, None]

    def up(c):
        c = c.to(torch.int32)
        (ch, cw) = c.shape
        if (hf, vf) == (1, 2):  # h1v2
            iy2 = torch.where(odd_y[:, 0], iy + 1, iy - 1).clamp(0, ch - 1)
            bias = torch.where(odd_y, 2, 1).to(torch.int32)
            return (3 * c[iy] + c[iy2] + bias) >> 2
        if hf != 2 or cw <= 2:
            return c[iy][:, ix]
        jx = torch.where(odd_x, ix + 1, ix - 1).clamp(0, cw - 1)
        if vf == 2:  # h2v2
            iy2 = torch.where(odd_y[:, 0], iy + 1, iy - 1).clamp(0, ch - 1)
            colsum = 3 * c[iy] + c[iy2]
            bias = torch.where(odd_x, 7, 8).to(torch.int32)
            return (3 * colsum[:, ix] + colsum[:, jx] + bias) >> 4
        bias = torch.where(odd_x, 2, 1).to(torch.int32)  # h2v1
        return (3 * c[:, ix] + c[:, jx] + bias) >> 2
    lum = y.to(torch.int32)
    if coding == RGB:
        return torch.stack([lum, up(cb), up(cr)]).to(torch.uint8)
    cbu, cru = up(cb) - 128, up(cr) - 128
    r = lum + ((91881 * cru + 32768) >> 16)
    g = lum + ((-22554 * cbu + 32768 - 46802 * cru) >> 16)
    b = lum + ((116130 * cbu + 32768) >> 16)
    return torch.stack([r, g, b]).clamp(0, 255).to(torch.uint8)


def ycc_to_rgb(y: torch.Tensor, cb: Optional[torch.Tensor],
               cr: Optional[torch.Tensor], hf: int, vf: int,
               coding: int = YCC) -> torch.Tensor:
    """YccToRgb on contiguous uint8 planes at chroma factors (hf, vf)
    (FACTORS; no chroma planes for GRAY): the kernel for CUDA tensors
    (launched on the current stream; the library counts it), the plain
    version for CPU tensors."""
    _check_planes(y, cb, cr, hf, vf, coding)
    if y.device.type == "cpu":
        return ycc_to_rgb_plain(y, cb, cr, hf, vf, coding)
    if y.device.type != "cuda":
        raise ValueError(f"ycc_to_rgb: no kernel for {y.device}")
    lib = _library()
    (h, w) = y.shape
    (ch, cw) = (0, 0) if cb is None else cb.shape
    out = torch.empty((3, h, w), dtype=torch.uint8, device=y.device)
    rc = lib.cxio_ycc_to_rgb(
        y.data_ptr(), None if cb is None else cb.data_ptr(),
        None if cr is None else cr.data_ptr(), w, h, cw, ch, hf, vf, coding,
        out.data_ptr(), torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check(DECODER, rc)
    return out


class CxioRecord(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_ubyte)),
                ("h", ctypes.c_int),
                ("w", ctypes.c_int),
                ("c", ctypes.c_int)]


def _check_mode(out_mode: int) -> None:
    if out_mode not in (1, 2):
        raise ValueError(f"out_mode {out_mode}: 1 (CHW float32) or 2 (CHW "
                         "uint8)")


def _finish(img: np.ndarray, out_mode: int) -> np.ndarray:
    """A host decode (uint8 CHW) in the record type of out_mode."""
    return img if out_mode == 2 else img.astype(np.float32)


def _library() -> ctypes.CDLL:
    """The decoder's library, built at first use; a build or load failure
    raises naming use_native = 0."""
    try:
        return kernels.load(DECODER)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            "use_native: the nvJPEG decoder (cxxnet_tpu_torch/csrc/"
            f"nvjpeg_io.cu) did not build or load: {e}; set use_native = 0 "
            "to decode with PIL on the host") from e


class NativeBinReader:
    """Ordered record stream over .bin files, decoded by nvJPEG on
    `device` (a CUDA device; the default is the card)."""

    def __init__(self, bin_paths: List[str], n_threads: int = 4,
                 max_inflight: int = 64, out_mode: int = 1,
                 device: str = DEFAULT_DEVICE):
        _check_mode(out_mode)
        self._lib = _library()
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"NativeBinReader decodes on a CUDA device, not "
                             f"{dev}; PlainBinReader is its CPU version")
        self.device = dev
        self._mode = out_mode
        arr = (ctypes.c_char_p * len(bin_paths))(
            *[p.encode() for p in bin_paths])
        self._h = self._lib.cxio_open(arr, len(bin_paths), n_threads,
                                      max_inflight, out_mode,
                                      dev.index or 0)
        self._rec = CxioRecord()

    def before_first(self) -> None:
        self._lib.cxio_before_first(self._h)

    def next(self) -> Optional[np.ndarray]:
        """The next record as (c,h,w) CHW (float32 or uint8 per out_mode),
        or None at the end of the stream; a stream error raises (IOError
        for the files, RuntimeError for the card)."""
        if not self._lib.cxio_next(self._h, ctypes.byref(self._rec)):
            err = self._lib.cxio_last_error(self._h)
            if not err:
                return None
            if self._lib.cxio_error_kind(self._h) == _ERR_DEVICE:
                raise RuntimeError(
                    f"nvJPEG decoder on {self.device} failed: "
                    f"{err.decode()}; set use_native = 0 to decode with "
                    "PIL on the host")
            raise IOError(err.decode())
        r = self._rec
        if r.c == 0:  # a blob nvJPEG does not take: decode on the host
            return _finish(decode_image(ctypes.string_at(r.data, r.w)),
                           self._mode)
        n = r.h * r.w * r.c
        ctype = ctypes.c_uint8 if self._mode == 2 else ctypes.c_float
        ptr = ctypes.cast(r.data, ctypes.POINTER(ctype))
        # the library reuses its buffer on the next call: one copy to own it
        return np.ctypeslib.as_array(ptr, shape=(n,)).reshape(
            r.c, r.h, r.w).copy()

    def close(self) -> None:
        if self._h:
            self._lib.cxio_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class PlainBinReader:
    """The plain version of NativeBinReader: the same interface and
    record order, pages read in Python, blobs decoded by decode_image on
    a pool of n_threads (a window of at most max_inflight ahead)."""

    def __init__(self, bin_paths: List[str], n_threads: int = 4,
                 max_inflight: int = 64, out_mode: int = 1):
        _check_mode(out_mode)
        self._paths = list(bin_paths)
        # the native library's defaults where a count is not positive
        self._n_threads = n_threads if n_threads > 0 else 4
        self._max_inflight = max(2, max_inflight if max_inflight > 0
                                 else 64)
        self._mode = out_mode
        self._pool: Optional[ThreadPoolExecutor] = None
        self._blobs = None
        self._window: collections.deque = collections.deque()

    def before_first(self) -> None:
        self._drop_window()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._n_threads,
                thread_name_prefix="cxn-plain-decode")
        self._blobs = read_bin_blobs(self._paths)

    def _drop_window(self) -> None:
        while self._window:
            self._window.popleft().cancel()

    def _fill(self) -> None:
        while self._blobs is not None and len(self._window) < \
                self._max_inflight:
            try:
                blob = next(self._blobs)
            except StopIteration:
                self._blobs = None
                return
            self._window.append(self._pool.submit(decode_image, blob))

    def next(self) -> Optional[np.ndarray]:
        if self._pool is None:
            self.before_first()
        self._fill()
        if not self._window:
            return None
        img = self._window.popleft().result()
        return _finish(img, self._mode)

    def close(self) -> None:
        self._drop_window()
        self._blobs = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


def decoder_facts(device: str = DEFAULT_DEVICE) -> Dict[str, object]:
    """What the decoder runs on: its backend, nvJPEG's version and the
    path of the libnvjpeg this process loaded, and the card's hardware
    JPEG decoder as nvJPEG reports it (engines and cores per engine, or
    the status that says there is none)."""
    lib = _library()
    idx = resolve_device(device).index or 0
    ver = (ctypes.c_int * 3)()
    vst = lib.cxio_version(ver)
    hw = (ctypes.c_uint * 2)()
    hst = lib.cxio_hw_info(idx, hw)
    loaded = None
    with open("/proc/self/maps") as f:
        for line in f:
            if "libnvjpeg" in line:
                loaded = line.split()[-1]
                break
    return {"backend": lib.cxio_backend().decode(),
            "nvjpeg_version": (".".join(str(v) for v in ver) if vst == 0
                               else f"status {vst}"),
            "libnvjpeg": loaded,
            "hw_decoder_status": hst,
            "hw_engines": hw[0],
            "hw_cores_per_engine": hw[1]}
