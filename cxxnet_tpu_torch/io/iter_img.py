"""Image-list iterators (counterpart of cxxnet_tpu/io/iter_img.py).

- ImageIterator (`img`): .lst file + loose image files
  (src/io/iter_img-inl.hpp:16-137).
- ImageBinIterator (`imgbin`/`imgbinx`): .lst + packed BinaryPage .bin
  with background page prefetch (src/io/iter_thread_imbin-inl.hpp and
  iter_thread_imbin_x-inl.hpp roles merged: page-level prefetch thread +
  in-memory decode on a thread pool, instance-level shuffle, multi-bin
  template support, per-worker sharding).

.lst line format: `index \\t label... \\t filename`.
Images decode to RGB (c,h,w) uint8 arrays.

Decoding (`decode_image`) tells the formats apart by their magic bytes.
Binary PPM / PGM (P6 / P5, maxval 255) is decoded here with numpy - the
same bytes PIL's decode gives; every other format (JPEG, PNG, ...) is
decoded by PIL, imported at the call, and a machine without Pillow gets
an ImportError naming it and the blob's format.

`use_native` picks imgbin's decoder as in the JAX package (-1 auto, 0
off, 1 force), on the device `create_iterator` was given:

| device | -1 | 0 | 1 |
| --- | --- | --- | --- |
| the card | nvJPEG (`io/native.py`) | PIL path | nvJPEG |
| `cpu` | PIL path | PIL path | `PlainBinReader` |
| none given | PIL path | PIL path | nvJPEG on the card (raises without one) |

The native path (nvJPEG or its plain version) serves records in stream
order and shuffles through a bounded reservoir; the PIL path reads pages
on a thread, decodes on a pool and shuffles within a page. -1 means
nvJPEG on the card because the JAX package's -1 means "native where it
is built", and the port builds its decoder at first use on any card.
"""

from __future__ import annotations

import io as _io
import queue
import threading
from typing import List, Optional, Tuple

import numpy as np

from cxxnet_tpu_torch.io.data import DataInst
from cxxnet_tpu_torch.io.iterators import DataIter, say, shard_quota
from cxxnet_tpu_torch.io.thread_util import (
    ErrorBox, drain_and_join, stoppable_put)
from cxxnet_tpu_torch.utils.binary_page import iter_page_blobs
from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# leading bytes of the formats decode_image tells apart
_MAGIC = ((b"P6", "PPM"), (b"P5", "PGM"), (b"\xff\xd8\xff", "JPEG"),
          (b"\x89PNG\r\n\x1a\n", "PNG"))


def image_format(blob: bytes) -> str:
    """The format of an image blob by its magic bytes ("other" for any
    format but these four)."""
    for magic, name in _MAGIC:
        if blob.startswith(magic):
            return name
    return "other"


def _pnm_header(blob: bytes) -> Tuple[int, int, int, int]:
    """(width, height, maxval, raster offset) of a binary P6 / P5 blob:
    three whitespace-separated decimal fields after the magic, `#`
    comments running to the end of their line, and exactly one
    whitespace byte before the raster."""
    fields: List[int] = []
    pos = 2
    while len(fields) < 3:
        if pos >= len(blob):
            raise ValueError("truncated PNM header")
        ch = blob[pos:pos + 1]
        if ch.isspace():
            pos += 1
        elif ch == b"#":
            end = blob.find(b"\n", pos)
            pos = len(blob) if end < 0 else end + 1
        else:
            start = pos
            while pos < len(blob) and blob[pos:pos + 1].isdigit():
                pos += 1
            if pos == start:
                raise ValueError(f"bad PNM header byte {ch!r}")
            fields.append(int(blob[start:pos]))
    if pos >= len(blob) or not blob[pos:pos + 1].isspace():
        raise ValueError("PNM header must end in one whitespace byte")
    return fields[0], fields[1], fields[2], pos + 1


def _decode_pnm(blob: bytes, channels: int) -> Optional[np.ndarray]:
    """(3, h, w) uint8 of a maxval-255 binary PPM (channels 3) or PGM
    (channels 1, the gray plane repeated into three channels as PIL's
    convert("RGB") does); None for another maxval."""
    w, h, maxval, off = _pnm_header(blob)
    if maxval != 255:
        return None
    n = w * h * channels
    if len(blob) - off < n:
        raise ValueError(f"truncated PNM raster: {len(blob) - off} of "
                         f"{n} bytes")
    pix = np.frombuffer(blob, np.uint8, n, off).reshape(h, w, channels)
    if channels == 1:
        return np.repeat(pix.reshape(1, h, w), 3, axis=0)
    return np.ascontiguousarray(pix.transpose(2, 0, 1))


def decode_image(blob: bytes) -> np.ndarray:
    """Image bytes -> (c, h, w) uint8 RGB in [0,255].

    uint8 is both reference-faithful (cv::Mat u8 end to end) and what
    device_augment staging wants (1/4 the f32 H2D bytes); the host
    augmentation path casts to f32 per instance exactly where the
    reference does (augment.py _set_data)."""
    fmt = image_format(blob)
    if fmt in ("PPM", "PGM"):
        out = _decode_pnm(blob, 3 if fmt == "PPM" else 1)
        if out is not None:
            return out
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding this image ({fmt}) needs Pillow (PIL), which is not "
            "installed; cxxnet_tpu_torch decodes only binary PPM/PGM "
            "(P6/P5, maxval 255) without it") from e
    img = Image.open(_io.BytesIO(blob))
    img = img.convert("RGB")
    arr = np.asarray(img)  # (h, w, 3) uint8
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def load_image_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())


def parse_list_file(path: str) -> List[Tuple[int, List[float], str]]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip("\n\r")
            if not line:
                continue
            parts = line.split("\t")
            idx = int(float(parts[0]))
            labels = [float(t) for t in parts[1:-1]]
            out.append((idx, labels, parts[-1]))
    return out


class ImageIterator(DataIter):
    """`img`: loose image files listed in a .lst."""

    K_RAND_MAGIC = 111

    def __init__(self) -> None:
        self.path_imglist = ""
        self.path_root = ""
        self.shuffle = 0
        self.silent = 0
        self.label_width = 1
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.rng = np.random.RandomState(self.K_RAND_MAGIC)
        self.order: List[int] = []
        self.loc = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "image_list":
            self.path_imglist = val
        if name == "image_root":
            self.path_root = val
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "label_width":
            self.label_width = int(val)
        if name == "seed_data":
            self.rng = np.random.RandomState(self.K_RAND_MAGIC + int(val))
        if name == "dist_num_worker":
            self.dist_num_worker = int(val)
        if name == "dist_worker_rank":
            self.dist_worker_rank = int(val)

    def init(self) -> None:
        entries = parse_list_file(self.path_imglist)
        nw = self.dist_num_worker
        if nw > 1:
            quota, rank = shard_quota(len(entries), nw,
                                      self.dist_worker_rank)
            entries = entries[rank::nw][:quota]
        self.entries = entries
        self.order = list(range(len(self.entries)))
        say(self.silent, f"ImageIterator: {self.path_imglist}, "
                         f"{len(self.entries)} images")
        self.before_first()

    def before_first(self) -> None:
        if self.shuffle:
            self.rng.shuffle(self.order)
        self.loc = 0

    def next(self) -> bool:
        if self.loc >= len(self.order):
            return False
        idx, labels, fname = self.entries[self.order[self.loc]]
        self.loc += 1
        data = load_image_file(self.path_root + fname)
        label = np.asarray(labels[:self.label_width], dtype=np.float32)
        self._out = DataInst(index=idx, data=data, label=label)
        return True

    def value(self) -> DataInst:
        return self._out


class _PageReader(threading.Thread):
    """Background thread streaming page blob-lists from .bin files."""

    def __init__(self, paths: List[str], out_q: "queue.Queue",
                 stop: threading.Event):
        super().__init__(daemon=True)
        self.paths = paths
        self.out_q = out_q
        self.stop_event = stop
        self.err = ErrorBox()

    def _put(self, item) -> bool:
        return stoppable_put(self.out_q, self.stop_event, item)

    def run(self) -> None:
        try:
            for path in self.paths:
                with open(path, "rb") as f:
                    for blobs in iter_page_blobs(f):
                        if not self._put(blobs):
                            return
        except BaseException as e:  # noqa: BLE001 - re-raised by consumer
            # lock-guarded handoff, published before the sentinel put
            self.err.put(e)
        finally:
            self._put(None)  # sentinel


class ImageBinIterator(DataIter):
    """`imgbin` / `imgbinx`: .lst + BinaryPage-packed image blobs.

    The reference's two iterators differ in pipelining depth; here one
    implementation covers both config names: a prefetch thread loads 64MiB
    pages ahead of decode (ThreadBuffer role), a bounded window of blobs
    decodes on a thread pool, instances optionally shuffle inside a page
    (imgbinx shuffle_), and `image_conf_prefix` / `image_conf_ids`
    template multi-file datasets with round-robin sharding across
    distributed workers (iter_thread_imbin-inl.hpp:189-220). Under
    `use_native` (the module's table) the records come from the native
    decoder instead, on `device`.
    """

    K_RAND_MAGIC = 222

    def __init__(self, device: Optional[str] = None) -> None:
        self.path_imglist = ""
        self.path_imgbin: List[str] = []
        self.conf_prefix = ""
        self.conf_ids = ""
        self.shuffle = 0
        self.silent = 0
        self.label_width = 1
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.rng = np.random.RandomState(self.K_RAND_MAGIC)
        # native decode pipeline: -1 auto, 0 off, 1 force (module table)
        self.use_native = -1
        self.decode_threads = 4
        self.shuffle_buffer = 1024
        self.device_augment = 0
        # the device create_iterator was given ("cpu", "cuda:0") or None
        self.device = None if device is None else str(device)
        self._native = None
        self._native_dev = None  # torch.device of the native route
        self._native_mode = False
        self._pool = None  # Python-path decode ThreadPoolExecutor

    def set_param(self, name: str, val: str) -> None:
        if name == "image_list":
            self.path_imglist = val
        if name == "image_bin":
            self.path_imgbin = [val]
        if name == "image_conf_prefix":
            self.conf_prefix = val
        if name == "image_conf_ids":
            self.conf_ids = val
        if name == "shuffle":
            self.shuffle = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "label_width":
            self.label_width = int(val)
        if name == "dist_num_worker":
            self.dist_num_worker = int(val)
        if name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        if name == "seed_data":
            self.rng = np.random.RandomState(self.K_RAND_MAGIC + int(val))
        if name == "use_native":
            self.use_native = int(val)
        if name == "decode_threads":
            self.decode_threads = int(val)
        if name == "shuffle_buffer":
            self.shuffle_buffer = int(val)
        if name == "device_augment":
            # raw uint8 staging for the in-step augment path: the native
            # pipeline yields CHW uint8 records instead of CHW float32
            self.device_augment = int(val)

    def _expand_templates(self) -> Tuple[List[str], List[str]]:
        """image_conf_prefix with %d + image_conf_ids `a-b` -> shard lists
        round-robin over workers (reference :189-220)."""
        if not self.conf_prefix:
            return [self.path_imglist], list(self.path_imgbin)
        a, b = (int(t) for t in self.conf_ids.split("-"))
        ids = [i for i in range(a, b + 1)]
        mine = [i for k, i in enumerate(ids)
                if k % self.dist_num_worker == self.dist_worker_rank]
        lists = [(self.conf_prefix % i) + ".lst" for i in mine]
        bins = [(self.conf_prefix % i) + ".bin" for i in mine]
        return lists, bins

    def init(self) -> None:
        lists, bins = self._expand_templates()
        self.entries = []
        for lst in lists:
            self.entries.extend(parse_list_file(lst))
        self.bins = bins
        if self.shuffle and self.shuffle_buffer < 1:
            raise ValueError("shuffle=1 requires shuffle_buffer >= 1")
        self._native_dev = self._native_route()
        self._native_mode = self._native_dev is not None
        # without conf_prefix file-sharding, multi-worker runs shard at
        # the INSTANCE level (ordinal % nw == rank, quota-trimmed so
        # every worker serves the same count - unequal batch counts
        # would desynchronize the per-batch SPMD collectives); with
        # conf_prefix, files are round-robin sharded above instead
        self._shard_nw = (self.dist_num_worker
                          if (self.dist_num_worker > 1
                              and not self.conf_prefix) else 1)
        self._shard_quota = 0
        if self._shard_nw > 1:
            self._shard_quota, _ = shard_quota(
                len(self.entries), self._shard_nw, self.dist_worker_rank)
        mode = "native" if self._native_mode else "python"
        say(self.silent, f"ImageBinIterator: {len(self.entries)} images "
                         f"from {len(bins)} bins ({mode} decode)")
        self.before_first()

    def _native_route(self):
        """The torch.device the native path decodes on (cuda: nvJPEG,
        cpu: PlainBinReader), or None for the PIL path (the module's
        table). With no device given, use_native = 1 means the card and
        raises, naming device="cpu", where there is none."""
        if self.use_native == 0:
            return None
        if self.device is None:
            return (resolve_device(DEFAULT_DEVICE) if self.use_native == 1
                    else None)
        dev = resolve_device(self.device)
        if dev.type == "cpu" and self.use_native != 1:
            return None
        return dev

    def before_first(self) -> None:
        self._served = 0
        if self._native_mode:
            if self._native is None:
                self._native = self._open_native()
            self._native.before_first()
            self._nseq = 0
            self._nbuf: List[DataInst] = []
            return
        self._shutdown_reader()
        self._stop = threading.Event()
        self._q: "queue.Queue" = queue.Queue(maxsize=4)
        self._reader = _PageReader(self.bins, self._q, self._stop)
        self._reader.start()
        if self._pool is None and self.decode_threads > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.decode_threads,
                thread_name_prefix="cxn-decode")
        self._page_objs: List[bytes] = []
        self._page_order: List[int] = []
        self._page_pos = 0
        self._entry_pos = 0
        self._futures = {}
        self._submit_pos = 0
        self._eof = False

    def _shutdown_reader(self) -> None:
        reader = getattr(self, "_reader", None)
        if reader is None or not reader.is_alive():
            return
        drain_and_join(self._q, reader, self._stop)
        self._reader = None

    def _next_page(self) -> bool:
        if self._eof:
            # the reader put its sentinel and exited: a next() after the
            # end of the pass (a batch adapter zero-padding its tail
            # asks again) must not block on its empty queue
            return False
        blobs = self._q.get()
        if blobs is None:
            self._eof = True
            exc = self._reader.err.take()
            if exc is not None:
                raise RuntimeError(
                    "imgbin page reader failed") from exc
            return False
        self._page_objs = blobs
        self._page_order = list(range(len(self._page_objs)))
        if self.shuffle:
            self.rng.shuffle(self._page_order)
        self._page_pos = 0
        self._submit_pos = 0
        self._futures = {}
        self._fill_decode_window()
        return True

    def _fill_decode_window(self) -> None:
        """Second pipeline stage: keep a bounded window of blobs decoding
        on the pool (PIL and numpy release the GIL in their copies)
        while the consumer drains earlier ones - the decode-pool role
        iter_thread_imbin's pipeline plays, without densifying a whole
        64MiB page at once."""
        if self._pool is None:
            return
        ahead = max(8, 2 * self.decode_threads)
        while (self._submit_pos < len(self._page_order)
               and self._submit_pos - self._page_pos < ahead):
            j = self._page_order[self._submit_pos]
            ent_idx = self._entry_pos + j
            if (self._shard_nw <= 1
                    or ent_idx % self._shard_nw == self.dist_worker_rank):
                # non-owned instances are skipped by next(); don't burn
                # the decode pool on them
                self._futures[self._submit_pos] = self._pool.submit(
                    decode_image, self._page_objs[j])
            self._submit_pos += 1

    def _open_native(self):
        """The native path's reader: nvJPEG on the card, its plain version
        on the CPU. out_mode follows device_augment as in the JAX package:
        the shuffle reservoir's cap divides by a record's bytes, so uint8
        and float32 records shuffle differently."""
        from cxxnet_tpu_torch.io.native import NativeBinReader, PlainBinReader
        out_mode = 2 if self.device_augment else 1
        if self._native_dev.type == "cuda":
            return NativeBinReader(self.bins, n_threads=self.decode_threads,
                                   out_mode=out_mode,
                                   device=str(self._native_dev))
        return PlainBinReader(self.bins, n_threads=self.decode_threads,
                              out_mode=out_mode)

    def _pull_native(self) -> Optional[DataInst]:
        while True:
            if self._shard_nw > 1 and self._served >= self._shard_quota:
                return None
            data = self._native.next()
            if data is None:
                return None
            ordinal = self._nseq
            self._nseq += 1
            if self._shard_nw > 1:
                if ordinal % self._shard_nw != self.dist_worker_rank:
                    continue
                self._served += 1
            idx, labels, _ = self.entries[ordinal]
            label = np.asarray(labels[:self.label_width],
                               dtype=np.float32)
            return DataInst(index=idx, data=data, label=label)

    def _next_native(self) -> bool:
        """The native stream is strictly ordered; shuffle uses a bounded
        reservoir (the analog of the Python path's within-page shuffle),
        capped to ~64MiB of decoded records (the page-shuffle window
        size) so large images don't pin GBs."""
        if self.shuffle:
            if not self._nbuf:
                inst = self._pull_native()
                if inst is not None:
                    self._nbuf.append(inst)
            if self._nbuf:
                per_img = max(1, self._nbuf[0].data.nbytes)
                cap = min(self.shuffle_buffer,
                          max(16, (64 << 20) // per_img))
                while len(self._nbuf) < cap:
                    inst = self._pull_native()
                    if inst is None:
                        break
                    self._nbuf.append(inst)
            if not self._nbuf:
                return False
            j = int(self.rng.randint(len(self._nbuf)))
            self._nbuf[j], self._nbuf[-1] = self._nbuf[-1], self._nbuf[j]
            self._out = self._nbuf.pop()
            return True
        inst = self._pull_native()
        if inst is None:
            return False
        self._out = inst
        return True

    def next(self) -> bool:
        if self._native_mode:
            return self._next_native()
        while True:
            while self._page_pos >= len(self._page_objs):
                if not self._next_page():
                    return False
            k = self._page_pos
            ent_idx = self._entry_pos + self._page_order[k]
            self._page_pos += 1
            owned = True
            if self._shard_nw > 1:
                if self._served >= self._shard_quota:
                    return False
                owned = (ent_idx % self._shard_nw
                         == self.dist_worker_rank)
            if owned and k in self._futures:
                data = self._futures.pop(k).result()
            elif owned:
                data = decode_image(self._page_objs[self._page_order[k]])
            else:
                self._futures.pop(k, None)
            self._fill_decode_window()
            if self._page_pos >= len(self._page_objs):
                self._entry_pos += len(self._page_objs)
            if not owned:
                continue
            if self._shard_nw > 1:
                self._served += 1
            idx, labels, _ = self.entries[ent_idx]
            label = np.asarray(labels[:self.label_width],
                               dtype=np.float32)
            self._out = DataInst(index=idx, data=data, label=label)
            return True

    def value(self) -> DataInst:
        return self._out
