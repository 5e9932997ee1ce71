"""Model checkpoint format (counterpart of cxxnet_tpu/nnet/checkpoint.py,
byte for byte the same format, with the same telemetry and fault
points, and the serving front's validate_file / publish_model /
read_publish_meta).

Role parity with the reference model file (SURVEY.md Appendix B:
[int net_type][NetConfig][epoch][model blob]), re-designed as
[magic][json header][raw little-endian arrays]:

- header carries net_type, the NetConfig structure dict, epoch counter,
  and an ordered manifest of arrays (pytree path, dtype, shape);
- the reference does NOT checkpoint optimizer state (momentum resets on
  resume - sgd_updater-inl.hpp:33-37); we keep that default but support
  `save_optimizer=1` which appends updater state arrays, an explicit
  improvement the format records in the header.
- pytree paths join nested dict keys with a separator recorded in the
  header ("/" normally; an ASCII unit separator when a layer name
  itself contains "/"), so arbitrary config-given layer names
  round-trip.
- an integrity TRAILER follows the arrays: [b"CXCRC001"][u64 payload
  bytes][u32 crc32-of-payload]. load_model validates it (a flipped or
  missing byte anywhere fails loudly instead of resuming from garbage);
  pre-trailer files still load. docs/FAULT_TOLERANCE.md has the spec.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from cxxnet_tpu_torch import telemetry
from cxxnet_tpu_torch.utils import fault

MAGIC = b"CXTPU001"
TRAILER_MAGIC = b"CXCRC001"
TRAILER_LEN = len(TRAILER_MAGIC) + 8 + 4
_ALT_SEP = "\x1f"  # used when a key contains "/"
_MAX_HEADER = 1 << 30


class _CrcWriter:
    """Pass-through writer accumulating crc32 + byte count."""

    def __init__(self, fo: BinaryIO):
        self.fo = fo
        self.crc = 0
        self.nbytes = 0

    def write(self, buf: bytes) -> int:
        self.crc = zlib.crc32(buf, self.crc)
        self.nbytes += len(buf)
        return self.fo.write(buf)


class _CrcReader:
    """Pass-through reader accumulating crc32 + byte count."""

    def __init__(self, fi: BinaryIO):
        self.fi = fi
        self.crc = 0
        self.nbytes = 0

    def read(self, n: int) -> bytes:
        buf = self.fi.read(n)
        self.crc = zlib.crc32(buf, self.crc)
        self.nbytes += len(buf)
        return buf


def _flatten(tree: Any, sep: str,
             prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], sep,
                                f"{prefix}{sep}{k}" if prefix else k))
    else:
        out.append((prefix, np.asarray(tree)))
    return out


def _keys(tree: Any):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield k
            yield from _keys(v)


def _pick_sep(*trees) -> str:
    for tree in trees:
        if tree is None:
            continue
        for k in _keys(tree):
            if "/" in str(k):
                return _ALT_SEP
    return "/"


def _unflatten(items: Dict[str, np.ndarray], sep: str) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, arr in items.items():
        keys = path.split(sep)
        d = root
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = arr
    return root


def save_model(fo: BinaryIO, net_type: int, net_structure: dict, epoch: int,
               params: dict, opt_state: Optional[dict] = None) -> None:
    t0 = time.perf_counter()
    sep = _pick_sep(params, opt_state)
    flat_params = _flatten(params, sep)
    flat_opt = _flatten(opt_state, sep) if opt_state is not None else []
    header = {
        "net_type": net_type,
        "net": net_structure,
        "epoch": int(epoch),
        "sep": sep,
        "params": [
            {"path": p, "dtype": str(a.dtype), "shape": list(a.shape)}
            for p, a in flat_params
        ],
        "opt_state": [
            {"path": p, "dtype": str(a.dtype), "shape": list(a.shape)}
            for p, a in flat_opt
        ],
    }
    hbytes = json.dumps(header).encode("utf-8")
    cw = _CrcWriter(fo)
    cw.write(MAGIC)
    cw.write(struct.pack("<q", len(hbytes)))
    cw.write(hbytes)
    arrays = flat_params + flat_opt
    midpoint = len(arrays) // 2
    for i, (_, a) in enumerate(arrays):
        buf = np.ascontiguousarray(a).tobytes()
        if i == midpoint:
            # `save_model` fault point, deliberately MID-payload so an
            # injected kill/crash models preemption during the write
            # (tests prove the atomic-save protocol leaves no
            # truncated final file). corrupt: emit half of this array
            # and stop - structurally truncated, crc-trailer-less -
            # the shape a non-atomic writer would have left on disk.
            if fault.fault_point("save_model") == "corrupt":
                cw.write(buf[:max(1, len(buf) // 2)])
                return
        cw.write(buf)
    if not arrays and fault.fault_point("save_model") == "corrupt":
        return  # header-only blob, still trailer-less -> invalid
    fo.write(TRAILER_MAGIC)
    fo.write(struct.pack("<Q", cw.nbytes))
    fo.write(struct.pack("<I", cw.crc))
    # serialization-only accounting (the fsync/replace cost of the
    # atomic protocol is timed by the task layer's checkpoint.save)
    telemetry.observe("checkpoint.write_s", time.perf_counter() - t0)
    telemetry.inc("checkpoint.bytes_written", cw.nbytes + TRAILER_LEN)


def _read_exact(fi: BinaryIO, n: int, what: str) -> bytes:
    buf = fi.read(n)
    if len(buf) != n:
        raise ValueError(
            f"invalid model file: truncated while reading {what} "
            f"(wanted {n} bytes, got {len(buf)})")
    return buf


def load_model(fi: BinaryIO) -> dict:
    """Returns {net_type, net, epoch, params, opt_state or None}.

    Validates the crc32 trailer when present; raises ValueError on any
    truncation / corruption instead of returning garbage weights."""
    t0 = time.perf_counter()
    cr = _CrcReader(fi)
    magic = cr.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError("invalid model file (bad magic)")
    (hlen,) = struct.unpack("<q", _read_exact(cr, 8, "header length"))
    if hlen <= 0 or hlen > _MAX_HEADER:
        raise ValueError(
            f"invalid model file: implausible header length {hlen}")
    try:
        header = json.loads(_read_exact(cr, hlen, "header").decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError("invalid model file: corrupt header") from e
    sep = header.get("sep", "/")  # pre-sep files used "/"

    def read_arrays(manifest):
        items = {}
        for ent in manifest:
            n = int(np.prod(ent["shape"])) if ent["shape"] else 1
            try:
                dtype = np.dtype(ent["dtype"])
            except TypeError as e:
                raise ValueError(
                    f"invalid model file: unknown dtype {ent['dtype']!r} "
                    f"for {ent['path']!r}") from e
            buf = _read_exact(cr, n * dtype.itemsize,
                              f"array {ent['path']!r}")
            items[ent["path"]] = np.frombuffer(
                buf, dtype=dtype).reshape(ent["shape"]).copy()
        return items

    params = _unflatten(read_arrays(header["params"]), sep)
    opt_state = (_unflatten(read_arrays(header["opt_state"]), sep)
                 if header["opt_state"] else None)
    _check_trailer(fi, cr)
    telemetry.observe("checkpoint.read_s", time.perf_counter() - t0)
    telemetry.inc("checkpoint.bytes_read", cr.nbytes)
    return {
        "net_type": header["net_type"],
        "net": header["net"],
        "epoch": header["epoch"],
        "params": params,
        "opt_state": opt_state,
    }


def _check_trailer(fi: BinaryIO, cr: _CrcReader) -> None:
    """Validate the integrity trailer, if any, after the arrays.

    - no bytes follow: pre-trailer file, accepted unvalidated;
    - a (possibly truncated) trailer follows: length + crc must match;
    - anything else: not ours - rewound and ignored (a wrapping stream
      may carry unrelated framing after the model blob)."""
    payload_bytes, payload_crc = cr.nbytes, cr.crc
    tail = fi.read(TRAILER_LEN)
    if not tail:
        return
    if not tail.startswith(TRAILER_MAGIC):
        if TRAILER_MAGIC.startswith(tail[:len(TRAILER_MAGIC)]):
            raise ValueError(
                "invalid model file: truncated integrity trailer")
        try:
            fi.seek(-len(tail), 1)
        except (OSError, ValueError):
            pass
        return
    if len(tail) < TRAILER_LEN:
        raise ValueError("invalid model file: truncated integrity trailer")
    (want_bytes,) = struct.unpack(
        "<Q", tail[len(TRAILER_MAGIC):len(TRAILER_MAGIC) + 8])
    (want_crc,) = struct.unpack("<I", tail[len(TRAILER_MAGIC) + 8:])
    if want_bytes != payload_bytes:
        raise ValueError(
            f"invalid model file: payload length mismatch (trailer says "
            f"{want_bytes} bytes, read {payload_bytes})")
    if want_crc != payload_crc:
        raise ValueError(
            f"invalid model file: crc32 mismatch (trailer {want_crc:#010x}"
            f" != computed {payload_crc:#010x}) - corrupt checkpoint")


def validate_file(path: str) -> Optional[str]:
    """Cheap validity probe for an on-disk checkpoint: returns None when
    the file is a complete, uncorrupted model, else a one-line reason.

    Files with the integrity trailer are validated by streaming crc32
    (no array materialization); trailer-less native files fall back to
    a full parse; non-native (legacy cxxnet-binary) files cannot be
    cheaply validated and are assumed valid unless empty. Used by the
    resume path to walk backward past corrupt/truncated checkpoints."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as fi:
            head = fi.read(len(MAGIC))
            if len(head) < len(MAGIC):
                return f"file too short ({size} bytes)"
            if head != MAGIC:
                return None  # legacy/foreign format: assume valid
            if size >= len(MAGIC) + TRAILER_LEN:
                fi.seek(size - TRAILER_LEN)
                tail = fi.read(TRAILER_LEN)
                if tail.startswith(TRAILER_MAGIC):
                    (want_bytes,) = struct.unpack(
                        "<Q", tail[len(TRAILER_MAGIC):
                                   len(TRAILER_MAGIC) + 8])
                    (want_crc,) = struct.unpack(
                        "<I", tail[len(TRAILER_MAGIC) + 8:])
                    if want_bytes != size - TRAILER_LEN:
                        return (f"payload length mismatch (trailer says "
                                f"{want_bytes}, file has "
                                f"{size - TRAILER_LEN})")
                    fi.seek(0)
                    crc, left = 0, want_bytes
                    while left > 0:
                        buf = fi.read(min(1 << 20, left))
                        if not buf:
                            return "file shrank while validating"
                        crc = zlib.crc32(buf, crc)
                        left -= len(buf)
                    if crc != want_crc:
                        return (f"crc32 mismatch ({crc:#010x} != trailer "
                                f"{want_crc:#010x})")
                    return None
            # no trailer at EOF (pre-trailer file): structural check
            # from the header alone - the arrays are raw fixed-size
            # bytes, so the header-promised payload length is the full
            # validation a full parse could do, without materializing
            # the arrays (resume would load them a second time anyway)
            fi.seek(len(MAGIC))
            (hlen,) = struct.unpack("<q", _read_exact(fi, 8,
                                                      "header length"))
            if hlen <= 0 or hlen > _MAX_HEADER:
                return f"implausible header length {hlen}"
            header = json.loads(
                _read_exact(fi, hlen, "header").decode("utf-8"))
            need = 0
            for ent in header["params"] + (header["opt_state"] or []):
                n = 1
                for d in ent["shape"]:
                    n *= d
                need += n * np.dtype(ent["dtype"]).itemsize
            payload = len(MAGIC) + 8 + hlen + need
            if size < payload:
                return (f"truncated: file has {size} bytes, header "
                        f"promises {payload}")
            if size > payload:
                # stray tail bytes: defer to the real parser's
                # trailer/framing rules (rare, so the full parse cost
                # is acceptable here)
                fi.seek(0)
                load_model(fi)
        return None
    except (OSError, TypeError, ValueError, KeyError, struct.error) as e:
        return str(e)


def publish_model(src_path: str, publish_path: str) -> None:
    """Publish a saved checkpoint to a serving-watched path
    (docs/SERVING.md "Hot-swap runbook"): a streaming atomic copy
    (tmp + fsync + os.replace), so a live Server's `swap_watch`
    poller only ever observes a complete file appear - never a
    half-written one. The `swap_torn_checkpoint` fault point
    ("corrupt") publishes a deliberately truncated, trailer-less copy
    instead, driving the swap-reject path in tests and the
    serve-http-smoke torn-checkpoint leg."""
    import json
    t0 = time.perf_counter()
    torn = fault.fault_point("swap_torn_checkpoint") == "corrupt"
    size = os.path.getsize(src_path)
    copied = 0
    # a torn publish keeps roughly half the payload and drops the
    # rest (incl. the crc trailer): the shape a non-atomic writer
    # killed mid-copy would have left behind
    budget = max(1, size // 2) if torn else size
    # provenance sidecar FIRST (then the model copy): the watcher
    # triggers on the model file's stat, so the published model is
    # never observable without its metadata - swap/canary events can
    # always name the source checkpoint they promoted or rolled back
    with fault.atomic_writer(publish_path + ".meta", "w") as fm:
        fm.write(json.dumps({
            "src": os.path.abspath(src_path),
            "bytes": budget,
            "torn": bool(torn),
        }, sort_keys=True))
    with open(src_path, "rb") as fi, \
            fault.atomic_writer(publish_path) as fo:
        while copied < budget:
            buf = fi.read(min(1 << 20, budget - copied))
            if not buf:
                break
            fo.write(buf)
            copied += len(buf)
    telemetry.event("checkpoint", op="publish", src=src_path,
                    path=publish_path, bytes=copied, torn=torn,
                    secs=round(time.perf_counter() - t0, 4))


def read_publish_meta(publish_path: str):
    """Provenance sidecar of a published checkpoint (written by
    publish_model next to the model file), or None when absent or
    unparseable - pre-sidecar publishes and hand-copied files stay
    swappable."""
    import json
    try:
        with open(publish_path + ".meta", "r") as fi:
            meta = json.load(fi)
        return meta if isinstance(meta, dict) else None
    except (OSError, ValueError):
        return None
