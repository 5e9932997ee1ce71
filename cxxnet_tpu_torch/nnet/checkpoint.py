"""Model checkpoint format: own copy of cxxnet_tpu/nnet/checkpoint.py's
save_model/load_model, byte for byte the same format, with the
telemetry and fault-injection hooks dropped.

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
import struct
import zlib
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np


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
    for _, a in arrays:
        cw.write(np.ascontiguousarray(a).tobytes())
    fo.write(TRAILER_MAGIC)
    fo.write(struct.pack("<Q", cw.nbytes))
    fo.write(struct.pack("<I", cw.crc))


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
