"""Handle-based shim behind the C ABI (csrc/cxxnet_wrapper.cc;
counterpart of cxxnet_tpu/capi.py).

The reference exposes the trainer over a C ABI in
wrapper/cxxnet_wrapper.cpp:10-352; here the C library embeds CPython and
calls these functions. Caller-owned float32 buffers cross the boundary
as integer addresses plus shapes, read and written through numpy views
(`_as_f32`, `_copy_out`); objects live in a handle registry, so the C
side only ever holds opaque uint64 ids.

Caller memory: every call is done with the caller's buffers when it
returns. An input view is copied to the device synchronously (pageable
memory, never a prefetcher), and a result is read back to the host
before it is written into the caller's buffer.

Error contract: exceptions propagate to the embed layer, which fetches
them through the CPython error indicator and surfaces the message
through CXNGetLastError.

Kernel launches: a C caller has no view of the launch counts of the
port's kernels (kernels.launches()). With CXXNET_LAUNCH_LOG=<path> in
its environment, every call that runs the net rewrites <path> with
them as JSON, also when the call fails.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import threading
from typing import Dict

import numpy as np

from cxxnet_tpu_torch import kernels

from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE
from cxxnet_tpu_torch.wrapper import DataIter, Net

_lock = threading.Lock()
_objects: Dict[int, object] = {}
_next_id = 1


def _register(obj: object) -> int:
    global _next_id
    with _lock:
        hid = _next_id
        _next_id += 1
        _objects[hid] = obj
    return hid


def _get(hid: int):
    return _objects[hid]


def _as_f32(addr: int, *shape: int) -> np.ndarray:
    n = 1
    for s in shape:
        n *= int(s)
    buf = (ctypes.c_float * n).from_address(addr)
    return np.frombuffer(buf, dtype=np.float32).reshape(*shape)


def _logs_launches(fn):
    """Rewrite CXXNET_LAUNCH_LOG (when set) after `fn` returns or
    raises."""
    @functools.wraps(fn)
    def call(*args):
        try:
            return fn(*args)
        finally:
            path = os.environ.get("CXXNET_LAUNCH_LOG")
            if path:
                with open(path, "w") as f:
                    json.dump(kernels.launches(), f)
    return call


def _copy_out(arr: np.ndarray, addr: int) -> int:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    ctypes.memmove(addr, arr.ctypes.data, arr.nbytes)
    return arr.size


# ---------------------------------------------------------------------------
# object lifecycle
# ---------------------------------------------------------------------------

def net_create(dev: str, cfg: str) -> int:
    """A Net on `dev` ("cpu", or gpu / cuda / tpu for the card; "" is
    the default, the card)."""
    return _register(Net(dev=dev or DEFAULT_DEVICE, cfg=cfg))


def io_create(cfg: str) -> int:
    return _register(DataIter(cfg))


def free(hid: int) -> None:
    with _lock:
        _objects.pop(hid, None)


# ---------------------------------------------------------------------------
# trainer surface (one function per CXN* entry point)
# ---------------------------------------------------------------------------

def net_set_param(hid: int, name: str, val: str) -> None:
    _get(hid).set_param(name, val)


def net_init_model(hid: int) -> None:
    _get(hid).init_model()


def net_load_model(hid: int, fname: str) -> None:
    _get(hid).load_model(fname)


def net_save_model(hid: int, fname: str) -> None:
    _get(hid).save_model(fname)


def net_start_round(hid: int, r: int) -> None:
    _get(hid).start_round(r)


@_logs_launches
def net_update_iter(hid: int, iter_hid: int) -> None:
    _get(hid).update(_get(iter_hid))


@_logs_launches
def net_update_batch(hid: int, daddr: int, b: int, c: int, h: int, w: int,
                     laddr: int, lwidth: int) -> None:
    data = _as_f32(daddr, b, c, h, w)
    label = _as_f32(laddr, b, lwidth)
    _get(hid).update(data, label)


@_logs_launches
def net_evaluate(hid: int, iter_hid: int, name: str) -> str:
    return _get(hid).evaluate(_get(iter_hid), name)


@_logs_launches
def net_predict_batch(hid: int, daddr: int, b: int, c: int, h: int, w: int,
                      oaddr: int) -> int:
    """Writes b floats to oaddr; returns count."""
    pred = _get(hid).predict(_as_f32(daddr, b, c, h, w))
    return _copy_out(pred, oaddr)


@_logs_launches
def net_predict_iter(hid: int, iter_hid: int, oaddr: int, cap: int) -> int:
    preds = []
    it = _get(iter_hid)
    net = _get(hid)
    it.before_first()
    while it.next():
        # NetTrainer.predict already drops num_batch_padd rows (the
        # valid-mask truncation in _forward_nodes)
        preds.append(net.predict(it))
    out = np.concatenate(preds) if preds else np.zeros(0, np.float32)
    if out.size > cap:
        raise ValueError(f"output buffer too small: {out.size} > {cap}")
    return _copy_out(out, oaddr)


@_logs_launches
def net_extract_batch(hid: int, daddr: int, b: int, c: int, h: int, w: int,
                      node_name: str, oaddr: int, cap: int) -> int:
    feat = _get(hid).extract(_as_f32(daddr, b, c, h, w), node_name)
    if feat.size > cap:
        raise ValueError(f"output buffer too small: {feat.size} > {cap}")
    return _copy_out(feat, oaddr)


def net_get_weight(hid: int, layer_name: str, tag: str, oaddr: int,
                   cap: int, shape_addr: int) -> int:
    """Writes the 2-D flattened weight; shape_addr receives 2 uint64s.

    Returns element count, or 0 when the layer exists but has no weight
    under `tag` (CXNNetGetWeight returns NULL there); unknown layer
    names are errors."""
    net = _get(hid)
    if not net.has_layer(layer_name):
        raise KeyError(f"unknown layer name {layer_name}")
    try:
        w = net.get_weight(layer_name, tag)
    except KeyError:
        return 0
    if w.size > cap:
        raise ValueError(f"output buffer too small: {w.size} > {cap}")
    shp = (ctypes.c_uint64 * 2).from_address(shape_addr)
    shp[0], shp[1] = w.shape
    return _copy_out(w, oaddr)


def net_set_weight(hid: int, daddr: int, rows: int, cols: int,
                   layer_name: str, tag: str) -> None:
    _get(hid).set_weight(_as_f32(daddr, rows, cols), layer_name, tag)


# ---------------------------------------------------------------------------
# iterator surface
# ---------------------------------------------------------------------------

def io_next(hid: int) -> int:
    return 1 if _get(hid).next() else 0


def io_before_first(hid: int) -> None:
    _get(hid).before_first()


def io_get_data_shape(hid: int, shape_addr: int) -> None:
    d = _get(hid).get_data()
    shp = (ctypes.c_uint64 * 4).from_address(shape_addr)
    shp[0], shp[1], shp[2], shp[3] = d.shape


def io_copy_data(hid: int, oaddr: int) -> int:
    return _copy_out(_get(hid).get_data(), oaddr)


def io_get_label_shape(hid: int, shape_addr: int) -> None:
    lab = _get(hid).get_label()
    shp = (ctypes.c_uint64 * 2).from_address(shape_addr)
    shp[0], shp[1] = lab.shape


def io_copy_label(hid: int, oaddr: int) -> int:
    return _copy_out(_get(hid).get_label(), oaddr)
