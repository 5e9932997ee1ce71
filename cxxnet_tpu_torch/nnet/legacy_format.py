"""Reference-binary checkpoint compatibility, import and export (own copy
of cxxnet_tpu/nnet/legacy_format.py: the files are byte-equal).

Byte-level implementation of the cxxnet model file so models move
between the reference binary and this framework in both directions.
Layouts transcribed from the reference source (not linked code):

    int32   net_type                      (cxxnet_main.cpp SaveModel)
    NetParam struct, 152 B:               (nnet_config.h:28-50)
        int32 num_nodes, int32 num_layers,
        uint32 input_shape[3] (c, y, x),
        int32 init_end, int32 extra_data_num, int32 reserved[31]
    [extra_shape: uint64 count + int32 x count  (if extra_data_num)]
    node_names x num_nodes: uint64 len + bytes  (io.h:70-76)
    per layer:                            (nnet_config.h:126-145)
        int32 type (enum below), int32 primary_layer_index,
        string name, vec<int32> nindex_in, vec<int32> nindex_out
    int64   epoch_counter
    string  model_blob (uint64 len + bytes), concatenating per
    non-shared weighted layer, in declaration order:
        fullc / conv / bias: LayerParam struct (328 B, param.h:15-80)
                             + tensors below
        fullc: wmat SaveBinary 2D (nhidden, nin); bias 1D (nhidden)
        conv:  wmat SaveBinary 3D (g, O/g, I/g*kh*kw) - the same
               memory order as our OIHW; bias 1D (O)
        batch_norm: slope 1D + bias 1D (no LayerParam)
        prelu: slope 1D (no LayerParam)
        (all other layers write nothing)
    SaveBinary = uint32 shape[dim] + packed float32 data
    (mshadow tensor_container.h/io.h format)

Everything is little-endian. The reference does not checkpoint
optimizer state; neither does this format (use the native format with
save_optimizer=1 for that).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

# layer.h:284-317 string <-> enum (names are OUR registry names)
LAYER_TYPE_TO_INT = {
    "shared": 0, "fullc": 1, "softmax": 2, "relu": 3, "sigmoid": 4,
    "tanh": 5, "softplus": 6, "flatten": 7, "dropout": 8, "conv": 10,
    "max_pooling": 11, "sum_pooling": 12, "avg_pooling": 13, "lrn": 15,
    "bias": 17, "concat": 18, "xelu": 19, "caffe": 20,
    "relu_max_pooling": 21, "maxout": 22, "split": 23, "insanity": 24,
    "insanity_max_pooling": 25, "l2_loss": 26, "multi_logistic": 27,
    "ch_concat": 28, "prelu": 29, "batch_norm": 30, "fixconn": 31,
}
_NET_PARAM = struct.Struct("<ii3Iii31i")   # 152 bytes
_LAYER_PARAM_HEAD = struct.Struct("<ififfiiiiiiiiiiiii")  # 18 fields
_LAYER_PARAM_SIZE = _LAYER_PARAM_HEAD.size + 64 * 4       # + reserved


def _w_string(fo: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    fo.write(struct.pack("<Q", len(b)))
    fo.write(b)


def _r_string(fi: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", fi.read(8))
    return fi.read(n).decode("utf-8")


def _w_ivec(fo: BinaryIO, v: List[int]) -> None:
    fo.write(struct.pack("<Q", len(v)))
    if v:
        fo.write(struct.pack(f"<{len(v)}i", *v))


def _r_ivec(fi: BinaryIO) -> List[int]:
    (n,) = struct.unpack("<Q", fi.read(8))
    if n == 0:
        return []
    return list(struct.unpack(f"<{n}i", fi.read(4 * n)))


def _w_tensor(fo: BinaryIO, arr: np.ndarray, shape: Tuple[int, ...]) -> None:
    arr = np.ascontiguousarray(arr, np.float32).reshape(shape)
    fo.write(struct.pack(f"<{len(shape)}I", *shape))
    fo.write(arr.tobytes())


def _r_tensor(fi: BinaryIO, ndim: int) -> np.ndarray:
    shape = struct.unpack(f"<{ndim}I", fi.read(4 * ndim))
    n = int(np.prod(shape))
    return np.frombuffer(fi.read(4 * n), np.float32).reshape(shape).copy()


def _w_layer_param(fo: BinaryIO, lp) -> None:
    fo.write(_LAYER_PARAM_HEAD.pack(
        lp.num_hidden, lp.init_sigma, lp.init_sparse, lp.init_uniform,
        lp.init_bias, lp.num_channel, lp.random_type, lp.num_group,
        lp.kernel_height, lp.kernel_width, lp.stride, lp.pad_y, lp.pad_x,
        lp.no_bias, 64 << 18, lp.silent, lp.num_input_channel,
        lp.num_input_node))
    fo.write(b"\0" * (64 * 4))


def _skip_layer_param(fi: BinaryIO) -> None:
    fi.read(_LAYER_PARAM_SIZE)


# ---------------------------------------------------------------------------
# per-layer blob writers/readers (reference SaveModel/LoadModel pairs)
# ---------------------------------------------------------------------------

def _blob_write(fo: BinaryIO, info, layer, p: Dict[str, np.ndarray]) -> None:
    t = info.type_name
    lp = layer.param
    if t == "fullc":
        _w_layer_param(fo, lp)
        w = np.asarray(p["wmat"], np.float32)
        _w_tensor(fo, w, w.shape)
        bias = np.asarray(p.get("bias",
                                np.zeros(w.shape[0], np.float32)))
        _w_tensor(fo, bias, bias.shape)
    elif t == "conv":
        _w_layer_param(fo, lp)
        w = np.asarray(p["wmat"], np.float32)  # OIHW
        o, ipg, kh, kw = w.shape
        g = lp.num_group
        _w_tensor(fo, w, (g, o // g, ipg * kh * kw))
        bias = np.asarray(p.get("bias", np.zeros(o, np.float32)))
        _w_tensor(fo, bias, bias.shape)
    elif t == "bias":
        _w_layer_param(fo, lp)
        b = np.asarray(p["bias"], np.float32)
        _w_tensor(fo, b, b.shape)
    elif t == "batch_norm":
        _w_tensor(fo, np.asarray(p["slope"]), p["slope"].shape)
        _w_tensor(fo, np.asarray(p["bias"]), p["bias"].shape)
    elif t == "prelu":
        _w_tensor(fo, np.asarray(p["slope"]), p["slope"].shape)
    elif p:
        # a param-bearing type with no reference encoding (e.g. the
        # torch plugin under the caffe code) must not round-trip to
        # random re-init silently
        raise ValueError(
            f"layer type {t} has trainable params but no reference "
            "blob encoding (save with the native format instead)")


def _blob_read(fi: BinaryIO, info,
               p: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Read one layer's weights (tensor headers carry the shapes);
    `p`, when non-empty, provides expected shapes to validate."""
    t = info.type_name
    out = {}
    if t == "fullc":
        _skip_layer_param(fi)
        out["wmat"] = _r_tensor(fi, 2)
        bias = _r_tensor(fi, 1)
        if not p or "bias" in p:
            out["bias"] = bias
    elif t == "conv":
        _skip_layer_param(fi)
        w3 = _r_tensor(fi, 3)  # (g, O/g, I/g*kh*kw)
        if p:
            o, ipg, kh, kw = p["wmat"].shape
            g = w3.shape[0]
            want = (g, o // g, ipg * kh * kw)
            if w3.shape != want:
                raise ValueError(
                    f"legacy model: {info.name or t}.wmat 3D shape "
                    f"{w3.shape} != expected {want}")
            out["wmat"] = w3.reshape(p["wmat"].shape)
        else:
            out["wmat"] = w3
        bias = _r_tensor(fi, 1)
        if not p or "bias" in p:
            out["bias"] = bias
    elif t == "bias":
        _skip_layer_param(fi)
        out["bias"] = _r_tensor(fi, 1)
    elif t == "batch_norm":
        out["slope"] = _r_tensor(fi, 1)
        out["bias"] = _r_tensor(fi, 1)
    elif t == "prelu":
        out["slope"] = _r_tensor(fi, 1)
    for k, v in out.items():
        if p and k in p and tuple(p[k].shape) != tuple(v.shape):
            raise ValueError(
                f"legacy model: {info.name or t}.{k} shape "
                f"{v.shape} != expected {tuple(p[k].shape)}")
    return out or p


# ---------------------------------------------------------------------------
# whole-file save/load
# ---------------------------------------------------------------------------

def save_legacy_model(fo: BinaryIO, net_cfg, net, params: dict,
                      epoch: int, net_type: int = 0) -> None:
    import io as _io
    fo.write(struct.pack("<i", net_type))
    fo.write(_NET_PARAM.pack(
        net_cfg.num_nodes, net_cfg.num_layers, *net_cfg.input_shape,
        1, net_cfg.extra_data_num, *([0] * 31)))
    if net_cfg.extra_data_num != 0:
        _w_ivec(fo, list(net_cfg.extra_shape))
    for name in net_cfg.node_names:
        _w_string(fo, name)
    for info in net_cfg.layers:
        if info.is_shared:
            tcode = 0
        elif info.type_name in LAYER_TYPE_TO_INT:
            tcode = LAYER_TYPE_TO_INT[info.type_name]
        else:
            raise ValueError(
                f"layer type {info.type_name} has no reference encoding "
                "(save with the native format instead)")
        fo.write(struct.pack("<ii", tcode, info.primary_layer_index))
        _w_string(fo, info.name)
        _w_ivec(fo, list(info.nindex_in))
        _w_ivec(fo, list(info.nindex_out))
    fo.write(struct.pack("<q", int(epoch)))
    blob = _io.BytesIO()
    from cxxnet_tpu_torch.nnet.network import param_key
    for idx, info in enumerate(net_cfg.layers):
        if info.is_shared:
            continue
        lk = param_key(net_cfg, idx)
        _blob_write(blob, info, net.layer_objs[idx], params.get(lk, {}))
    b = blob.getvalue()
    fo.write(struct.pack("<Q", len(b)))
    fo.write(b)


def read_legacy_model(fi: BinaryIO) -> dict:
    """Parse a legacy file WITHOUT a configured net (finetune path):
    returns {net_type, epoch, params: {layer_name_or_index: {pn: arr}}}.
    Conv weights come back in the file's 3D (g, O/g, I/g*kh*kw) layout
    (same memory order as OIHW; callers reshape by element count)."""
    import io as _io
    from types import SimpleNamespace
    (net_type,) = struct.unpack("<i", fi.read(4))
    head = _NET_PARAM.unpack(fi.read(_NET_PARAM.size))
    num_nodes, num_layers = head[0], head[1]
    if head[6] != 0:
        _r_ivec(fi)
    for _ in range(num_nodes):
        _r_string(fi)
    recs = []
    for _ in range(num_layers):
        tcode, primary = struct.unpack("<ii", fi.read(8))
        name = _r_string(fi)
        _r_ivec(fi)
        _r_ivec(fi)
        recs.append((tcode, primary, name))
    (epoch,) = struct.unpack("<q", fi.read(8))
    (blob_len,) = struct.unpack("<Q", fi.read(8))
    blob = _io.BytesIO(fi.read(blob_len))
    int_to_type = {v: k for k, v in LAYER_TYPE_TO_INT.items()}
    params = {}
    for i, (tcode, primary, name) in enumerate(recs):
        if tcode == 0 and primary >= 0:
            continue  # shared layer: no own weights in the blob
        info = SimpleNamespace(type_name=int_to_type.get(tcode, ""),
                               name=name)
        p = _blob_read(blob, info, {})
        if p:
            params[name or f"layer_{i}"] = p
    return {"net_type": net_type, "epoch": int(epoch), "params": params}


def load_legacy_model(fi: BinaryIO, net_cfg, net, params: dict) -> dict:
    """Validate structure against the configured net (the reference's
    LoadNet consistency check) and return the params tree from the file.
    `params` supplies expected shapes (e.g. from init_params)."""
    import io as _io
    (net_type,) = struct.unpack("<i", fi.read(4))
    head = _NET_PARAM.unpack(fi.read(_NET_PARAM.size))
    num_nodes, num_layers = head[0], head[1]
    input_shape = head[2:5]
    extra_data_num = head[6]
    if num_nodes != net_cfg.num_nodes or num_layers != net_cfg.num_layers:
        raise ValueError(
            f"legacy model: {num_nodes} nodes/{num_layers} layers != "
            f"configured {net_cfg.num_nodes}/{net_cfg.num_layers}")
    if tuple(input_shape) != tuple(net_cfg.input_shape):
        raise ValueError("legacy model: input_shape mismatch")
    if extra_data_num != 0:
        _r_ivec(fi)
    for i in range(num_nodes):
        _r_string(fi)
    for i in range(num_layers):
        tcode, primary = struct.unpack("<ii", fi.read(8))
        name = _r_string(fi)
        nin = _r_ivec(fi)
        nout = _r_ivec(fi)
        info = net_cfg.layers[i]
        want = (0 if info.is_shared
                else LAYER_TYPE_TO_INT.get(info.type_name, -1))
        if (tcode != want or nin != list(info.nindex_in)
                or nout != list(info.nindex_out)):
            raise ValueError(
                f"legacy model: layer {i} structure mismatch "
                f"(file type {tcode} {name!r}, config "
                f"{info.type_name} {info.name!r})")
    (epoch,) = struct.unpack("<q", fi.read(8))
    (blob_len,) = struct.unpack("<Q", fi.read(8))
    blob = _io.BytesIO(fi.read(blob_len))
    from cxxnet_tpu_torch.nnet.network import param_key
    out = {}
    for idx, info in enumerate(net_cfg.layers):
        if info.is_shared:
            continue
        lk = param_key(net_cfg, idx)
        if lk in params:
            out[lk] = _blob_read(blob, info, params[lk])
        else:
            _blob_read(blob, info, {})
    return {"net_type": net_type, "epoch": int(epoch), "params": out}
