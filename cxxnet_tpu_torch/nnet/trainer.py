"""NetTrainer, inference half (counterpart of cxxnet_tpu/nnet/trainer.py).

The product surface of the JAX trainer that serving needs: set_param /
init_model / load_model / save_model / predict / predict_dist /
stage_infer_rows + infer_rows / get_weight / set_weight. Training
(update, evaluate, the updaters) is the next slice.

Execution model: params live on the trainer's device as a float32
master copy, {param_key: {"wmat", "bias"}} exactly like the JAX
trainer's `state["params"]`. Under `dtype = bfloat16` a second copy is
cast wholesale to bfloat16 once per weight change, the input is cast the
same way, the forward runs in bfloat16 and the requested node is read
out in float32 - the casting points of the JAX trainer's `_cast` and
`eval_step`. Every forward runs under `torch.inference_mode()`.

The device is fixed at construction: `cuda:0` unless the caller asks
for the CPU (`device="cpu"`, or `dev = cpu` in the constructor's conf
string); with no card a CUDA device raises (utils/device.py). A `dev`
key reaching set_param later is validated but does not move the
trainer - the CLI maps `dev` to the constructor's device.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers.base import not_ported
from cxxnet_tpu_torch.nnet import checkpoint
from cxxnet_tpu_torch.nnet.net_config import NetConfig
from cxxnet_tpu_torch.nnet.network import Network, param_key
from cxxnet_tpu_torch.utils.config import parse_config_string
from cxxnet_tpu_torch.utils.device import (
    DEFAULT_DEVICE, device_from_spec, resolve_device)

Params = Dict[str, Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Config keys of the JAX trainer that change results (or the serving
# contract) and that this slice does not implement: any value but the
# listed inert ones raises NotImplementedError naming the key.
_NOT_PORTED: Dict[str, Tuple[str, ...]] = {
    "mesh": (),
    "graph_passes": ("",),
    "zero_stage": ("0",),
    "shard_optimizer": ("0",),
    "update_on_server": ("0",),
    "steps_per_dispatch": ("1",),
    "device_augment": ("0",),
    "model_format": ("native",),
    "tuning_cache": ("",),
    "param_server": ("local",),
    "extra_data_num": ("0",),
    "serve_bucket_ladder": (),
    "serve_port": ("0",),
    "serve_queue_limit": ("0",),
    "serve_deadline_ms": ("0",),
    "swap_watch": ("",),
    "swap_canary_frac": ("0",),
    "serve_conn_timeout_ms": ("0",),
    "serve_max_conns": ("0",),
    "serve_max_body_bytes": ("0",),
}


def is_inert(val: str, inert: Tuple[str, ...]) -> bool:
    for want in inert:
        if val == want:
            return True
        try:
            if float(val) == float(want):
                return True
        except ValueError:
            pass
    return False


def check_ported(name: str, val: str) -> None:
    """Raise NotImplementedError for a result-changing key the port does
    not implement yet (shared by the trainer and the CLI)."""
    if name in _NOT_PORTED and not is_inert(val, _NOT_PORTED[name]):
        raise not_ported(name, val, f"the `{name}` option")
    if (name.startswith("pass_")
            and not name.startswith("pass_calibration_")
            and not is_inert(val, ("0",))):
        raise not_ported(name, val, "the graph-pass toggle")


class NetTrainer:
    """Config-driven network, inference half."""

    def __init__(self, dev: str = "", cfg: str = "",
                 device: Optional[str] = None):
        pairs = parse_config_string(cfg) if cfg else []
        spec = dev
        for k, v in pairs:
            if k == "dev" and not dev:
                spec = v
        if device is None:
            device = device_from_spec(spec) if spec else DEFAULT_DEVICE
        self.device = resolve_device(device)
        self.cfg_pairs: List[Tuple[str, str]] = []
        self.net_cfg = NetConfig()
        self.net: Optional[Network] = None
        self.batch_size = 0
        self.seed = 0
        self.silent = 0
        self.epoch = 0
        self.compute_dtype = torch.float32
        # {"params": float32 master params on self.device}; None until
        # init_model / load_model
        self.state: Optional[Dict[str, Params]] = None
        self._cparams: Optional[Params] = None
        # continuous-batching serving knobs (serve/server.py): largest
        # bucket (0 = batch_size), fill-or-timeout wait, replica count
        self.serve_max_batch = 0
        self.serve_max_wait_ms = 2.0
        self.serve_replicas = 1
        if dev:
            self.set_param("dev", dev)
        for k, v in pairs:
            self.set_param(k, v)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        check_ported(name, val)
        if name == "dev":
            device_from_spec(val)  # validates; multi-device raises
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "seed":
            self.seed = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "dtype":
            if val not in _DTYPES:
                raise ValueError(f"dtype must be float32 or bfloat16, "
                                 f"got {val!r}")
            self.compute_dtype = _DTYPES[val]
        if name == "serve_max_batch":
            if int(val) < 0:
                raise ValueError("serve_max_batch must be >= 0")
            self.serve_max_batch = int(val)
        if name == "serve_max_wait_ms":
            if float(val) < 0:
                raise ValueError("serve_max_wait_ms must be >= 0")
            self.serve_max_wait_ms = float(val)
        if name == "serve_replicas":
            if int(val) < 1:
                raise ValueError("serve_replicas must be >= 1")
            self.serve_replicas = int(val)
        self.cfg_pairs.append((name, val))

    # ------------------------------------------------------------------
    # model lifecycle
    # ------------------------------------------------------------------
    def init_model(self) -> None:
        """Build the net from the config and draw its params from
        `seed` (float32 on the CPU, then moved to the device)."""
        self.net_cfg.configure(self.cfg_pairs)
        self._build_net()
        self._set_params({k: {n: t.to(self.device) for n, t in d.items()}
                          for k, d in self.net.init_params(self.seed).items()})
        self.epoch = 0

    def _build_net(self) -> None:
        if self.batch_size <= 0:
            raise ValueError("batch_size must be set")
        if self.device.type == "cuda" and self.compute_dtype == torch.float32:
            # the reference runs float32 convolutions at full precision
            # (cxxnet_tpu/ops/conv.py: Precision.HIGHEST); cuDNN would
            # default to TF32. The flag is process-wide (torch has no
            # per-call switch), so a float32 trainer on the card sets it.
            torch.backends.cudnn.allow_tf32 = False
        self.net = Network(self.net_cfg, self.batch_size)
        if not self.silent:
            for i, s in enumerate(self.net.node_shapes):
                sys.stdout.write(f"node[{self.net_cfg.node_names[i]}].shape: "
                                 f"{s[0]},{s[1]},{s[2]},{s[3]}\n")

    def _set_params(self, params: Params) -> None:
        self.state = {"params": params}
        self._cparams = None

    def compute_params(self) -> Params:
        """Params in the compute dtype: the master copy itself under
        float32, a wholesale bfloat16 cast (made once per weight
        change) under bfloat16."""
        cp = self._cparams
        if cp is None:
            master = self.state["params"]
            if self.compute_dtype == torch.float32:
                cp = master
            else:
                cp = {k: {n: t.to(self.compute_dtype) for n, t in d.items()}
                      for k, d in master.items()}
            self._cparams = cp
        return cp

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def infer_fn(self, node: int):
        """fn(params, staged_rows) -> float32 rows of `node` (a device
        tensor; the caller decides when to read it back). `params` are
        compute-dtype params (compute_params()); any row count works."""
        net = self.net

        def fn(params: Params, data: torch.Tensor) -> torch.Tensor:
            return net(params, data)[node].float()
        return fn

    def stage_infer_rows(self, data: np.ndarray) -> torch.Tensor:
        """Host rows (n, c, y, x) -> a device tensor in the compute
        dtype (float32 copy to the device, then the cast on the
        device: round-to-nearest-even like the JAX package's host
        cast)."""
        t = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
        return t.to(self.device).to(self.compute_dtype)

    def infer_rows(self, gdata: torch.Tensor, node: int = -1) -> torch.Tensor:
        """Run the inference forward on staged rows; node=-1 is the
        final node."""
        if node < 0:
            node = self.net_cfg.num_nodes - 1
        with torch.inference_mode():
            return self.infer_fn(node)(self.compute_params(), gdata)

    def _infer_node(self, batch: DataBatch, node: int) -> np.ndarray:
        """One node's float32 rows for a batch, padding rows
        (num_batch_padd) trimmed."""
        if batch.batch_size > self.batch_size:
            raise ValueError("batch larger than configured batch_size")
        valid = batch.batch_size - batch.num_batch_padd
        out = self.infer_rows(self.stage_infer_rows(batch.data), node)
        return out[:valid].cpu().numpy()

    def predict(self, batch: DataBatch) -> np.ndarray:
        """Prediction = argmax of the final node (or the raw scalar of a
        one-column output); nnet_impl-inl.hpp:186-199 TransformPred."""
        out = self._infer_node(batch, self.net_cfg.num_nodes - 1)
        flat = out.reshape(out.shape[0], -1)
        if flat.shape[1] == 1:
            return flat[:, 0]
        return np.argmax(flat, axis=1).astype(np.float32)

    def predict_dist(self, batch: DataBatch) -> np.ndarray:
        """Full output distribution of the final node."""
        out = self._infer_node(batch, self.net_cfg.num_nodes - 1)
        return out.reshape(out.shape[0], -1)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save_model(self, fo) -> None:
        """The JAX package's checkpoint format (no optimizer state: this
        slice has none)."""
        params = convert.params_to_numpy(self.state["params"],
                                         self.net.param_shapes())
        checkpoint.save_model(fo, 0, self.net_cfg.to_dict(), self.epoch,
                              params, None)

    def load_model(self, fi) -> None:
        """Load a checkpoint in the JAX package's native format: the file
        supplies structure and weights, the config the layer settings.
        Optimizer state, if the file carries any, is not needed to
        serve and is dropped."""
        head = fi.read(len(checkpoint.MAGIC))
        fi.seek(-len(head), 1)
        if head != checkpoint.MAGIC:
            raise NotImplementedError(
                "model_format = cxxnet (reference-binary checkpoints) is "
                "not ported to cxxnet_tpu_torch yet; load a native "
                "checkpoint")
        blob = checkpoint.load_model(fi)
        self.net_cfg = NetConfig.from_dict(blob["net"])
        self.net_cfg.configure(self.cfg_pairs)
        self._build_net()
        self._set_params(convert.params_from_numpy(
            blob["params"], self.net.param_shapes(), self.device))
        self.epoch = blob["epoch"]

    # ------------------------------------------------------------------
    # weight access (visitor semantics)
    # ------------------------------------------------------------------
    def get_weight(self, layer_name: str,
                   tag: str) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """(2-D flattened weight, original shape); GetWeightVisitor
        flattening = (shape[0], prod(rest)) (visitor.h:26-100)."""
        lk, pn = self._weight_key(layer_name, tag)
        arr = self.state["params"][lk][pn].cpu().numpy()
        return arr.reshape(arr.shape[0], -1), arr.shape

    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str) -> None:
        lk, pn = self._weight_key(layer_name, tag)
        params = self.state["params"]
        cur = params[lk][pn]
        arr = np.asarray(weight, dtype=np.float32).reshape(tuple(cur.shape))
        params[lk][pn] = torch.from_numpy(arr.copy()).to(self.device)
        self._cparams = None

    def _weight_key(self, layer_name: str, tag: str) -> Tuple[str, str]:
        idx = self.net_cfg.get_layer_index(layer_name)
        for pname, t in self.net.layer_objs[idx].param_tags().items():
            if t == tag or pname == tag:
                return param_key(self.net_cfg, idx), pname
        raise KeyError(f"layer {layer_name} has no weight tagged {tag}")
