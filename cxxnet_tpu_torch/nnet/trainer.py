"""NetTrainer (counterpart of cxxnet_tpu/nnet/trainer.py).

The product surface of the JAX trainer: set_param / init_model /
load_model / save_model / copy_model_from / update / update_all /
evaluate / eval_train_metric / predict / predict_dist /
stage_infer_rows + infer_rows / get_weight / set_weight.

Execution model: params live on the trainer's device as a float32
master copy, {param_key: {"wmat", "bias"}} exactly like the JAX
trainer's `state["params"]`, and the updater state beside them as
`state["ustate"]` = {param_key: {name: {"m"} | {"m1", "m2"}}}.

- Inference: under `dtype = bfloat16` a second copy of the params is
  cast wholesale to bfloat16 once per weight change, the input is cast
  the same way, the forward runs in bfloat16 and the requested node is
  read out in float32 - the casting points of the JAX trainer's `_cast`
  and `eval_step` - under `torch.inference_mode()`.
- Training (`update`): the master params are cast to the compute dtype
  INSIDE autograd, so the gradients land in float32 on the master (as
  `_cast` inside the JAX `loss_fn`); the loss is scaled by
  1/(batch_size*update_period), gradients accumulate over
  `update_period` steps, and then one updater per weight tensor (built
  under its `wmat`/`bias` tag) updates the master and its state in
  place. Dropout draws from a torch.Generator seeded from (seed + 100,
  step, layer index) - the JAX trainer folds (PRNGKey(seed + 100),
  step) and the layer index; the two streams never agree, so tests
  inject masks through `update(..., keep=...)`. Train metrics
  accumulate on the device and are read back once per round
  (`eval_train_metric`). Under `check_nan = 1` a step whose loss or
  updated params (or gradient accumulator) are not finite leaves
  params, updater state, accumulator, counters and train metrics as
  they were, and `max_bad_rounds` such steps in a row raise
  DivergenceError.

- Graph passes (nnet/passes.py, `graph_passes = a,b,...` plus
  `pass_<name> = 0|1` toggles): graph-stage passes stamp the live net
  at build (the autocast dtype plan; under a plan the trainer casts
  nothing wholesale - the plan casts per layer); infer-stage passes
  build, per requested output node and calibration epoch, a
  transformed inference graph (`infer_graph`). Its params are made from
  the float32 master by the pass's param function and then cast as the
  JAX package's `_cast` would, once per weight change (the JAX package
  redoes this inside every inference call; the values are the same).
  fold_conv_bn and quantize_int8 need calibration statistics: the
  first inference batch supplies them (`calibrate_graph_passes` or
  `pass_calibration_batches` set them explicitly); a weight change
  through set_weight or a load retires them, and the next inference
  recalibrates.
- A short inference batch is zero-padded up to `batch_size` before the
  forward and trimmed after it, as in the JAX package: batch_norm
  normalizes with minibatch statistics, so its rows depend on the
  padding.
- Staging (`stage_batch`, the JAX package's): pad to batch_size, cast
  on the host or not (`stage_dtype`; under `device_augment = 1` raw
  uint8 batches cross as uint8), copy to the device and cast there to
  the compute dtype. `update()` takes a DataBatch (streamed: one
  stage_batch call) or a StagedBatch; `prefetch()` stages a batch ahead
  on a worker thread (io/prefetch.py: pinned buffers and a side stream
  on the card).
- `device_augment = 1`: crop / mean / contrast / illumination / mirror /
  scale run on the device at the head of every forward
  (ops/augment.py), from the augment keys of the conf, with draws from
  stream (seed + 100, step, AUGMENT_STREAM) in training and the
  deterministic variant in evaluation and inference.

The device is fixed at construction: `cuda:0` unless the caller asks
for the CPU (`device="cpu"`, or `dev = cpu` in the constructor's conf
string); with no card a CUDA device raises (utils/device.py). A `dev`
key reaching set_param later is validated but does not move the
trainer - the CLI maps `dev` to the constructor's device.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import threading
import time
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cxxnet_tpu_torch import convert, telemetry
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers.base import active_step
from cxxnet_tpu_torch.nnet import checkpoint
from cxxnet_tpu_torch.nnet.net_config import NetConfig
from cxxnet_tpu_torch.nnet.network import Network, param_key
from cxxnet_tpu_torch.nnet.passes import (
    GraphModule, PassContext, PassPipeline, find_fold_sites,
    find_quant_sites, make_param_fn)
from cxxnet_tpu_torch.ops.augment import AUGMENT_STREAM, make_device_augment
from cxxnet_tpu_torch.ops.int8 import per_channel_scale
from cxxnet_tpu_torch.telemetry.flight import fingerprint
from cxxnet_tpu_torch.updater import UpdaterParam, create_updater
from cxxnet_tpu_torch.utils.config import check_ported, parse_config_string
from cxxnet_tpu_torch.utils.device import (
    DEFAULT_DEVICE, device_from_spec, resolve_device)
from cxxnet_tpu_torch.utils.fault import DivergenceError
from cxxnet_tpu_torch.utils.metric import MetricSet, format_metrics

Params = Dict[str, Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Config keys of the JAX trainer that change results (or the serving
# contract) and that the port does not implement yet: any value but the
# listed inert ones raises NotImplementedError naming the key.
_NOT_PORTED: Dict[str, Tuple[str, ...]] = {
    "mesh": (),
    "zero_stage": ("0",),
    "shard_optimizer": ("0",),
    "update_on_server": ("0",),
    "steps_per_dispatch": ("1",),
    "model_format": ("native",),
    "tuning_cache": ("",),
    "param_server": ("local",),
    "extra_data_num": ("0",),
    "remat": ("0",),
    "profile": ("0",),
    "profile_dir": ("",),
    "compile_cache": ("",),
    "trace_round": ("1",),
}


class StagedBatch(NamedTuple):
    """A training batch staged on the trainer's device (stage_batch):
    data (compute dtype; raw uint8 or float32 under device_augment), the
    label fields and the row mask. `ready` is the event after its copies
    when they were issued on a prefetcher's side stream (None when
    staged on the consumer's stream); update() waits on it."""
    data: torch.Tensor
    labels: Dict[str, torch.Tensor]
    mask: torch.Tensor
    ready: Any = None


def stream_seed(*parts: int) -> int:
    """A 63-bit generator seed from integers (seed, step, index ...):
    the port's stand-in for jax.random.fold_in chains (FNV-1a over the
    parts)."""
    h = 0xCBF29CE484222325
    for p in parts:
        h = ((h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return h & ((1 << 63) - 1)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [t for k in sorted(tree) for t in _tree_leaves(tree[k])]
    return [tree]


def _masked_absmax(x: torch.Tensor, mask: torch.Tensor) -> float:
    """Valid-row absmax of a tapped activation, in float32: the
    quantize_int8 activation range. Padding rows carry bias/activation
    values at depth, so the mask keeps them out of the frozen range."""
    xf = x.float()
    m = mask.float().reshape((-1,) + (1,) * (xf.dim() - 1)).expand(
        xf.shape)
    return float(torch.max(torch.abs(xf) * m))


class InferGraph:
    """The inference forward of one output node: a network (the
    trainer's own, or a pass-transformed clone) and where its params
    come from. Calling it on staged rows returns the node's float32
    rows (a device tensor). The transformed params are made once per
    weight change of the trainer and cached here, so a Server built on
    one calibration epoch keeps serving that epoch's graph."""

    def __init__(self, trainer: "NetTrainer", net: Network, node: int,
                 param_fn=None, gm: Optional[GraphModule] = None):
        self.trainer = trainer
        self.net = net
        self.node = node
        self.param_fn = param_fn
        self.gm = gm
        self._lock = threading.Lock()
        self._version = -1
        self._params: Optional[Params] = None

    def params(self) -> Params:
        tr = self.trainer
        if self.param_fn is None:
            return tr.compute_params()
        with self._lock:
            if self._version != tr._wversion:
                with torch.no_grad():
                    self._params = tr._cast(
                        self.param_fn(tr.state["params"]))
                self._version = tr._wversion
            return self._params

    def bind(self, master: Params) -> Params:
        """Compute params of this graph made from an explicit float32
        master dict (the Server's weight slots: a swapped-in checkpoint
        gets its own copy, never the trainer's cache)."""
        tr = self.trainer
        with torch.no_grad():
            if self.param_fn is None:
                return tr._cast(master)
            return tr._cast(self.param_fn(master))

    def run(self, cparams: Params, data: torch.Tensor) -> torch.Tensor:
        """The forward on staged rows with explicit compute params."""
        return self.net(cparams, self.trainer._model_input(data))[0][
            self.node].float()

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        return self.run(self.params(), data)


class NetTrainer:
    """Config-driven trainer for one network."""

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
        self.update_period = 1
        self.eval_train = 1
        self.seed = 0
        self.silent = 0
        self.epoch = 0       # update counter (reference epoch_counter)
        self.compute_dtype = torch.float32
        # the dtype batches cross to the card in ("" = follow the
        # compute dtype; float32 under bfloat16 = cast on the card)
        self.stage_dtype = ""
        # device-side augmentation (ops/augment.py): the flag, the
        # augment keys of the conf, and the function built at _build_net
        self.device_augment = 0
        self._daug_cfg: Dict[str, str] = {}
        self._augment_fn = None
        self.metric = MetricSet()
        self.train_metric = MetricSet()
        # (node name or "" for the final node, node id) per metric
        self.eval_nodes: List[Tuple[str, int]] = []
        self.save_optimizer = 0
        self.check_nan = 0
        self.max_bad_rounds = 3
        self.bad_rounds = 0   # total dropped steps (this process)
        self._bad_consec = 0
        self._step_counter = 0
        # {"params": float32 master params, "ustate": updater state} on
        # self.device; None until init_model / load_model
        self.state: Optional[Dict[str, Any]] = None
        self.updaters: Dict[str, Dict[str, Any]] = {}
        self._accum: Optional[Params] = None   # update_period > 1
        self._count = 0       # steps accumulated toward the next update
        self._tmetric: Optional[torch.Tensor] = None  # (n, 2) float64
        self._loaded_opt = None
        self._cparams: Optional[Params] = None
        # bumped on every weight change: InferGraph's params cache key
        self._wversion = 0
        # graph passes (nnet/passes.py): the spec, per-pass toggles,
        # the pipeline built at _build_net, the autocast plan, and the
        # calibration state - fold (mean, rstd) per bn key and quant
        # activation absmax per conv/fullc key, the epoch they belong
        # to, and the transformed inference graphs per (node, epoch)
        self.graph_passes = ""
        self._pass_toggles: Dict[str, int] = {}
        self.pass_calibration_batches = 1
        self._pipeline: Optional[PassPipeline] = None
        self._graph_dtype_plan: Optional[Dict[int, torch.dtype]] = None
        self._fold_sites: List[Tuple[int, int]] = []
        self._quant_sites: List[int] = []
        self._fold_stats: Optional[Dict[str, Any]] = None
        self._quant_stats: Optional[Dict[str, float]] = None
        self._fold_epoch = 0
        self._infer_graph_cache: Dict[Tuple[int, int], InferGraph] = {}
        # continuous-batching serving knobs (serve/server.py): largest
        # bucket (0 = batch_size), fill-or-timeout wait, replica count
        self.serve_max_batch = 0
        self.serve_max_wait_ms = 2.0
        self.serve_replicas = 1
        # the serving front (docs/SERVING.md): serve_port arms /predict
        # on the attached listener (0 = off); serve_queue_limit is the
        # admission bound in rows (0 = unlimited); serve_deadline_ms the
        # default request deadline (0 = none); serve_shed_clear_ms the
        # shed->healthy /healthz hysteresis
        self.serve_port = 0
        self.serve_queue_limit = 0
        self.serve_deadline_ms = 0.0
        self.serve_shed_clear_ms = 1000.0
        # hot-swap: a live Server polls swap_watch every swap_poll_ms
        # ("" = off); with swap_canary_frac in (0, 1] a new checkpoint
        # is judged as a canary for swap_canary_window seconds
        self.swap_watch = ""
        self.swap_poll_ms = 200.0
        self.swap_canary_frac = 0.0
        self.swap_canary_window = 10.0
        # the listener's ingress limits (all 0 = off)
        self.serve_conn_timeout_ms = 0.0
        self.serve_max_conns = 0
        self.serve_max_body_bytes = 0
        # explicit serving bucket ladder (None = power-of-two default)
        self.serve_ladder: Optional[List[int]] = None
        # telemetry_steps = 0 opts out of the per-step instruments (a
        # loss readback per step) while keeping event logging; the
        # instruments run only while a telemetry consumer is armed,
        # decided at _build_net
        self.telemetry_steps = 1
        self._tel_steps = False
        # dispatch-site fingerprints (telemetry/flight.py), one per
        # program shape
        self._flight_fps: Dict[Any, str] = {}
        if dev:
            self.set_param("dev", dev)
        for k, v in pairs:
            self.set_param(k, v)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        check_ported(_NOT_PORTED, name, val)
        if name == "dev":
            device_from_spec(val)  # validates; multi-device raises
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "update_period":
            if int(val) < 1:
                raise ValueError("update_period must be >= 1")
            self.update_period = int(val)
        if name == "eval_train":
            self.eval_train = int(val)
        if name == "seed":
            self.seed = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "save_optimizer":
            self.save_optimizer = int(val)
        if name == "check_nan":
            self.check_nan = int(val)
        if name == "max_bad_rounds":
            self.max_bad_rounds = int(val)
        if name == "stage_dtype":
            if val not in ("", "float32", "bfloat16"):
                raise ValueError("stage_dtype must be float32 or bfloat16")
            self.stage_dtype = val
        if name == "eval_inflight" and int(val) < 0:
            # the JAX trainer's window of evaluation batches in flight;
            # the port reads each batch's metric rows in turn, which
            # gives the same numbers for any window
            raise ValueError("eval_inflight must be >= 0")
        if name == "device_augment":
            self.device_augment = int(val)
        if name in ("image_mean", "mean_value", "scale", "divideby",
                    "rand_crop", "rand_mirror", "mirror",
                    "crop_y_start", "crop_x_start",
                    "max_random_contrast", "max_random_illumination"):
            # crop/mirror/mean/scale spec for device_augment = 1 (the
            # key names the host AugmentIterator consumes; unread unless
            # device_augment is set). divideby is the reciprocal-scale
            # alias, like augment.py's handler.
            if name == "divideby":
                name, val = "scale", str(1.0 / float(val))
            self._daug_cfg[name] = val
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
        if name == "serve_port":
            if int(val) < 0 or int(val) > 65535:
                raise ValueError("serve_port must be in [0, 65535]")
            self.serve_port = int(val)
        if name == "serve_queue_limit":
            if int(val) < 0:
                raise ValueError("serve_queue_limit must be >= 0")
            self.serve_queue_limit = int(val)
        if name == "serve_deadline_ms":
            if float(val) < 0:
                raise ValueError("serve_deadline_ms must be >= 0")
            self.serve_deadline_ms = float(val)
        if name == "serve_shed_clear_ms":
            if float(val) < 0:
                raise ValueError("serve_shed_clear_ms must be >= 0")
            self.serve_shed_clear_ms = float(val)
        if name == "swap_watch":
            self.swap_watch = val
        if name == "swap_poll_ms":
            if float(val) <= 0:
                raise ValueError("swap_poll_ms must be > 0")
            self.swap_poll_ms = float(val)
        if name == "swap_canary_frac":
            if not 0.0 <= float(val) <= 1.0:
                raise ValueError("swap_canary_frac must be in [0, 1]")
            self.swap_canary_frac = float(val)
        if name == "swap_canary_window":
            if float(val) <= 0:
                raise ValueError("swap_canary_window must be > 0")
            self.swap_canary_window = float(val)
        if name == "serve_conn_timeout_ms":
            if float(val) < 0:
                raise ValueError("serve_conn_timeout_ms must be >= 0")
            self.serve_conn_timeout_ms = float(val)
        if name == "serve_max_conns":
            if int(val) < 0:
                raise ValueError("serve_max_conns must be >= 0")
            self.serve_max_conns = int(val)
        if name == "serve_max_body_bytes":
            if int(val) < 0:
                raise ValueError("serve_max_body_bytes must be >= 0")
            self.serve_max_body_bytes = int(val)
        if name == "serve_bucket_ladder":
            rungs = [int(t) for t in val.split(",") if t.strip()]
            if (not rungs or any(r < 1 for r in rungs)
                    or sorted(set(rungs)) != rungs):
                raise ValueError(
                    "serve_bucket_ladder must be a strictly "
                    f"increasing comma list of positive ints, got "
                    f"{val!r}")
            self.serve_ladder = rungs
        if name == "telemetry_steps":
            self.telemetry_steps = int(val)
        if name == "graph_passes":
            self.graph_passes = val
        if name == "pass_calibration_batches":
            if int(val) < 1:
                raise ValueError("pass_calibration_batches must be >= 1")
            self.pass_calibration_batches = int(val)
        if (name.startswith("pass_")
                and name not in ("pass_calibration_batches",
                                 "pass_calibration_iter")):
            # per-pass toggles over graph_passes; the pass name is
            # checked against the registry at _build_net
            self._pass_toggles[name[len("pass_"):]] = int(val)
        if name.startswith("metric"):
            m = re.match(r"^metric\[([^,\]]+),([^\]]+)\]$", name)
            if m:
                self.metric.add_metric(val, m.group(1))
                self.train_metric.add_metric(val, m.group(1))
                self.eval_nodes.append((m.group(2), 0))
            elif name == "metric":
                self.metric.add_metric(val, "label")
                self.train_metric.add_metric(val, "label")
                self.eval_nodes.append(("", -1))
        self.cfg_pairs.append((name, val))

    # ------------------------------------------------------------------
    # model lifecycle
    # ------------------------------------------------------------------
    def init_model(self) -> None:
        """Build the net from the config and draw its params from
        `seed` (float32 on the CPU, then moved to the device)."""
        if (self.stage_dtype == "bfloat16"
                and self.compute_dtype == torch.float32):
            raise ValueError(
                "stage_dtype=bfloat16 requires dtype=bfloat16 "
                "(f32 compute always stages f32)")
        self.net_cfg.configure(self.cfg_pairs)
        self._build_net()
        self.epoch = 0
        self._reset_counters()
        self._init_state({k: {n: t.to(self.device) for n, t in d.items()}
                          for k, d in self.net.init_params(
                              self.seed).items()})

    def _build_net(self) -> None:
        if self.batch_size <= 0:
            raise ValueError("batch_size must be set")
        if self.device.type == "cuda" and self.compute_dtype == torch.float32:
            # the reference runs float32 convolutions at full precision
            # (cxxnet_tpu/ops/conv.py: Precision.HIGHEST); cuDNN would
            # default to TF32. The flag is process-wide (torch has no
            # per-call switch), so a float32 trainer on the card sets it.
            torch.backends.cudnn.allow_tf32 = False
        self._pipeline = PassPipeline.from_config(self.graph_passes,
                                                  self._pass_toggles)
        self._graph_dtype_plan = None
        self._fold_stats = None
        self._quant_stats = None
        self._fold_epoch = 0
        self._infer_graph_cache = {}
        # fold/quant sites depend only on the structure: matched once
        self._fold_sites = (find_fold_sites(self.net_cfg)
                            if self._pipeline.has("fold_conv_bn") else [])
        self._quant_sites = (find_quant_sites(self.net_cfg)
                             if self._pipeline.has("quantize_int8")
                             else [])
        if self._pipeline.graph_passes:
            gm = self._pipeline.run_graph(GraphModule.from_net_config(
                self.net_cfg, self.batch_size, self.compute_dtype))
            self._graph_dtype_plan = gm.dtype_plan or None
            if not self.silent:
                for line in gm.log:
                    sys.stdout.write(f"graph_passes: {line}\n")
        self.net = Network(self.net_cfg, self.batch_size)
        self.net.dtype_plan = self._graph_dtype_plan
        if not self.silent:
            for i, s in enumerate(self.net.node_shapes):
                sys.stdout.write(f"node[{self.net_cfg.node_names[i]}].shape: "
                                 f"{s[0]},{s[1]},{s[2]},{s[3]}\n")
        self.eval_nodes = [
            (name, self.net_cfg.num_nodes - 1 if name == ""
             else self.net.node_index(name)) for name, _ in self.eval_nodes]
        self._augment_fn = (self._make_augment() if self.device_augment
                            else None)
        self._build_updaters()
        self._flight_fps = {}
        self._tel_steps = (bool(self.telemetry_steps)
                           and telemetry.get().enabled)

    def _make_augment(self):
        """The device augment of the conf's spec (the JAX trainer's
        make_device_augment call)."""
        dc = self._daug_cfg
        mean_loader = None
        if dc.get("image_mean"):
            def mean_loader(path=dc["image_mean"]):
                # lazy: called at the first augment, after the
                # iterator's init had its chance to create the mean file
                if not os.path.exists(path):
                    raise FileNotFoundError(
                        f"device_augment: mean image '{path}' not "
                        "found; run the data pipeline once (the "
                        "iterator creates it) or point image_mean "
                        "at an existing mean file")
                from cxxnet_tpu_torch.io.augment import load_mean_image
                return load_mean_image(path)
        mean_values = None
        if dc.get("mean_value"):
            b_, g_, r_ = (float(t) for t in dc["mean_value"].split(","))
            mean_values = (b_, g_, r_)
        return make_device_augment(
            tuple(self.net_cfg.input_shape),
            mean_loader=mean_loader, mean_values=mean_values,
            scale=float(dc.get("scale", "1.0")),
            rand_crop=int(dc.get("rand_crop", "0")),
            rand_mirror=int(dc.get("rand_mirror", "0")),
            mirror=int(dc.get("mirror", "0")),
            crop_y_start=int(dc.get("crop_y_start", "-1")),
            crop_x_start=int(dc.get("crop_x_start", "-1")),
            max_random_contrast=float(dc.get("max_random_contrast", "0")),
            max_random_illumination=float(
                dc.get("max_random_illumination", "0")))

    def _build_updaters(self) -> None:
        """One Updater per weight tensor, configured with defcfg +
        layercfg[i] under its tag (neural_net-inl.hpp:177-204)."""
        self.updaters = {}
        utype = self.net_cfg.updater_type
        for idx, info in enumerate(self.net_cfg.layers):
            if info.is_shared:
                continue
            tags = self.net.layer_objs[idx].param_tags()
            if not tags:
                continue
            key = param_key(self.net_cfg, idx)
            self.updaters[key] = {}
            for pname, tag in tags.items():
                up = UpdaterParam(tag)
                kwargs = {}
                for k, v in (self.net_cfg.defcfg
                             + self.net_cfg.layercfg[idx]):
                    up.set_param(k, v)
                    if utype == "adam" and k == "beta1":
                        kwargs["decay1"] = float(v)
                    if utype == "adam" and k == "beta2":
                        kwargs["decay2"] = float(v)
                self.updaters[key][pname] = create_updater(utype, up,
                                                           **kwargs)

    def _reset_counters(self) -> None:
        self._step_counter = 0
        self._bad_consec = 0
        self._count = 0
        self._accum = None

    def _init_state(self, params: Params) -> None:
        """Fresh train state around `params`: zero updater state (or
        the state a loaded checkpoint carried), no accumulated
        gradient, zero train metrics."""
        ustate = {lk: {pn: up.init_state(params[lk][pn])
                       for pn, up in d.items() if pn in params.get(lk, {})}
                  for lk, d in self.updaters.items()}
        if self._loaded_opt is not None:
            ustate = convert.ustate_from_numpy(self._loaded_opt, ustate,
                                               self.device)
            self._loaded_opt = None
        self.state = {"params": params, "ustate": ustate}
        self._accum = None
        self._count = 0
        self._weights_changed(retire=True)
        self.clear_train_metric()

    def set_train_state(self, params: Params, ustate, epoch: int) -> None:
        """Install params, updater state and the update counter (the
        carry from a JAX train state - convert.train_state_from_numpy)."""
        self.state = {"params": params, "ustate": ustate}
        self.epoch = int(epoch)
        self._reset_counters()
        self._weights_changed(retire=True)
        self.clear_train_metric()

    def _set_params(self, params: Params) -> None:
        """Replace the params (updater state kept, or made fresh)."""
        if self.state is None:
            self._init_state(params)
        else:
            self.state["params"] = params
            self._weights_changed(retire=True)

    def _weights_changed(self, retire: bool = False) -> None:
        """The master params changed: drop the cached compute-dtype and
        transformed copies. `retire` (a load or set_weight, not a
        training step) also retires the frozen calibration statistics,
        as the JAX package does."""
        self._cparams = None
        self._wversion += 1
        if retire:
            self._retire_calibration_state()

    def _cast(self, tree):
        """The JAX package's `_cast`: every floating leaf to the compute
        dtype (int8 leaves stay), unless the compute dtype is float32 or
        an autocast plan owns the casts per layer."""
        if (self.compute_dtype == torch.float32
                or self._graph_dtype_plan is not None):
            return tree
        return _tree_map(lambda t: t.to(self.compute_dtype)
                         if t.is_floating_point() else t, tree)

    def compute_params(self) -> Params:
        """Params in the compute dtype: the master copy itself under
        float32 or an autocast plan, a wholesale bfloat16 cast (made
        once per weight change) under bfloat16."""
        cp = self._cparams
        if cp is None:
            cp = self._cast(self.state["params"])
            self._cparams = cp
        return cp

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _pad_batch(self, batch: DataBatch, train: bool):
        """(data, label, mask) padded up to batch_size (numpy).

        `train`: every DELIVERED row is valid - num_batch_padd marks
        round_batch wrap-fill rows, real instances the reference trains
        and trims only from eval/pred (nnet_impl-inl.hpp:239); eval
        masks them. Rows padded up to batch_size are always masked."""
        b = batch.batch_size
        if b > self.batch_size:
            raise ValueError("batch larger than configured batch_size")
        label = (np.zeros((b, 1), np.float32) if batch.label is None
                 else np.asarray(batch.label, np.float32).reshape(b, -1))
        valid = np.ones(b, np.float32)
        if not train and batch.num_batch_padd:
            valid[b - batch.num_batch_padd:] = 0.0
        pad = self.batch_size - b
        data = np.asarray(batch.data)
        if pad:
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], data.dtype)])
            label = np.concatenate(
                [label, np.zeros((pad,) + label.shape[1:], np.float32)])
            valid = np.concatenate([valid, np.zeros(pad, np.float32)])
        return data, label, valid

    def _staged_dtype(self, data: np.ndarray) -> torch.dtype:
        """The dtype a batch crosses to the device in (the JAX package's
        `_host_input`). Under bfloat16 the rows are cast on the host
        (half the bytes across) unless `stage_dtype = float32` (float32
        across, the cast on the device); both round to nearest even, so
        the staged values are the same bits either way. Under
        device_augment raw uint8 pixels stage as uint8 (1/4 the float32
        bytes, no host arithmetic), anything else as float32 unless
        `stage_dtype = bfloat16` asks for the host cast."""
        if self.device_augment and data.dtype == np.uint8:
            return torch.uint8
        if (self.compute_dtype == torch.float32
                or self.stage_dtype == "float32"
                or (self.device_augment
                    and self.stage_dtype != "bfloat16")):
            return torch.float32
        return torch.bfloat16

    def _on_device(self, data: torch.Tensor) -> torch.Tensor:
        """Staged rows on the device -> what the step reads: cast to the
        compute dtype, or left raw under device_augment (the forward
        augments, then casts)."""
        return data if self.device_augment else data.to(self.compute_dtype)

    def _stage(self, batch: DataBatch, train: bool,
               ring=None) -> StagedBatch:
        """Pad, cast on the host or not, copy to the device: data, label
        fields and the row mask of one batch. With a PinnedRing
        (io/prefetch.py) the host arrays are written into its next
        slot's pinned buffers and copied, with the device cast, on its
        side stream; without one they are copied on the current
        stream. The two give the same values."""
        data, label, valid = self._pad_batch(batch, train)
        ready = None
        if ring is None:
            gdata = self.stage_infer_rows(data)
            lab, mask = (torch.from_numpy(a).to(self.device)
                         for a in (label, valid))
        else:
            data = self._host_rows(data)
            slot = ring.acquire()
            host = [slot.fill(i, a, dt) for i, (a, dt) in enumerate((
                (data, self._staged_dtype(data)), (label, torch.float32),
                (valid, torch.float32)))]
            with torch.cuda.stream(ring.stream):
                gdata, lab, mask = (h.to(self.device, non_blocking=True)
                                    for h in host)
                gdata = self._on_device(gdata)
            ready = slot.release()
        fields = {}
        for fname, idx in self.net_cfg.label_name_map.items():
            a, b = self.net_cfg.label_range[idx]
            fields[fname] = lab[:, a:b]
        return StagedBatch(gdata, fields, mask, ready)

    def stage_batch(self, batch: DataBatch, ring=None) -> StagedBatch:
        """Stage a training batch (see _stage) for update(). The staging
        is the streamed step's own, so a staged update is
        trajectory-identical to a streamed one."""
        return self._stage(batch, train=True, ring=ring)

    def prefetch(self, data_iter, depth: int = 1, chunk: int = 1):
        """Wrap a DataIter so batch k+1 is staged on a worker thread
        while step k runs (io/prefetch.py); update() consumes the staged
        values. chunk > 1 (the fused dispatch of steps_per_dispatch) is
        not ported."""
        if chunk > 1:
            raise NotImplementedError(
                f"steps_per_dispatch = {chunk}: fused dispatch is not "
                "ported to cxxnet_tpu_torch yet (see ROADMAP)")
        from cxxnet_tpu_torch.io.prefetch import StagedPrefetcher
        return StagedPrefetcher(self.stage_batch, data_iter, depth,
                                device=self.device)

    def _await(self, staged: StagedBatch) -> None:
        """A batch staged on a side stream: make the current stream wait
        for its copies and keep its memory from being reused before the
        step that reads it is done."""
        if staged.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.ready)
        for t in (staged.data, staged.mask, *staged.labels.values()):
            t.record_stream(stream)

    def _model_input(self, data: torch.Tensor, train: bool = False,
                     step: int = 0) -> torch.Tensor:
        """The net's input from staged rows: as staged, or under
        device_augment augmented (random draws from stream (seed + 100,
        step, AUGMENT_STREAM) in training, the deterministic variant
        otherwise) and cast to the compute dtype."""
        if self._augment_fn is None:
            return data
        gen = None
        if train:
            gen = torch.Generator(device=self.device).manual_seed(
                stream_seed(self.seed + 100, step, AUGMENT_STREAM))
        return self._augment_fn(data, train, gen).to(self.compute_dtype)

    def _metric_rows(self, mset: MetricSet, values, labels, mask,
                     seed: int, step: int, base: int) -> torch.Tensor:
        """(n_metrics, 2) float32 rows of (sum, count) on the device;
        metric i draws its tie-break from stream (seed, step,
        base + i) - the JAX trainer's fold_in(rng, base + i)."""
        rows = []
        for i, ((_, field), fn, (_, nid)) in enumerate(
                zip(mset.specs, mset.fns, self.eval_nodes)):
            v = values[nid]
            pred = v.reshape(v.shape[0], -1).float()
            gen = torch.Generator(device=self.device).manual_seed(
                stream_seed(seed, step, base + i))
            s, c = fn(pred, labels[field], mask, gen)
            rows.append(torch.stack([s, c]))
        return torch.stack(rows)

    # ------------------------------------------------------------------
    # dispatch introspection (telemetry/flight.py)
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _flight_record(self, key, kind: str, name: str, shape,
                       nbytes: int, donated: int = 0):
        """One dispatch under flight-recorder + executable-registry
        accounting: register the program shape on first sight, open a
        ring entry when armed, close it with the error if the block
        raises, and count the dispatch on success."""
        tel = telemetry.get()
        fp = self._flight_fps.get(key)
        if fp is None:
            fp = fingerprint(*key)
            tel.executables.register(
                fp, name=name, kind=kind, shape=str(tuple(shape)),
                arg_bytes=int(nbytes), device=str(self.device),
                donated=donated)
            self._flight_fps[key] = fp
        fl = (tel.flight.start(kind, fp=fp, bucket=shape[0],
                               nbytes=int(nbytes))
              if tel.flight.enabled else None)
        try:
            yield
        except BaseException as e:
            tel.flight.fail(fl, f"{type(e).__name__}: {e}")
            raise
        tel.flight.finish(fl)
        tel.executables.count_dispatch(fp)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def update(self, batch,
               keep: Optional[Dict[int, Any]] = None) -> torch.Tensor:
        """One training mini-batch (CXXNetThreadTrainer::Update): a
        DataBatch (streamed) or a StagedBatch (stage_batch, or a
        prefetcher's value). `keep` injects the random draws ({layer
        index: array of the layer's input shape}: dropout's boolean
        mask, the uniform float32 draw of insanity, prelu's noise and
        insanity_max_pooling) instead of drawing them. Returns the
        scaled loss (a device scalar; reading it syncs)."""
        if not isinstance(batch, StagedBatch):
            # the streamed path IS one stage_batch call - structural
            # guarantee of the staged/streamed trajectory equivalence;
            # a rejected batch raises before the step counter moves
            batch = self.stage_batch(batch)
        self._await(batch)
        data, labels, mask = batch.data, batch.labels, batch.mask
        if keep is not None:
            keep = {i: torch.from_numpy(np.asarray(k)).to(self.device)
                    for i, k in keep.items()}
        step = self._step_counter
        self._step_counter += 1
        t0 = time.perf_counter()
        snap = self._snapshot() if self.check_nan else None
        # the master params are updated in place: the port's form of
        # the JAX step's donated state
        with self._flight_record(
                ("train_step", tuple(data.shape)), kind="train",
                name=f"train_step@b{data.shape[0]}", shape=data.shape,
                nbytes=data.numel() * data.element_size(), donated=1):
            loss = self._train_step(data, labels, mask, step, keep)
            if snap is not None:
                self._guard_step(self._finite(loss), snap, step)
        # progress beacon for the hang watchdog / absence alert rules
        telemetry.beacon("train.step")
        if self._tel_steps:
            # the loss readback is the step's sync: honest step times,
            # paid only with a telemetry consumer armed
            loss_val = float(loss)
            step_s = time.perf_counter() - t0
            n = int(data.shape[0])
            tel = telemetry.get()
            tel.observe("train.step_s", step_s)
            tel.inc("train.images", n)
            tel.set_gauge("train.loss", loss_val)
            tel.event("span", name="train.step", secs=step_s, step=step,
                      loss=loss_val, examples=n)
        return loss

    def _train_step(self, data, labels, mask, step, keep) -> torch.Tensor:
        master = self.state["params"]
        leaves = _tree_map(lambda t: t.detach().requires_grad_(True),
                           master)
        seed = self.seed + 100
        dev = self.device

        def gens(idx: int) -> torch.Generator:
            return torch.Generator(device=dev).manual_seed(
                stream_seed(seed, step, idx))

        data = self._model_input(data, train=True, step=step)
        # the update counter a progress-following layer reads (insanity's
        # anneal), as the JAX train step binds it
        progress = self.epoch * self.update_period + self._count
        with torch.enable_grad(), active_step(progress):
            # cast inside autograd: bfloat16 compute, float32 gradients
            cparams = self._cast(leaves)
            values, total = self.net(cparams, data, train=True, gens=gens,
                                     keep=keep, labels=labels, mask=mask)
            loss = total.float() * (1.0 / (self.batch_size
                                           * self.update_period))
            flat = _tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(torch.zeros_like(t) if g is None else g
                  for t, g in zip(flat, grads))
        gtree = {lk: {pn: next(it) for pn in sorted(leaves[lk])}
                 for lk in sorted(leaves)}
        if self.update_period == 1:
            accum = gtree
        elif self._accum is None:
            accum = self._accum = gtree
        else:
            for lk, d in gtree.items():
                for pn, g in d.items():
                    self._accum[lk][pn].add_(g)
            accum = self._accum
        self._count += 1
        if self._count >= self.update_period:
            ustate = self.state["ustate"]
            for lk, d in self.updaters.items():
                for pn, up in d.items():
                    if lk in master and pn in master[lk]:
                        up.apply(ustate[lk][pn], master[lk][pn],
                                 accum[lk][pn], self.epoch)
            self._accum = None
            self._count = 0
            self.epoch += 1
            self._weights_changed()
        if self.eval_train and len(self.train_metric):
            with torch.no_grad():
                rows = self._metric_rows(self.train_metric, values, labels,
                                         mask, seed, step, 1000)
                self._tmetric += rows.double()
        return loss.detach()

    def _snapshot(self):
        """What a dropped step must leave unchanged (check_nan)."""
        def clone(t):
            return t.detach().clone()
        return (_tree_map(clone, self.state["params"]),
                _tree_map(clone, self.state["ustate"]),
                None if self._accum is None else _tree_map(clone,
                                                           self._accum),
                self._count, self.epoch, self._tmetric.clone())

    def _finite(self, loss: torch.Tensor) -> bool:
        """All-finite over the loss, the params and (update_period > 1)
        the gradient accumulator: a micro-step whose gradients go NaN
        with a finite loss leaves the params untouched, so checking
        params alone would commit the NaN into the accumulator."""
        ok = torch.isfinite(loss)
        trees = [self.state["params"]]
        if self.update_period > 1 and self._accum is not None:
            trees.append(self._accum)
        for tree in trees:
            for t in _tree_leaves(tree):
                ok = ok & torch.isfinite(t).all()
        return bool(ok)

    def _guard_step(self, ok: bool, snap, step_idx: int) -> None:
        """The divergence guard: roll a non-finite step back, count it,
        and abort after max_bad_rounds CONSECUTIVE such steps."""
        if ok:
            self._bad_consec = 0
            return
        params, ustate, accum, count, epoch, tmetric = snap
        self.state = {"params": params, "ustate": ustate}
        self._accum, self._count, self.epoch = accum, count, epoch
        self._tmetric = tmetric
        self._weights_changed()
        self._bad_consec += 1
        self.bad_rounds += 1
        sys.stderr.write(
            f"divergence guard: non-finite loss/params at update "
            f"{step_idx}; batch dropped, params rolled "
            f"back ({self._bad_consec}/{self.max_bad_rounds} "
            f"consecutive)\n")
        if self._bad_consec >= self.max_bad_rounds:
            raise DivergenceError(
                f"training diverged: {self._bad_consec} consecutive "
                f"non-finite update rounds (loss or params hit NaN/Inf "
                f"every round); lower eta or inspect the data pipeline "
                f"- params remain at the last finite state")

    def update_all(self, data_iter, eval_iters=None,
                   eval_names=None) -> str:
        """One full pass (round) over a data iterator, then evaluate
        each of eval_iters (named by eval_names, default eval/eval2/...)
        - the reference's per-round loop body (cxxnet_main.cpp:367-405).
        Returns the concatenated metric string ('' with no eval
        iterators)."""
        data_iter.before_first()
        while data_iter.next():
            self.update(data_iter.value())
        parts = []
        for i, it in enumerate(eval_iters or ()):
            name = (eval_names[i] if eval_names and i < len(eval_names)
                    else ("eval" if i == 0 else f"eval{i + 1}"))
            parts.append(self.evaluate(it, name))
        return "".join(parts)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate(self, data_iter, data_name: str) -> str:
        """Eval metrics over an iterator: `\\tname-metric:value...`
        (nnet_impl-inl.hpp:224-245). Per-batch (sum, count) rows stay
        on the device; one readback per dataset, summed in float64."""
        specs = self.metric.specs
        if not specs:
            return ""
        rows = []
        data_iter.before_first()
        step = 0
        params = self.compute_params()
        while data_iter.next():
            staged = self._stage(data_iter.value(), train=False)
            labels, mask = staged.labels, staged.mask
            gdata = staged.data
            with self._flight_record(
                    ("eval_step", tuple(gdata.shape)), kind="eval",
                    name=f"eval_step@b{gdata.shape[0]}",
                    shape=gdata.shape,
                    nbytes=gdata.numel() * gdata.element_size()), \
                    torch.inference_mode():
                values = self.net(params, self._model_input(gdata))[0]
                rows.append(self._metric_rows(self.metric, values, labels,
                                              mask, self.seed + 200, step,
                                              2000))
            telemetry.beacon("eval.step")
            step += 1
        if not rows:
            vals = np.zeros((len(specs), 2))
        else:
            vals = torch.stack(rows).double().sum(0).cpu().numpy()
        return format_metrics(data_name, specs, vals)

    def eval_train_metric(self) -> str:
        """The round's train metrics (`\\ttrain-metric:value...`), then
        the accumulator is cleared."""
        if not len(self.train_metric) or self._tmetric is None:
            return ""
        out = format_metrics("train", self.train_metric.specs,
                             self._tmetric.cpu().numpy())
        self.clear_train_metric()
        return out

    def clear_train_metric(self) -> None:
        self._tmetric = torch.zeros((len(self.train_metric), 2),
                                    dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def infer_fn(self, node: int):
        """fn(params, staged_rows) -> float32 rows of `node` over the
        trainer's own (untransformed) network (a device tensor; the
        caller decides when to read it back). `params` are
        compute-dtype params (compute_params()); any row count works.
        The inference path proper is `infer_graph`, which applies the
        infer-stage graph passes."""
        net = self.net

        def fn(params: Params, data: torch.Tensor) -> torch.Tensor:
            return net(params, self._model_input(data))[0][node].float()
        return fn

    def infer_graph(self, node: int) -> InferGraph:
        """The inference forward of `node`: the trainer's own network
        when no infer-stage pass is configured, else the pass-
        transformed graph of the current calibration epoch (built once
        per (node, epoch); an uncalibrated fold/quant site stays
        float)."""
        if not self._pipeline.infer_passes:
            return InferGraph(self, self.net, node)
        key = (node, self._fold_epoch)
        hit = self._infer_graph_cache.get(key)
        if hit is not None:
            return hit
        gm = GraphModule.from_net_config(
            self.net_cfg.clone(), self.batch_size, self.compute_dtype)
        gm.dtype_plan = dict(self._graph_dtype_plan or {})
        gm = self._pipeline.run_infer(
            gm, PassContext(target_node=node, fold_stats=self._fold_stats,
                            quant_stats=self._quant_stats))
        self._fill_quant_scales(gm)
        net2 = Network(gm.cfg, self.batch_size)
        net2.dtype_plan = gm.dtype_plan or None
        graph = InferGraph(self, net2, node, make_param_fn(gm), gm)
        self._infer_graph_cache[key] = graph
        return graph

    def stage_infer_rows(self, data: np.ndarray) -> torch.Tensor:
        """Host rows (n, c, y, x), any row count -> the device tensor the
        inference forward reads: crossed in the staged dtype
        (_staged_dtype) and cast on the device to the compute dtype, or
        left raw under device_augment."""
        arr = self._host_rows(data)
        return self._on_device(torch.from_numpy(arr).to(
            self._staged_dtype(arr)).to(self.device))

    @staticmethod
    def _host_rows(data) -> np.ndarray:
        """Contiguous host rows as they are staged: uint8 or float32 as
        given, any other dtype as float32."""
        data = np.asarray(data)
        return np.ascontiguousarray(
            data, None if data.dtype in (np.uint8, np.float32)
            else np.float32)

    def infer_rows(self, gdata: torch.Tensor, node: int = -1) -> torch.Tensor:
        """Run the inference forward on staged rows; node=-1 is the
        final node."""
        if node < 0:
            node = self.net_cfg.num_nodes - 1
        with torch.inference_mode():
            return self.infer_graph(node)(gdata)

    def _stage_padded(self, batch: DataBatch):
        """(staged data, row mask) of a batch zero-padded up to
        batch_size, as the JAX package pads every inference batch; the
        mask is 0 on padding rows and on the iterator's num_batch_padd
        rows."""
        data, _label, valid = self._pad_batch(batch, train=False)
        return (self.stage_infer_rows(data),
                torch.from_numpy(valid).to(self.device))

    def _infer_node(self, batch: DataBatch, node: int) -> np.ndarray:
        """One node's float32 rows for a batch: padded to batch_size,
        calibrated first if a graph pass still needs its statistics (the
        first inference batch is the calibration batch), run, padding
        rows (and num_batch_padd) trimmed."""
        gdata, gmask = self._stage_padded(batch)
        if self.passes_need_calibration():
            self._calibrate_staged(gdata, gmask)
        valid = batch.batch_size - batch.num_batch_padd
        with self._flight_record(
                ("infer", node, self._fold_epoch, tuple(gdata.shape)),
                kind="infer", name=f"infer:n{node}@b{gdata.shape[0]}",
                shape=gdata.shape,
                nbytes=gdata.numel() * gdata.element_size()):
            out = self.infer_rows(gdata, node)[:valid].cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # graph passes: calibration
    # ------------------------------------------------------------------
    def _fill_quant_scales(self, gm: GraphModule) -> None:
        """Freeze each QuantSite's per-channel weight scale from the
        TRANSFORMED float32 weights (a folded or merged weight is scaled
        at its composed values); the int8 values themselves follow the
        live params."""
        sites = [s for s in gm.quants if s.wscale is None]
        if not sites:
            return
        with torch.no_grad():
            fl = make_param_fn(gm, quantize=False)(self.state["params"])
        by_live = {live: new for new, live in gm.param_map().items()}
        for site in sites:
            entry = fl.get(by_live.get(site.key))
            if entry is None or "wmat" not in entry:
                continue  # pruned between matching and build: float
            site.wscale = per_channel_scale(entry["wmat"])

    def _needs_fold_stats(self) -> bool:
        return self._fold_stats is None and bool(self._fold_sites)

    def _needs_quant_stats(self) -> bool:
        return self._quant_stats is None and bool(self._quant_sites)

    def passes_need_calibration(self) -> bool:
        """True when fold_conv_bn or quantize_int8 has a matched site
        whose statistics are missing: predict then calibrates on its
        first batch; a Server built now serves the float graph (and
        warns)."""
        if self._pipeline is None:
            return False
        return self._needs_fold_stats() or self._needs_quant_stats()

    def calibrate_graph_passes(self, batch) -> bool:
        """Capture the fold statistics and quant activation ranges from
        one DataBatch (padded and staged as an inference batch is), or,
        given a sequence of batches, pool them over all of them. Returns
        True when statistics were (re)captured, False when nothing
        needed calibration."""
        if isinstance(batch, (list, tuple)):
            if len(batch) == 1:
                return self.calibrate_graph_passes(batch[0])
            return self._calibrate_batches(list(batch))
        if not self.passes_need_calibration():
            return False
        return self._calibrate_staged(*self._stage_padded(batch))

    def _calibration_taps(self, gdata: torch.Tensor):
        """One forward of the untransformed net with the fold sites'
        batch_norm inputs and the quant sites' inputs tapped."""
        sites = self._fold_sites if self._needs_fold_stats() else []
        qsites = self._quant_sites if self._needs_quant_stats() else []
        taps: Dict[int, Any] = {j: None for _i, j in sites}
        taps.update({q: None for q in qsites})
        with torch.inference_mode():
            self.net(self.compute_params(), self._model_input(gdata),
                     taps=taps)
        return sites, qsites, taps

    def _calibrate_staged(self, gdata: torch.Tensor,
                          gmask: torch.Tensor) -> bool:
        """Calibration on staged rows: each fold site's batch_norm input
        moments with the layer's own arithmetic (float32, rsqrt(var +
        eps)) - deliberately UNmasked, since on the single-batch path
        the calibration batch is the inference batch, padding included,
        and the unfolded batch_norm normalizes over all of it - and each
        quant site's input absmax over the valid rows only."""
        if not self.passes_need_calibration():
            return False
        sites, qsites, taps = self._calibration_taps(gdata)
        if sites:
            stats = {}
            for _i, j in sites:
                lay = self.net.layer_objs[j]
                xf = taps[j].float()
                axes, _ = lay._axes(xf.shape)
                mean = xf.mean(dim=axes, keepdim=True)
                var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
                rstd = torch.rsqrt(var + lay.eps)
                stats[param_key(self.net_cfg, j)] = (
                    mean.reshape(-1).cpu().numpy(),
                    rstd.reshape(-1).cpu().numpy())
            self._fold_stats = stats
        if qsites:
            self._quant_stats = {
                param_key(self.net_cfg, q): _masked_absmax(taps[q], gmask)
                for q in qsites}
        self._fold_epoch += 1
        self._evict_stale_infer_caches()
        return True

    def _calibrate_batches(self, batches: List[DataBatch]) -> bool:
        """Calibration over several batches: per batch, the fold sites'
        moments over the VALID rows (mean, var) and the quant sites'
        masked absmax; then on the host the moments pooled weighted by
        valid-row count (var from the pooled second moment), rstd = 1 /
        sqrt(var + eps), and the ranges pooled by max."""
        if not batches:
            raise ValueError("calibration needs at least one batch")
        if not self.passes_need_calibration():
            return False
        eps = {param_key(self.net_cfg, j): self.net.layer_objs[j].eps
               for _i, j in self._fold_sites}
        per_batch: List[Dict[str, Any]] = []
        q_batch: List[Dict[str, float]] = []
        weights: List[float] = []
        sites: List[Tuple[int, int]] = []
        qsites: List[int] = []
        for b in batches:
            gdata, gmask = self._stage_padded(b)
            sites, qsites, taps = self._calibration_taps(gdata)
            res = {}
            for _i, j in sites:
                lay = self.net.layer_objs[j]
                xf = taps[j].float()
                axes, _ = lay._axes(xf.shape)
                m = gmask.float().reshape(
                    (-1,) + (1,) * (xf.dim() - 1)).expand(xf.shape)
                denom = m.sum(dim=axes, keepdim=True)
                mean = (xf * m).sum(dim=axes, keepdim=True) / denom
                var = (m * (xf - mean) ** 2).sum(dim=axes,
                                                 keepdim=True) / denom
                res[param_key(self.net_cfg, j)] = (
                    mean.reshape(-1).cpu().numpy(),
                    var.reshape(-1).cpu().numpy())
            per_batch.append(res)
            q_batch.append({param_key(self.net_cfg, q):
                            _masked_absmax(taps[q], gmask) for q in qsites})
            weights.append(float(gmask.sum()))
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        stats: Dict[str, Any] = {}
        for key in per_batch[0]:
            means = np.stack([pb[key][0] for pb in per_batch])
            variances = np.stack([pb[key][1] for pb in per_batch])
            mean = (means * w[:, None]).sum(axis=0)
            var = ((variances + means ** 2)
                   * w[:, None]).sum(axis=0) - mean ** 2
            rstd = 1.0 / np.sqrt(np.maximum(var, 0.0) + eps[key])
            stats[key] = (mean.astype(np.float32), rstd.astype(np.float32))
        if sites:
            self._fold_stats = stats
        if qsites:
            self._quant_stats = {k: max(qb[k] for qb in q_batch)
                                 for k in q_batch[0]}
        self._fold_epoch += 1
        self._evict_stale_infer_caches()
        return True

    def calibration(self) -> Tuple[Optional[Dict[str, Any]],
                                   Optional[Dict[str, float]]]:
        """(fold statistics, quant activation ranges) as frozen now -
        copies; None where not calibrated."""
        fold = (None if self._fold_stats is None else
                {k: (m.copy(), r.copy())
                 for k, (m, r) in self._fold_stats.items()})
        quant = None if self._quant_stats is None else dict(
            self._quant_stats)
        return fold, quant

    def set_calibration(self, fold_stats, quant_stats) -> None:
        """Install frozen statistics (another trainer's `calibration()`,
        e.g. one on another device) as a new calibration epoch."""
        self._fold_stats = (None if fold_stats is None else
                            {k: (np.asarray(m, np.float32).copy(),
                                 np.asarray(r, np.float32).copy())
                             for k, (m, r) in fold_stats.items()})
        self._quant_stats = (None if quant_stats is None
                             else {k: float(v)
                                   for k, v in quant_stats.items()})
        self._fold_epoch += 1
        self._evict_stale_infer_caches()

    def _retire_calibration_state(self) -> None:
        """Weights changed (set_weight, a load): frozen fold statistics
        and quant scales describe the OLD weights - drop them and the
        graphs built on them; the next inference recalibrates. A running
        Server keeps the graph it was built on."""
        if self._fold_stats is not None or self._quant_stats is not None:
            self._fold_stats = None
            self._quant_stats = None
            self._fold_epoch += 1
            self._evict_stale_infer_caches()

    def _evict_stale_infer_caches(self) -> None:
        """Keep only the current calibration epoch's graphs."""
        epoch = self._fold_epoch
        self._infer_graph_cache = {
            k: v for k, v in self._infer_graph_cache.items()
            if k[1] == epoch}

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
        """The JAX package's checkpoint format; the updater state rides
        along under `save_optimizer = 1`."""
        params = convert.params_to_numpy(self.state["params"],
                                         self.net.param_shapes())
        opt = (convert.ustate_to_numpy(self.state["ustate"])
               if self.save_optimizer else None)
        checkpoint.save_model(fo, 0, self.net_cfg.to_dict(), self.epoch,
                              params, opt)

    @staticmethod
    def _read_native(fi) -> dict:
        head = fi.read(len(checkpoint.MAGIC))
        fi.seek(-len(head), 1)
        if head != checkpoint.MAGIC:
            raise NotImplementedError(
                "model_format = cxxnet (reference-binary checkpoints) is "
                "not ported to cxxnet_tpu_torch yet; load a native "
                "checkpoint")
        return checkpoint.load_model(fi)

    def load_model(self, fi) -> None:
        """Load a checkpoint in the JAX package's native format: the file
        supplies structure, weights, the update counter and, if it
        carries one, the updater state (for `continue = 1`); the config
        supplies the layer settings."""
        blob = self._read_native(fi)
        self.net_cfg = NetConfig.from_dict(blob["net"])
        self.net_cfg.configure(self.cfg_pairs)
        self._build_net()
        self.epoch = blob["epoch"]
        self._reset_counters()
        self._loaded_opt = blob["opt_state"]
        self._init_state(convert.params_from_numpy(
            blob["params"], self.net.param_shapes(), self.device))

    def copy_model_from(self, fi) -> None:
        """Finetune: copy the params of layers whose names match
        (nnet_impl-inl.hpp:101-134); call after init_model. The updater
        state starts fresh."""
        if self.state is None:
            raise RuntimeError("copy_model_from requires init_model first")
        blob = self._read_native(fi)
        params = convert.params_to_numpy(self.state["params"],
                                         self.net.param_shapes())
        copied = []
        for lk, d in blob["params"].items():
            if lk.startswith("layer_"):
                continue  # unnamed layers are not matched
            if lk in params:
                for pn, arr in d.items():
                    if pn in params[lk] and arr.shape == params[lk][pn].shape:
                        params[lk][pn] = arr
                copied.append(lk)
        if not self.silent:
            sys.stdout.write(f"finetune: copied layers {copied}\n")
        self._init_state(convert.params_from_numpy(
            params, self.net.param_shapes(), self.device))

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
        self._weights_changed(retire=True)

    def _weight_key(self, layer_name: str, tag: str) -> Tuple[str, str]:
        idx = self.net_cfg.get_layer_index(layer_name)
        for pname, t in self.net.layer_objs[idx].param_tags().items():
            if t == tag or pname == tag:
                return param_key(self.net_cfg, idx), pname
        raise KeyError(f"layer {layer_name} has no weight tagged {tag}")
