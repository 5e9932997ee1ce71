"""NetTrainer (counterpart of cxxnet_tpu/nnet/trainer.py).

The product surface of the JAX trainer: set_param / init_model /
load_model / save_model / copy_model_from / update / update_chunk /
stage_batch / stage_chunk / prefetch / update_all / evaluate /
eval_train_metric / start_round / profile_summary / round_stats /
predict / predict_dist / extract_feature / stage_infer_rows +
stage_extras + infer_rows / get_weight / set_weight.

- Checkpoints: the JAX package's native format, or the reference binary
  under `model_format = cxxnet` (nnet/legacy_format.py, byte-equal to
  the JAX package's); load_model and copy_model_from read either.
- Extra inputs (`extra_data_num`, nodes in_1..in_k): each batch's
  DataBatch.extra_data arrays are padded with its rows, crossed to the
  device in float32 and cast there as the JAX package's `_cast` casts
  them, on every path (training, staged or prefetched, evaluation,
  inference, calibration); a batch that carries fewer raises.

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
  they were - the update is computed out of place and committed by a
  select on the device, the counters kept there - and `max_bad_rounds`
  such steps in a row raise DivergenceError.
- Fused dispatch (`steps_per_dispatch = K`, `stage_chunk` /
  `update_chunk`): K staged batches stacked on the device, their K
  microsteps run eagerly with the streamed step's code and no host read
  between them (under check_nan one finite-vector readback a chunk), so
  a chunk trains exactly as K update() calls.
- `remat = 1`: the training forward in checkpoint segments
  (Network.remat_segments), recomputed in the backward pass.
- `profile` / `profile_dir` / `trace_round`: the step profiler
  (utils/profiler.py: round summaries, one torch.profiler trace), whose
  per-round stats also feed the CLI's round records. `tuning_cache`:
  knob defaults and a per-layer plan from nnet/tuning.py's cache;
  explicit keys win.

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

The device is fixed at construction: this worker's card (`cuda:0`, or
cuda:<local rank> in a multi-worker job) unless the caller asks for the
CPU (`device="cpu"`, or `dev = cpu` in the constructor's conf string);
with no card a CUDA device raises (utils/device.py). A `dev` key
reaching set_param later is validated and sizes the data axis (a
device list) but does not move the trainer - the CLI maps `dev` to the
constructor's device.

Data parallelism (parallel/, `param_server = dist` under
tools/launch_dist, `mesh = data:N` or a multi-device `dev`): one process
per rank, the data axis their process group. Each rank feeds its
contiguous rows of the global batch (`_local_batch` rows from
`_local_row_start`, the JAX package's `_compute_local_rows`); the loss
keeps the 1/(batch_size*update_period) scale of the GLOBAL batch; after
each microstep's backward one all-reduce sums the loss, the gradients
and the train-metric rows over the ranks, so every rank commits the
same update and makes the same check_nan decision. Every rank starts
from the same seeded init (nothing is broadcast: check_weights proves
the ranks agree). Evaluation sums its metric rows over the ranks. A
mesh larger than the job raises, naming param_server = dist and
tools/launch_dist - except in an inference trainer of one process
(`one_process = True`, the CLI's task = serve), where the mesh cuts
nothing and its data axis only sizes the serving buckets
(`serve_data_axis`), as the JAX package serves on a one-process mesh.

ZeRO (parallel/sharding.py: ZeroCut, one cut tree for every stage):
`zero_stage = 1` (`shard_optimizer`, or `update_on_server = 1`) cuts
each weight's updater state over the data ranks: a rank updates its
slice and one all-gather returns the fresh weights. `zero_stage = 2`
also cuts the gradients: the cut weights' gradients travel by one
reduce-scatter over the data group (the rest, the loss and the metric
rows by one all-reduce), and the update_period accumulator is stored
cut. `zero_stage = 3` also keeps the cut weights cut between steps:
they are all-gathered just before each forward (training, evaluation,
inference) and the whole copies dropped after it; the update lands on
the slice with no gather. Without a data axis the stage degrades to at
most 1, as in the JAX package.

The model axis (`mesh = model:M`, `mesh = data:N,model:M`;
parallel/tensor.py): each rank stores its model shard of every weight
its layer places on 'model' (sharding.py: ParamCut; every rank draws
the same whole seeded init and keeps its block), the layers run on
their blocks and close with the model group's collectives, and the
gradients are reduced over the data group only. The M ranks of one
data replica feed the same rows (the data index picks them).
Checkpoints, get_weight and convert.train_state_to_numpy gather the
model, expert, pipe and ZeRO cuts, so a file is the same bytes at
every stage and mesh; loads and set_weight cut again.

The expert and pipe axes (`mesh = data:2,seq:2,expert:2`, `mesh =
data:2,pipe:4`, ...): ParamCut also cuts moe's expert weights over the
expert ranks and a transformer_stack's stacked layers over the pipe
ranks (each stage holds L/P of them); the ranks of one data index feed
the same rows, the moe layer closes its local experts with the expert
group's collectives and the stack runs a GPipe schedule over the pipe
group (layers/moe.py, layers/transformer_stack.py). Both leave every
other param replicated and computed alike on those ranks, so the
gradient group stays data x seq; a mesh without a data axis replicates
the batch. zero_stage >= 2 with either axis raises, as in the JAX
package; ZeRO-1 cuts over the data axis on the first dim the placement
left free.

The seq axis (`mesh = seq:N`, `data:D,seq:N`, `data:D,model:M,seq:N`;
parallel/ring.py): the N ranks of one data index feed its whole rows
and the network cuts each rank's sequence block of the input
(nnet/network.py); params and updater state are whole on every seq
rank. The layers before the sequence gather see only their block's
positions, the layers after it compute the same values on every seq
rank, so the loss is scaled by 1 / N and the gather's backward is a
reduce-scatter: each rank's gradient is then its share, and one
all-reduce over the gradient group (data x seq) takes the place of the
data group's (a fullc_gather weight's gradient, whole on every rank
already, is scaled back by N). The train metric counts seq rank 0's
rows; evaluation sums over the data group. zero_stage >= 2 with a seq
axis raises, as in the JAX package; ZeRO-1 cuts over the data axis.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import threading
import time
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from cxxnet_tpu_torch import convert, telemetry
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers.base import active_step
from cxxnet_tpu_torch.nnet import checkpoint, legacy_format
from cxxnet_tpu_torch.nnet.net_config import NetConfig
from cxxnet_tpu_torch.nnet.network import Network, param_key
from cxxnet_tpu_torch.nnet.passes import (
    GraphModule, PassContext, PassPipeline, find_fold_sites,
    find_quant_sites, make_param_fn)
from cxxnet_tpu_torch.ops.augment import AUGMENT_STREAM, make_device_augment
from cxxnet_tpu_torch.ops.int8 import per_channel_scale
from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, MeshSpec, active_mesh, build_mesh,
    check_axes, check_device_list, data_axis, parse_device_spec,
    parse_mesh_spec)
from cxxnet_tpu_torch.parallel.sharding import (
    ParamCut, ZeroCut, shardings_for, zero_partition_dims)
from cxxnet_tpu_torch.telemetry.flight import fingerprint
from cxxnet_tpu_torch.updater import (UpdaterParam, create_updater,
                                      schedule_table)
from cxxnet_tpu_torch.utils.config import check_ported, parse_config_string
from cxxnet_tpu_torch.utils.device import (
    check_spec, default_device, device_from_spec, resolve_device)
from cxxnet_tpu_torch.utils import fault
from cxxnet_tpu_torch.utils.fault import DivergenceError
from cxxnet_tpu_torch.utils.metric import MetricSet, format_metrics

Params = Dict[str, Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Config keys of the JAX trainer that change results (or the serving
# contract) and that the port does not implement yet: any value but the
# listed inert ones raises NotImplementedError naming the key. (The
# parallelism keys are ported; their unported values - ZeRO stages 2-3,
# the non-data mesh axes - raise in set_param, naming themselves.)
_NOT_PORTED: Dict[str, Tuple[str, ...]] = {}


class StagedBatch(NamedTuple):
    """A training batch staged on the trainer's device (stage_batch):
    data (compute dtype; raw uint8 or float32 under device_augment), the
    label fields and the row mask. `ready` is the event after its copies
    when they were issued on a prefetcher's side stream (None when
    staged on the consumer's stream); update() waits on it. `extras`
    holds one tensor per extra input node (extra_data_num).
    `n_examples` counts the batch's distinct instances (the profiler's
    images per second)."""
    data: torch.Tensor
    labels: Dict[str, torch.Tensor]
    mask: torch.Tensor
    ready: Any = None
    extras: Tuple[torch.Tensor, ...] = ()
    n_examples: int = 0


class StagedChunk(NamedTuple):
    """K staged batches stacked along a leading microstep axis: the
    input of one fused update (steps_per_dispatch = K, update_chunk).
    Built by stage_chunk from the per-batch staging pipeline and a
    device-side stack (pure data movement), so its K microsteps train
    exactly as K streamed updates. `ready` as StagedBatch's."""
    data: torch.Tensor                 # (K, batch, ...)
    labels: Dict[str, torch.Tensor]    # each (K, batch, width)
    mask: torch.Tensor                 # (K, batch)
    n_examples: Tuple[int, ...]        # distinct instances per microstep
    ready: Any = None
    extras: Tuple[torch.Tensor, ...] = ()

    @property
    def n_steps(self) -> int:
        return len(self.n_examples)

    def micro(self, i: int) -> StagedBatch:
        """Microstep i as a StagedBatch (views into the chunk)."""
        return StagedBatch(self.data[i],
                           {f: v[i] for f, v in self.labels.items()},
                           self.mask[i], None,
                           tuple(e[i] for e in self.extras),
                           self.n_examples[i])


class _DeviceCounters:
    """The update counters of guarded microsteps (check_nan = 1), kept
    on the device so that a chunk reads no host value per microstep: a
    dropped microstep leaves the update counter (`epoch`) and the
    accumulated-step count (`count`) where they were, so the next
    microstep's schedule and whether it applies the update follow a
    device flag. The schedule values of update counts e0 .. e0 + k - 1
    are computed on the host (the float32 numbers `sched` gives) and
    indexed on the device by `epoch`. `finite` collects each
    microstep's flag for the chunk's one readback."""

    def __init__(self, tr: "NetTrainer", k: int):
        dev = tr.device
        self.e0 = tr.epoch
        pin = dev.type == "cuda"
        table = torch.from_numpy(schedule_table(
            [up for _, _, up in tr._updater_list()], tr.epoch, k))
        counts = torch.tensor([tr._count, tr.epoch], dtype=torch.int64)
        if pin:
            table, counts = table.pin_memory(), counts.pin_memory()
        self.table = table.to(dev, non_blocking=True)
        counts = counts.to(dev, non_blocking=True)
        self.count, self.epoch = counts[0], counts[1]
        self.finite: List[torch.Tensor] = []

    def sched(self) -> torch.Tensor:
        """(n_updaters, 2): each updater's schedule values at the
        current update counter."""
        return self.table.index_select(
            1, (self.epoch - self.e0).reshape(1))[:, 0]


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
                        self.param_fn(tr._local_params()))
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

    def run(self, cparams: Params, data: torch.Tensor,
            extras: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        """The forward on staged rows (and staged extra inputs) with
        explicit compute params."""
        return self.net(cparams, self.trainer._model_input(data),
                        extras=extras,
                        keep_nodes=[self.node])[0][self.node].float()

    def __call__(self, data: torch.Tensor,
                 extras: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        return self.run(self.params(), data, extras)


class NetTrainer:
    """Config-driven trainer for one network."""

    def __init__(self, dev: str = "", cfg: str = "",
                 device: Optional[str] = None, one_process: bool = False):
        pairs = parse_config_string(cfg) if cfg else []
        spec = dev
        for k, v in pairs:
            if k == "dev" and not dev:
                spec = v
        if device is None:
            device = device_from_spec(spec) if spec else default_device()
        else:
            spec = spec or str(device)
        self.device = resolve_device(device)
        # the dev spec (which says whether the ranks share one card) and
        # the data mesh (parallel/): the spec's device list or `mesh`,
        # built at _build_net over the job's process group
        self._dev_spec = spec
        self.mesh_spec = MeshSpec()
        self.mesh = None
        # an inference trainer of one process (the CLI's task = serve):
        # a mesh it is given shapes the serving buckets (the data
        # axis's size, `serve_data_axis`) and cuts nothing
        self.one_process = one_process
        self.serve_data_axis = 1
        self.param_server = "local"
        self.zero_stage = 0
        self._zero_src = ""
        # the ZeRO stage this mesh runs (stage >= 2 degrades to <= 1
        # without a data axis) and its cut; the model axis's cut
        self._zero_run = 0
        self._zero: Optional[ZeroCut] = None
        self._pcut: Optional[ParamCut] = None
        # model-local param shapes (the whole shapes without a model
        # axis); gradient bytes this rank held after the last reduce
        self._local_shapes: Dict[str, Dict[str, Tuple[int, ...]]] = {}
        self.grad_bytes = 0
        # (rows this rank feeds, their first row in the global batch)
        self._local_rows = (0, 0)
        # fullc_gather weights: their gradient is full on every rank
        self._gathered: set = set()
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
        # checkpoint format written by save_model: "native" (the JAX
        # package's) or "cxxnet" (the reference binary); load_model
        # reads either
        self.model_format = "native"
        self.check_nan = 0
        self.max_bad_rounds = 3
        self.bad_rounds = 0   # total dropped steps (this process)
        self._bad_consec = 0
        self._skipped_steps = 0
        # the guard's finite-flag readbacks: one per update() and one
        # per fused chunk under check_nan = 1
        self.guard_readbacks = 0
        self._step_counter = 0
        # fused dispatch: K staged batches per update_chunk (1 = the
        # streamed / staged per-step update)
        self.steps_per_dispatch = 1
        # remat = 1: the training forward runs in checkpoint segments
        # (Network.remat_segments), recomputed in the backward pass
        self.remat = 0
        self._remat_segments = None
        # the tuning cache (nnet/tuning.py): tuned knobs are defaults,
        # keys the config sets explicitly win
        self.tuning_cache = ""
        self._explicit_tunables: set = set()
        # step profiler (utils/profiler.py): profile = 1 prints round
        # summaries; profile_dir traces the trace_round-th profiled
        # round with torch.profiler
        self.profile = 0
        self.profile_dir = ""
        self.trace_round = 1
        self.profiler = None
        self.round = 0
        # {"params": float32 master params, "ustate": updater state} on
        # self.device; None until init_model / load_model
        self.state: Optional[Dict[str, Any]] = None
        self.updaters: Dict[str, Dict[str, Any]] = {}
        self._accum: Optional[Params] = None   # update_period > 1
        self._count = 0       # steps accumulated toward the next update
        # (n, 3) float32: Kahan sum, its compensation, count
        self._tmetric: Optional[torch.Tensor] = None
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
            check_spec(val)  # validates
            self._dev_spec = val
            # a device LIST declares the data axis; one device (gpu:0)
            # only places every rank of the job on that card
            ids = (None if val.strip().lower().startswith("cpu")
                   else parse_device_spec(val))
            self.mesh_spec.device_indices = (ids if ids and len(ids) > 1
                                             else None)
        if name == "mesh":
            axes = parse_mesh_spec(val)
            check_axes(axes)
            self.mesh_spec.axes = axes
        if name == "param_server":
            self.param_server = val
        if name == "zero_stage":
            self._set_zero_stage(name, int(val))
        if name == "shard_optimizer":
            # legacy alias: ZeRO-1, optimizer state only
            self._set_zero_stage(name, 1 if int(val) else 0)
        if name == "update_on_server" and int(val):
            # the reference's server-side updater: the updater state
            # cut over the ranks. Enable-only: an explicit 0 must not
            # clobber shard_optimizer = 1
            self._set_zero_stage(name, max(1, self.zero_stage))
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
        if name == "model_format":
            if val not in ("native", "cxxnet"):
                raise ValueError("model_format must be native or cxxnet")
            self.model_format = val
        if name == "check_nan":
            self.check_nan = int(val)
        if name == "steps_per_dispatch":
            if int(val) < 1:
                raise ValueError("steps_per_dispatch must be >= 1")
            self.steps_per_dispatch = int(val)
        if name == "remat":
            self.remat = int(val)
        if name == "tuning_cache":
            self.tuning_cache = val
        if name in ("steps_per_dispatch", "serve_max_batch",
                    "stage_dtype", "serve_bucket_ladder"):
            # explicit config keys beat tuning-cache defaults
            self._explicit_tunables.add(name)
        if name == "profile":
            self.profile = int(val)
        if name == "profile_dir":
            self.profile_dir = val
            self.profile = max(self.profile, 1)
        if name == "trace_round":
            # which profiled round profile_dir traces (1-based)
            self.trace_round = int(val)
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

    def _set_zero_stage(self, key: str, stage: int) -> None:
        """zero_stage with the JAX package's alias rules:
        `shard_optimizer` / `update_on_server` are spellings of stage <=
        1, and one arriving after an explicit `zero_stage` that it
        contradicts warns and is ignored."""
        if not 0 <= stage <= 3:
            raise ValueError("zero_stage must be 0, 1, 2 or 3")
        if key != "zero_stage" and self._zero_src == "zero_stage":
            if stage != self.zero_stage:
                sys.stderr.write(
                    f"warning: {key} (a zero_stage={stage} alias) "
                    f"conflicts with the explicit zero_stage="
                    f"{self.zero_stage}; keeping zero_stage="
                    f"{self.zero_stage}\n")
            return
        self.zero_stage = stage
        self._zero_src = key

    @property
    def _local_batch(self) -> int:
        return self._local_rows[0]

    @property
    def _local_row_start(self) -> int:
        return self._local_rows[1]

    @property
    def _dsize(self) -> int:
        """The data axis's size (1 = a one-process trainer)."""
        return 1 if self.mesh is None else self.mesh.shape["data"]

    @property
    def _msize(self) -> int:
        """The model axis's size (1 = no tensor parallelism)."""
        return 1 if self.mesh is None else self.mesh.shape.get("model", 1)

    @property
    def _nseq(self) -> int:
        """The seq axis's size (1 = no sequence parallelism)."""
        return 1 if self.mesh is None else self.mesh.shape.get("seq", 1)

    @property
    def _meshed(self) -> bool:
        """Whether the mesh has any axis above size 1."""
        return self.mesh is not None and any(
            n > 1 for _, n in self.mesh.axes)

    def _mesh_scope(self) -> active_mesh:
        """The mesh every forward runs under, as the JAX trainer binds
        self.mesh around its train, eval, inference and calibration
        forwards: sync-BN's and fullc_gather's collectives, the global
        batch's random draws (layers/base.py rank_rand), the model and
        expert axes' collectives (parallel/tensor.py), the seq axis's
        cut of the input and its ring / Ulysses attention
        (nnet/network.py), the pipe axis's stages."""
        return active_mesh(self.mesh if self._meshed else None)

    def _build_mesh(self) -> None:
        """Join the job (param_server = dist) and build the data mesh:
        this rank's rows of the global batch, the fullc_gather weights.
        A data axis larger than the job raises (parallel/mesh.py)."""
        distributed.init_from_config(self.cfg_pairs, self.device,
                                     self._dev_spec)
        world = distributed.process_count()
        if self.one_process and world == 1:
            self._one_process_mesh()
            return
        self.mesh = build_mesh(self.mesh_spec, self.batch_size, world,
                               distributed.process_index())
        n = self._dsize
        lb = self.batch_size // n
        self._local_rows = (lb, self.mesh.rank * lb)
        self._gathered = set()
        if n > 1 and self._msize == 1:
            for idx, info in enumerate(self.net_cfg.layers):
                lay = self.net.layer_objs[idx]
                if (not info.is_shared
                        and getattr(lay, "fullc_gather", 0)):
                    self._gathered.add((param_key(self.net_cfg, idx),
                                        "wmat"))

    def _one_process_mesh(self) -> None:
        """The mesh of a one-process inference trainer (one_process):
        where the JAX package lays a mesh over the devices of one
        process, here the process holds the params whole on its one
        device, and the mesh's data axis - `mesh = data:N` or a device
        list, pruned to divide the batch as the single-controller JAX
        package prunes it - only sizes the serving buckets. A device
        list naming a card this machine lacks raises as the JAX mesh
        does."""
        spec = MeshSpec(axes=self.mesh_spec.axes,
                        device_indices=check_device_list(self._dev_spec))
        self.serve_data_axis = data_axis(spec, self.batch_size, 1)
        self.mesh = build_mesh(MeshSpec(), self.batch_size)
        self._local_rows = (self.batch_size, 0)
        self._gathered = set()

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
        self._apply_tuning_cache()
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
        self._build_mesh()
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
        self._zero_run = (self.zero_stage if self._dsize > 1
                          else min(self.zero_stage, 1))
        # a one-process inference trainer cuts nothing, but refuses the
        # stage its mesh's data axis would run, as the JAX trainer does
        self._check_zero(self.zero_stage if self.serve_data_axis > 1
                         else self._zero_run,
                         self.mesh.axes + tuple(self.mesh_spec.axes))
        self._remat_segments = (self.net.remat_segments() if self.remat
                                else None)
        self._flight_fps = {}
        self._tel_steps = (bool(self.telemetry_steps)
                           and telemetry.get().enabled)
        # telemetry reuses the profiler's per-round accumulator for its
        # round records even under profile = 0 (the summaries print
        # only under profile = 1)
        if (self.profile or self._tel_steps) and self.profiler is None:
            from cxxnet_tpu_torch.utils.profiler import StepProfiler
            self.profiler = StepProfiler(self.profile_dir,
                                         self.trace_round,
                                         cuda=self.device.type == "cuda")

    def _apply_tuning_cache(self) -> None:
        """Apply tuned knob defaults from `tuning_cache =` (nnet/
        tuning.py), the cache entry of this trainer's platform: only
        knobs the config never set explicitly, and only values that
        apply to this trainer (an inapplicable value is skipped, never
        an error); a v2 cache's per-layer plan is stamped onto the
        layer configs and its serve ladder taken unless
        `serve_bucket_ladder =` was set."""
        if not self.tuning_cache:
            return
        from cxxnet_tpu_torch.nnet import tuning
        entry = tuning.platform_entry(self.tuning_cache,
                                      tuning.platform_name(self.device))
        knobs = {k: str(v) for k, v in entry.get("knobs", {}).items()}
        explicit = self._explicit_tunables
        applied: Dict[str, Any] = {}
        v = tuning.int_knob(knobs, "steps_per_dispatch", explicit, 1)
        if v is not None:
            self.steps_per_dispatch = applied["steps_per_dispatch"] = v
        v = tuning.int_knob(knobs, "serve_max_batch", explicit, 0)
        if v is not None:
            self.serve_max_batch = applied["serve_max_batch"] = v
        if "stage_dtype" in knobs and "stage_dtype" not in explicit:
            val = knobs["stage_dtype"]
            if (val in ("", "float32", "bfloat16")
                    and not (val == "bfloat16"
                             and self.compute_dtype == torch.float32)):
                self.stage_dtype = applied["stage_dtype"] = val
        plan_applied = self._apply_layer_plan(entry.get("layers") or {})
        if plan_applied:
            applied["layers"] = plan_applied
        ladder = entry.get("serve_ladder")
        if (ladder and self.serve_ladder is None
                and "serve_bucket_ladder" not in explicit):
            try:
                rungs = sorted({int(b) for b in ladder if int(b) >= 1})
            except (TypeError, ValueError):
                rungs = []
            if rungs:
                self.serve_ladder = applied["serve_ladder"] = rungs
        if applied:
            telemetry.event("tuning", op="apply",
                            cache=self.tuning_cache, **applied)

    def _apply_layer_plan(self, plan: Dict[str, Any]) -> Dict[str, Any]:
        """Stamp a v2 cache's per-layer plan onto the layer configs:
        unknown layers, inapplicable knobs (space_to_depth off a conv,
        layer_quant off a conv / fullc), malformed values and any key
        the config names for that layer or globally are skipped. The
        stamps go into net_cfg.layercfg, which NetConfig.configure
        rebuilds from the user's pairs, so they never accumulate."""
        applied: Dict[str, Any] = {}
        valid = {"space_to_depth": ("0", "1", "auto"),
                 "layer_dtype": ("float32", "bfloat16"),
                 "layer_quant": ("int8", "float")}
        for lname, kv in plan.items():
            idx = self.net_cfg.layer_name_map.get(lname)
            if idx is None or not isinstance(kv, dict):
                continue
            info = self.net_cfg.layers[idx]
            for k, v in kv.items():
                v = str(v)
                if k not in valid or v not in valid[k]:
                    continue
                if k == "space_to_depth" and info.type_name != "conv":
                    continue
                if (k == "layer_quant"
                        and info.type_name not in ("conv", "fullc")):
                    continue
                if any(kk == k for kk, _ in
                       (self.net_cfg.defcfg
                        + self.net_cfg.layercfg[idx])):
                    continue  # explicitly configured: the user wins
                self.net_cfg.layercfg[idx].append((k, v))
                applied.setdefault(lname, {})[k] = v
        return applied

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

    def _check_zero(self, zrun: int, axes) -> None:
        """The JAX trainer's checks of a ZeRO stage >= 2 (its _compile):
        the stage composes with the data and model axes only, every
        updater must be zero_shardable, and sync-BN is refused."""
        if zrun < 2:
            return
        extra_axes = sorted({a for a, k in axes
                             if a not in ("data", "model") and k > 1})
        if extra_axes:
            raise ValueError(
                f"zero_stage={self.zero_stage} composes with "
                f"'data'/'model' mesh axes only; axes {extra_axes} "
                "drive layers that shard_map over the full mesh "
                "(ring/ulysses attention, pipelined stacks, moe), "
                "which cannot nest inside the manual-'data' ZeRO "
                "region - use zero_stage<=1 on seq/pipe/expert "
                "meshes")
        for lk, d in self.updaters.items():
            for pn, up in d.items():
                if not up.zero_shardable:
                    raise ValueError(
                        f"updater '{up.kind or type(up).__name__}' "
                        f"({lk}.{pn}) declares zero_shardable="
                        "False (its math reduces over the full "
                        "tensor, so a per-shard update computes "
                        "different results); use zero_stage<=1")
        for idx, _info in enumerate(self.net_cfg.layers):
            lay = self.net.layer_objs[idx]
            if (getattr(lay, "type_name", "") == "batch_norm"
                    and getattr(lay, "global_stats", 0)):
                raise ValueError(
                    "batch_norm global_stats=1 (sync-BN) needs "
                    "global-batch statistics, but zero_stage>=2 "
                    "runs the forward per data shard (per-shard "
                    "stats, the reference's per-GPU semantics); "
                    "use zero_stage<=1 with sync-BN")

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

    def _updater_list(self):
        """(param key, param name, updater) of every weight tensor the
        updaters own, in a fixed order."""
        master = self.state["params"]
        return [(lk, pn, up) for lk, d in self.updaters.items()
                for pn, up in d.items()
                if lk in master and pn in master[lk]]

    def _init_state(self, params: Params) -> None:
        """Fresh train state around whole `params`: zero updater state
        (or the state a loaded checkpoint carried), no accumulated
        gradient, zero train metrics; the params and state cut to this
        rank's model shard and ZeRO cut."""
        ustate = self._fresh_ustate(params)
        if self._loaded_opt is not None:
            ustate = convert.ustate_from_numpy(self._loaded_opt, ustate,
                                               self.device)
            self._loaded_opt = None
        self._install(params, ustate)
        self._accum = None
        self._count = 0
        self._weights_changed(retire=True)
        self.clear_train_metric()

    def _fresh_ustate(self, params: Params):
        """Zero updater state for whole `params`, whole: the shapes a
        full state has, before any cut."""
        return {lk: {pn: up.init_state(params[lk][pn])
                     for pn, up in d.items() if pn in params.get(lk, {})}
                for lk, d in self.updaters.items()}

    def set_train_state(self, params: Params, ustate, epoch: int) -> None:
        """Install whole params, the whole updater state and the update
        counter (the carry from a JAX train state -
        convert.train_state_from_numpy), each cut here."""
        self._install(params, ustate)
        self.epoch = int(epoch)
        self._reset_counters()
        self._weights_changed(retire=True)
        self.clear_train_metric()

    def _install(self, params: Params, ustate) -> None:
        """Plan the cuts of these whole params and keep this rank's
        part: the model shard of every param and of its state, then the
        ZeRO cut of the state (stage >= 1) and of the weights (stage
        3). The cut tensors are copies, so the whole ones are freed."""
        self._plan(params)
        mc, z = self._pcut, self._zero
        if mc is not None:
            ustate = {lk: {pn: {f: mc.local(t, lk, pn)
                                for f, t in st.items()}
                           for pn, st in d.items()}
                      for lk, d in ustate.items()}
        if z is not None:
            ustate = {lk: {pn: ({f: z.owned(t, lk, pn).clone()
                                 for f, t in st.items()}
                                if z.is_cut(lk, pn) else st)
                           for pn, st in d.items()}
                      for lk, d in ustate.items()}
        self.state = {"params": self._cut_params(params), "ustate": ustate}

    def _plan(self, params: Params) -> None:
        """The param cut (the params placed on a model, expert or pipe
        axis above 1; None when nothing is cut) and the ZeRO cut (None
        without a data axis or under zero_stage = 0) of whole params:
        the placements of parallel/sharding.py, the JAX helpers'."""
        shapes = {lk: {pn: tuple(t.shape) for pn, t in d.items()}
                  for lk, d in params.items()}
        self._pcut = self._zero = None
        self._local_shapes = shapes
        if not self._meshed:
            return
        specs = shardings_for(self.mesh, shapes, self.net)
        cut = ParamCut(self.mesh, specs, shapes)
        if cut.dims:
            self._pcut = cut
            self._local_shapes = cut.local_shapes()
        if self.zero_stage >= 1 and self._dsize > 1:
            self._zero = ZeroCut(self.mesh, zero_partition_dims(
                self.mesh, shapes, specs), self._local_shapes)

    def _local_params(self) -> Params:
        """The model-local params whole over the data axis: the stored
        params, or under zero_stage = 3 the cut weights all-gathered
        over the data group (a collective; the caller drops them after
        use)."""
        params = self.state["params"]
        z = self._zero
        if z is None or self._zero_run < 3:
            return params
        full = z.gather_full({(lk, pn): params[lk][pn]
                              for lk, pn, _, _ in z.cut})
        return {lk: {pn: full.get((lk, pn), t) for pn, t in d.items()}
                for lk, d in params.items()}

    def _whole_params(self) -> Params:
        """Every param whole on every rank (gathered over the ZeRO and
        model cuts; collectives on a mesh)."""
        params = self._local_params()
        return params if self._pcut is None else self._pcut.gather(params)

    def _full_ustate(self):
        """The whole updater state on every rank (collectives under a
        ZeRO cut or a model axis: each field of the cut weights is
        all-gathered)."""
        z = self._zero
        ustate = self.state["ustate"]
        if z is not None:
            out = {lk: {pn: dict(st) for pn, st in d.items()}
                   for lk, d in ustate.items()}
            fields = sorted({f for lk, pn, _, _ in z.cut
                             for f in ustate[lk][pn]})
            for f in fields:
                into = {}
                for lk, pn, _, _ in z.cut:
                    if f not in ustate[lk][pn]:
                        continue
                    t = ustate[lk][pn][f]
                    into[(lk, pn)] = out[lk][pn][f] = torch.empty(
                        self._local_shapes[lk][pn], dtype=t.dtype,
                        device=t.device)
                z.gather({key: ustate[key[0]][key[1]][f] for key in into},
                         into)
            ustate = out
        mc = self._pcut
        if mc is None:
            return ustate
        fields = sorted({f for d in ustate.values() for st in d.values()
                         for f in st})
        out = {lk: {pn: {} for pn in d} for lk, d in ustate.items()}
        for f in fields:
            tree = {lk: {pn: st[f] for pn, st in d.items() if f in st}
                    for lk, d in ustate.items()}
            whole = mc.gather(tree)
            for lk, d in whole.items():
                for pn, t in d.items():
                    out[lk][pn][f] = t
        return out

    def ustate_bytes(self) -> int:
        """Bytes of updater state this rank holds."""
        return sum(t.numel() * t.element_size()
                   for t in _tree_leaves(self.state["ustate"]))

    def state_bytes(self) -> Dict[str, int]:
        """Bytes this rank holds between steps: params, updater state,
        the update_period accumulator, and the gradients it kept after
        the last step's reduction (cut under zero_stage >= 2)."""
        def nbytes(tree):
            return (0 if tree is None else
                    sum(t.numel() * t.element_size()
                        for t in _tree_leaves(tree)))
        return {"params": nbytes(self.state["params"]),
                "ustate": nbytes(self.state["ustate"]),
                "accum": nbytes(self._accum), "grads": self.grad_bytes}

    def _set_params(self, params: Params) -> None:
        """Replace the params with whole `params` (updater state kept,
        or made fresh), cut to this rank's part."""
        if self.state is None:
            self._init_state(params)
        else:
            self.state["params"] = self._cut_params(params)
            self._weights_changed(retire=True)

    def _cut_params(self, params: Params) -> Params:
        """Whole params -> what this rank stores: its model shard, and
        under zero_stage = 3 the ZeRO cut of the cut weights."""
        mc, z = self._pcut, self._zero
        if mc is not None:
            params = mc.local_tree(params)
        if z is not None and self._zero_run >= 3:
            params = {lk: {pn: (z.owned(t, lk, pn).clone()
                                if z.is_cut(lk, pn) else t)
                           for pn, t in d.items()}
                      for lk, d in params.items()}
        return params

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
        once per weight change) under bfloat16. Under zero_stage = 3
        the cut weights are all-gathered for each call and not kept."""
        if self._zero is not None and self._zero_run >= 3:
            return self._cast(self._local_params())
        cp = self._cparams
        if cp is None:
            cp = self._cast(self.state["params"])
            self._cparams = cp
        return cp

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _pad_extras(self, batch: DataBatch) -> List[np.ndarray]:
        """The float32 arrays feeding the extra input nodes
        1..extra_data_num, zero-padded up to batch_size; a batch that
        carries fewer raises (the JAX trainer's check and message)."""
        n_extra = self.net_cfg.extra_data_num
        extras = [np.asarray(e, np.float32)
                  for e in batch.extra_data[:n_extra]]
        if len(extras) < n_extra:
            raise ValueError(
                f"net declares extra_data_num={n_extra} but the batch "
                f"carries {len(extras)} extra arrays (use attachtxt or "
                "fill DataBatch.extra_data)")
        pad = self._local_batch - batch.batch_size
        if pad > 0:
            extras = [np.concatenate(
                [e, np.zeros((pad,) + e.shape[1:], np.float32)])
                for e in extras]
        return extras

    def _pad_batch(self, batch: DataBatch, train: bool):
        """(data, label, mask) padded up to batch_size (numpy).

        `train`: every DELIVERED row is valid - num_batch_padd marks
        round_batch wrap-fill rows, real instances the reference trains
        and trims only from eval/pred (nnet_impl-inl.hpp:239); eval
        masks them. Rows padded up to batch_size are always masked. A
        sparse CSR batch (data.h:96-181) is densified to the net's
        input shape first, as in the JAX trainer."""
        batch = batch.densified(self.net_cfg.input_shape)
        b = batch.batch_size
        if b > self._local_batch:
            raise ValueError("batch larger than configured batch_size")
        label = (np.zeros((b, 1), np.float32) if batch.label is None
                 else np.asarray(batch.label, np.float32).reshape(b, -1))
        valid = np.ones(b, np.float32)
        if not train and batch.num_batch_padd:
            valid[b - batch.num_batch_padd:] = 0.0
        pad = self._local_batch - b
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
        extras = self._pad_extras(batch)
        data, label, valid = self._pad_batch(batch, train)
        ready = None
        if ring is None:
            gdata = self.stage_infer_rows(data)
            lab, mask = (torch.from_numpy(a).to(self.device)
                         for a in (label, valid))
            gextras = self.stage_extras(extras)
        else:
            data = self._host_rows(data)
            slot = ring.acquire()
            host = [slot.fill(i, a, dt) for i, (a, dt) in enumerate((
                (data, self._staged_dtype(data)), (label, torch.float32),
                (valid, torch.float32),
                *((e, torch.float32) for e in extras)))]
            with torch.cuda.stream(ring.stream):
                gdata, lab, mask, *gextras = (
                    h.to(self.device, non_blocking=True) for h in host)
                gdata = self._on_device(gdata)
                gextras = tuple(self._cast(e) for e in gextras)
            ready = slot.release()
        fields = {}
        for fname, idx in self.net_cfg.label_name_map.items():
            a, b = self.net_cfg.label_range[idx]
            fields[fname] = lab[:, a:b]
        return StagedBatch(gdata, fields, mask, ready, gextras,
                           batch.batch_size - batch.num_batch_padd)

    def stage_batch(self, batch: DataBatch, ring=None) -> StagedBatch:
        """Stage a training batch (see _stage) for update(). The staging
        is the streamed step's own, so a staged update is
        trajectory-identical to a streamed one. Fault point
        `stage_batch`: `delay` stalls the staging (the watchdog's stall),
        `corrupt` NaN-poisons the batch (the divergence guard must drop
        the step)."""
        if fault.fault_point("stage_batch") == "corrupt":
            batch = DataBatch(
                data=np.full(np.shape(batch.densified(
                    self.net_cfg.input_shape).data), np.nan, np.float32),
                label=batch.label, inst_index=batch.inst_index,
                num_batch_padd=batch.num_batch_padd,
                extra_data=batch.extra_data)
        return self._stage(batch, train=True, ring=ring)

    def stage_chunk(self, batches: Sequence, ring=None) -> StagedChunk:
        """Stack K batches into one fused chunk (StagedChunk): each
        DataBatch runs the per-batch staging (stage_batch, through
        `ring` when a prefetcher's worker calls), then a device-side
        stack prepends the microstep axis - on the ring's side stream,
        whose event is the chunk's `ready`, or on the current stream.
        DataBatch and StagedBatch may be mixed; K is len(batches) (a
        short last chunk at a round's end is fine)."""
        if not batches:
            raise ValueError("stage_chunk needs at least one batch")
        staged = [b if isinstance(b, StagedBatch) else
                  self._stage(b, train=True, ring=ring) for b in batches]
        ctx = (torch.cuda.stream(ring.stream) if ring is not None
               else contextlib.nullcontext())
        with ctx:
            for b in staged:
                self._await(b)
            data = torch.stack([b.data for b in staged])
            labels = {f: torch.stack([b.labels[f] for b in staged])
                      for f in staged[0].labels}
            mask = torch.stack([b.mask for b in staged])
            extras = tuple(torch.stack([b.extras[i] for b in staged])
                           for i in range(len(staged[0].extras)))
            ready = None
            if ring is not None:
                ready = torch.cuda.Event()
                ready.record(ring.stream)
        return StagedChunk(data, labels, mask,
                           tuple(b.n_examples for b in staged), ready,
                           extras)

    def prefetch(self, data_iter, depth: int = 1, chunk: int = 1):
        """Wrap a DataIter so batch k+1 is staged on a worker thread
        while step k runs (io/prefetch.py); update() consumes the staged
        values. chunk = K assembles fused chunks (stage_chunk) on the
        worker instead - the staging half of steps_per_dispatch = K;
        device memory then holds K * (depth + 1) batches."""
        from cxxnet_tpu_torch.io.prefetch import StagedPrefetcher
        return StagedPrefetcher(self.stage_batch, data_iter, depth,
                                device=self.device, chunk=chunk,
                                chunk_fn=self.stage_chunk)

    def _await(self, staged) -> None:
        """A batch or chunk staged on a side stream: make the current
        stream wait for its copies and keep its memory from being reused
        before the step that reads it is done."""
        if staged.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.ready)
        for t in (staged.data, staged.mask, *staged.labels.values(),
                  *staged.extras):
            t.record_stream(stream)

    def _sync(self) -> None:
        """Wait for the card (honest step times under profile = 1 or
        telemetry_steps); nothing to wait for on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
                       nbytes: int, donated: int = 0, bucket=None,
                       fields=None):
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
        fl = (tel.flight.start(kind, fp=fp,
                               bucket=shape[0] if bucket is None else bucket,
                               nbytes=int(nbytes), fields=fields)
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
    # graftlint: hot-path
    def update(self, batch,
               keep: Optional[Dict[int, Any]] = None) -> torch.Tensor:
        """One training mini-batch (CXXNetThreadTrainer::Update): a
        DataBatch (streamed) or a StagedBatch (stage_batch, or a
        prefetcher's value); a StagedChunk goes to update_chunk. `keep`
        injects the random draws ({layer index: array of the layer's
        input shape}: dropout's boolean mask, the uniform float32 draw
        of insanity, prelu's noise and insanity_max_pooling) instead of
        drawing them. Returns the scaled loss (a device scalar; reading
        it syncs)."""
        if isinstance(batch, StagedChunk):
            if keep is not None:
                raise ValueError("keep injects the draws of one update; "
                                 "a chunk takes none")
            return self.update_chunk(batch)
        track = bool(self.profile) or self._tel_steps
        t0 = time.perf_counter()
        if not isinstance(batch, StagedBatch):
            # the streamed path IS one stage_batch call - structural
            # guarantee of the staged/streamed trajectory equivalence;
            # a rejected batch raises before the step counter moves
            batch = self.stage_batch(batch)
        self._await(batch)
        if keep is not None:
            # graftlint: disable=GL002 injected draws are host arrays going TO the device, not a readback
            keep = {i: torch.from_numpy(np.asarray(k)).to(self.device)
                    for i, k in keep.items()}
        step = self._step_counter
        self._step_counter += 1
        data_s = 0.0
        if track:
            t1 = time.perf_counter()
            data_s = t1 - t0
            if self.profiler is not None:
                self.profiler.add_data(data_s)
            t0 = t1
        # collective-scope fault point (the elastic pod's proofs): the
        # step carries the job's gradient all-reduce, so kill_rank /
        # hang_rank / delay_collective armed here murder or wedge one
        # worker at a deterministic step - every rank hits this point
        # in the same order, so @N names the same step on every worker
        fault.fault_point("collective")
        data = batch.data
        # the master params are updated in place: the port's form of
        # the JAX step's donated state
        with self._flight_record(
                ("train_step", tuple(data.shape)), kind="train",
                name=f"train_step@b{data.shape[0]}", shape=data.shape,
                nbytes=data.numel() * data.element_size(), donated=1):
            losses, fin = self._microsteps([batch], step, keep)
        self._walk_guard(fin, step)
        # progress beacon for the hang watchdog / absence alert rules
        telemetry.beacon("train.step")
        loss = losses[0]
        if track:
            self._sync()
            step_s = time.perf_counter() - t0
            if self.profiler is not None:
                self.profiler.add_step(step_s, batch.n_examples)
            if self._tel_steps:
                loss_val = float(loss)
                tel = telemetry.get()
                tel.observe("train.data_s", data_s)
                tel.observe("train.step_s", step_s)
                tel.inc("train.images", batch.n_examples)
                tel.set_gauge("train.loss", loss_val)
                tel.event("span", name="train.data", secs=data_s,
                          round=self.round, step=step)
                tel.event("span", name="train.step", secs=step_s,
                          round=self.round, step=step, loss=loss_val,
                          examples=batch.n_examples)
        return loss

    # graftlint: hot-path
    def update_chunk(self, chunk) -> torch.Tensor:
        """K training microsteps as one fused update (steps_per_dispatch
        = K): a StagedChunk, or a sequence of DataBatch / StagedBatch
        (staged and stacked here). Each microstep is the streamed
        step - its random draws from (seed + 100, step, layer), its
        update_period accumulation, its metric rows - run eagerly one
        after the other with no host read between them, so the K
        microsteps train exactly as K update() calls. Under check_nan =
        1 the counters live on the device (_DeviceCounters), a
        non-finite microstep is rolled back by a select in place, and
        the guard reads ONE finite vector a chunk, then walks it in
        order: drop counts and DivergenceError match streaming, except
        that the error surfaces at the chunk's end, up to K - 1
        microsteps after the fatal one. Returns the (K,) scaled losses
        (a device tensor)."""
        track = bool(self.profile) or self._tel_steps
        t0 = time.perf_counter()
        if not isinstance(chunk, StagedChunk):
            # staging validates; a rejected batch raises before the
            # step counter moves (the contract of update())
            chunk = self.stage_chunk(chunk)
        self._await(chunk)
        k = chunk.n_steps
        first = self._step_counter
        self._step_counter += k
        data_s = 0.0
        if track:
            t1 = time.perf_counter()
            data_s = t1 - t0
            if self.profiler is not None:
                self.profiler.add_data(data_s)
            t0 = t1
        # the same collective-scope fault point as update()'s: one hit
        # a dispatch (K microsteps), still rank-deterministic
        fault.fault_point("collective")
        data = chunk.data
        with self._flight_record(
                ("train_chunk", k, tuple(data.shape)), kind="train",
                name=f"train_chunk@K{k}b{data.shape[1]}", shape=data.shape,
                nbytes=data.numel() * data.element_size(), donated=1,
                bucket=data.shape[1], fields={"steps": k}):
            losses, fin = self._microsteps(
                [chunk.micro(i) for i in range(k)], first, None)
        self._walk_guard(fin, first)
        telemetry.beacon("train.step", k)
        losses = torch.stack(losses)
        if track:
            self._sync()
            chunk_s = time.perf_counter() - t0
            n_examples = sum(chunk.n_examples)
            if self.profiler is not None:
                self.profiler.add_chunk(chunk_s, k, n_examples)
            if self._tel_steps:
                tel = telemetry.get()
                # graftlint: disable=GL002 per-chunk loss readback, gated by telemetry_steps=1
                loss_v = losses.double().cpu().numpy()
                for _ in range(k):
                    # per-step amortised times keep the histograms on a
                    # per-step scale across steps_per_dispatch settings
                    tel.observe("train.step_s", chunk_s / k)
                    tel.observe("train.data_s", data_s / k)
                tel.inc("train.images", n_examples)
                tel.set_gauge("train.loss", float(loss_v[-1]))
                tel.event("span", name="train.data", secs=data_s,
                          round=self.round, step=first)
                tel.event("span", name="train.chunk", secs=chunk_s,
                          round=self.round, step=first, steps=k,
                          loss=[float(v) for v in loss_v],
                          examples=n_examples)
        return losses

    # graftlint: hot-path
    def _microsteps(self, batches: List[StagedBatch], first: int, keep):
        """Run staged microsteps `first`, `first` + 1, ...; returns
        (their losses, the finite flags read back as a numpy bool array
        under check_nan = 1, else None)."""
        if not self.check_nan:
            return [self._micro(b, first + i, keep, None)
                    for i, b in enumerate(batches)], None
        dc = _DeviceCounters(self, len(batches))
        losses = [self._micro(b, first + i, keep, dc)
                  for i, b in enumerate(batches)]
        # the guard's one readback (the sync check_nan = 1 costs)
        # graftlint: disable=GL002 ONE guard readback per update or K-step chunk - the fused dispatch's whole point
        fin = torch.stack(dc.finite).cpu().numpy()
        self.guard_readbacks += 1
        return losses, fin

    # graftlint: hot-path
    def _micro(self, batch: StagedBatch, step: int, keep,
               dc: Optional[_DeviceCounters]) -> torch.Tensor:
        """One microstep: forward, backward, accumulate, update every
        update_period steps, train metrics. Without a _DeviceCounters
        the counters are the host's and the update lands in place. With
        one (check_nan = 1) the counters are the device's: the update
        is computed out of place and committed by a select on the
        step's finite flag (loss, updated params and, update_period >
        1, the gradient accumulator all finite), which leaves params,
        updater state, accumulator, counters and train metrics as they
        were for a non-finite step - in place, the tensors keep their
        storage. Under zero_stage = 3 the cut weights are all-gathered
        for the forward and the whole copies dropped after the backward."""
        leaves = _tree_map(lambda t: t.detach().requires_grad_(True),
                           self._local_params())
        seed = self.seed + 100
        dev = self.device
        period = self.update_period

        def gens(idx: int) -> torch.Generator:
            return torch.Generator(device=dev).manual_seed(
                stream_seed(seed, step, idx))

        data = self._model_input(batch.data, train=True, step=step)
        labels, mask = batch.labels, batch.mask
        # the update counter a progress-following layer reads (insanity's
        # anneal), as the JAX train step binds it
        progress = (self.epoch * period + self._count if dc is None
                    else dc.epoch * period + dc.count)
        mesh = self.mesh if self._dsize * self._nseq > 1 else None
        # the backward (and a remat recompute) runs inside the mesh too:
        # sync-BN and fullc_gather call collectives in both passes
        with torch.enable_grad(), active_step(progress), self._mesh_scope():
            # cast inside autograd: bfloat16 compute, float32 gradients
            cparams = self._cast(leaves)
            values, total = self.net(
                cparams, data, extras=batch.extras, train=True, gens=gens,
                keep=keep, labels=labels, mask=mask,
                remat_segments=self._remat_segments,
                keep_nodes=[nid for _, nid in self.eval_nodes])
            # under a seq axis every seq rank of a data index computes
            # the loss of the same rows: 1 / nseq of it each, so the
            # gradient sum over data x seq counts it once
            loss = total.float() * (1.0 / (self.batch_size * period
                                           * self._nseq))
            flat = _tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(torch.zeros_like(t) if g is None else g
                  for t, g in zip(flat, grads))
        gtree = {lk: {pn: next(it) for pn in sorted(leaves[lk])}
                 for lk in sorted(leaves)}
        rows = None
        if self.eval_train and len(self.train_metric):
            with torch.no_grad(), self._mesh_scope():
                rows = self._metric_rows(self.train_metric, values, labels,
                                         mask, seed, step, 1000)
                if self._nseq > 1 and self.mesh.seq_rank:
                    # the seq ranks of a data index hold the same rows:
                    # the sum over data x seq counts seq rank 0's
                    rows = torch.zeros_like(rows)
        loss = loss.detach()
        if self._zero_run >= 3:
            # stage 3 keeps only its cut between steps: drop the
            # gathered whole weights (and their cast) before the update
            del leaves, flat, grads, cparams
        if mesh is not None:
            loss, rows, gtree = self._reduce_step(loss, gtree, rows)
        self.grad_bytes = sum(t.numel() * t.element_size()
                              for t in _tree_leaves(gtree))
        if dc is None:
            self._commit(gtree, rows)
        else:
            self._commit_guarded(loss, gtree, rows, dc)
        return loss

    @torch.no_grad()
    def _reduce_step(self, loss, gtree, rows):
        """Sum this microstep's loss, gradients (all but the
        fullc_gather weights', full on every rank already) and
        train-metric rows over the gradient group (the data group, or
        data x seq under a seq axis) in one all-reduce, in place; under
        zero_stage >= 2 the cut weights' gradients instead travel by one
        reduce-scatter over the data group, which leaves this rank its
        slice of each sum. Returns the global (loss, rows) and the
        gradients (cut where they were reduce-scattered)."""
        z = self._zero if self._zero_run >= 2 else None
        if z is not None:
            gtree = {lk: dict(d) for lk, d in gtree.items()}
            cut = [(lk, pn) for lk, pn, _, _ in z.cut]
            for lk, pn in cut:
                if (lk, pn) in self._gathered:
                    gtree[lk][pn] = z.owned(gtree[lk][pn], lk, pn).clone()
            mine = z.reduce_scatter({
                key: gtree[key[0]][key[1]] for key in cut
                if key not in self._gathered})
            for (lk, pn), g in mine.items():
                gtree[lk][pn] = g
        keys = [(lk, pn) for lk in sorted(gtree) for pn in sorted(gtree[lk])
                if (lk, pn) not in self._gathered
                and not (z is not None and z.is_cut(lk, pn))]
        parts = [loss.reshape(1)] + [gtree[lk][pn].reshape(-1)
                                     for lk, pn in keys]
        if rows is not None:
            parts.append(rows.reshape(-1))
        flat = torch.cat(parts)
        distributed.all_reduce_(flat, self.mesh.grad_group)
        if self._nseq > 1:
            # a fullc_gather weight's gradient is whole on every rank,
            # from the 1 / nseq-scaled loss of its seq rank
            for lk, pn in self._gathered:
                gtree[lk][pn].mul_(self._nseq)
        off = 1
        for lk, pn in keys:
            g = gtree[lk][pn]
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()
        if rows is not None:
            rows = flat[off:].view(rows.shape)
        return flat[0], rows, gtree

    def _zero_views(self, master, accum, lk: str, pn: str):
        """(weight, gradient) an updater steps for weight (lk, pn): the
        whole tensors, or for a ZeRO-cut weight this rank's slices -
        the stored weight itself under stage 3, the gradient itself
        under stage >= 2."""
        z = self._zero
        w, g = master[lk][pn], accum[lk][pn]
        if z is None or not z.is_cut(lk, pn):
            return w, g
        return (w if self._zero_run >= 3 else z.owned(w, lk, pn),
                g if self._zero_run >= 2 else z.owned(g, lk, pn))

    def _apply_updates(self, accum) -> None:
        """Every updater on its weight, in place; under ZeRO a cut
        weight's updater runs on this rank's slice and (stages 1-2) one
        all-gather returns the fresh weights."""
        master, ustate = self.state["params"], self.state["ustate"]
        z = self._zero
        for lk, pn, up in self._updater_list():
            w, g = self._zero_views(master, accum, lk, pn)
            up.apply(ustate[lk][pn], w, g, self.epoch)
        if z is not None and self._zero_run < 3:
            z.gather({(lk, pn): z.owned(master[lk][pn], lk, pn)
                      for lk, pn, _, _ in z.cut},
                     {(lk, pn): master[lk][pn] for lk, pn, _, _ in z.cut})

    def _commit(self, gtree, rows) -> None:
        """Accumulate and update in place on the host's counters."""
        if self.update_period == 1:
            accum = gtree
        elif self._count == 0:
            accum = self._accum = gtree
        else:
            for lk, d in gtree.items():
                for pn, g in d.items():
                    self._accum[lk][pn].add_(g)
            accum = self._accum
        self._count += 1
        if self._count >= self.update_period:
            self._apply_updates(accum)
            self._accum = None
            self._count = 0
            self.epoch += 1
            self._weights_changed()
        if rows is not None:
            self._tmetric.copy_(self._tmetric_add(rows))

    @torch.no_grad()
    def _commit_guarded(self, loss, gtree, rows,
                        dc: _DeviceCounters) -> None:
        """Accumulate and update on the device's counters, committed by
        a select on the step's finite flag (see _micro)."""
        master, ustate = self.state["params"], self.state["ustate"]
        period = self.update_period
        ok = torch.isfinite(loss)
        do = None
        if period == 1:
            accum = gtree
        else:
            if self._accum is None:
                # graftlint: disable=GL007 gtree is the reduced tree, cut by _reduce_step's reduce_scatter under zero_stage >= 2: each leaf is whole only where its gradient is
                self._accum = _tree_map(torch.zeros_like, gtree)
            fresh = dc.count == 0
            accum = {lk: {pn: torch.where(fresh, g, self._accum[lk][pn] + g)
                          for pn, g in d.items()}
                     for lk, d in gtree.items()}
            do = dc.count + 1 >= period
            # the accumulator is checked while it carries over (after
            # an update it starts afresh)
            for t in _tree_leaves(accum):
                ok = ok & (do | torch.isfinite(t).all())
        sched = dc.sched()
        new = []
        z = self._zero
        cut_new = {}
        for i, (lk, pn, up) in enumerate(self._updater_list()):
            w = master[lk][pn]
            wv, gv = self._zero_views(master, accum, lk, pn)
            w_new, st = up.step(ustate[lk][pn], wv, gv,
                                (sched[i, 0], sched[i, 1]))
            if wv is not w:
                # this rank's slice; the all-gather below makes it whole
                cut_new[(lk, pn)] = w_new
                # graftlint: disable=GL007 the all-gather below fills it: zero_stage 1-2 keep the weights whole (stage 3 steps the stored slice and never gets here)
                w_new = torch.empty_like(w)
            new.append((w, w_new, ustate[lk][pn], st))
        if cut_new:
            z.gather(cut_new, {(lk, pn): new[i][1] for i, (lk, pn, _)
                               in enumerate(self._updater_list())
                               if (lk, pn) in cut_new})
        for w, w_new, _, _ in new:
            fin = torch.isfinite(w_new).all()
            ok = ok & (fin if do is None else (~do | fin))
        if self.mesh is not None and (
                self._pcut is not None
                or (z is not None and self._zero_run >= 2)):
            # each rank saw only its cut of the weights (and of the
            # accumulator): the step is kept only where it is finite on
            # every rank
            bad = (~ok).to(torch.float32).reshape(1)
            distributed.all_reduce_(bad, None, op="max")
            ok = bad[0] == 0
        take = ok if do is None else ok & do
        for w, w_new, st_old, st in new:
            w.copy_(torch.where(take, w_new, w))
            for name, t in st.items():
                st_old[name].copy_(torch.where(take, t, st_old[name]))
        if do is not None:
            for lk, d in accum.items():
                for pn, t in d.items():
                    buf = self._accum[lk][pn]
                    buf.copy_(torch.where(ok, t, buf))
            dc.count = torch.where(ok, torch.where(do, 0, dc.count + 1),
                                   dc.count)
        dc.epoch = torch.where(take, dc.epoch + 1, dc.epoch)
        if rows is not None:
            self._tmetric.copy_(torch.where(ok, self._tmetric_add(rows),
                                            self._tmetric))
        dc.finite.append(ok)

    def _tmetric_add(self, rows: torch.Tensor) -> torch.Tensor:
        """The train-metric accumulator after one step's (sum, count)
        rows: a Kahan-compensated float32 sum in column 0 (its
        compensation in 1) and the count in 2, as the JAX train step
        keeps it - no float64 on the device."""
        t = self._tmetric
        s, comp, cnt = t[:, 0], t[:, 1], t[:, 2]
        y = rows[:, 0] - comp
        tot = s + y
        return torch.stack([tot, (tot - s) - y, cnt + rows[:, 1]], dim=1)

    def _walk_guard(self, fin, first: int) -> None:
        """After guarded microsteps: move the host's counters as the
        device's moved (a dropped microstep moves neither), then walk
        the flags in order through _guard_step."""
        if fin is None:
            return
        for ok in fin:
            if ok:
                self._count += 1
                if self._count >= self.update_period:
                    self._count = 0
                    self.epoch += 1
        self._weights_changed()
        for i, ok in enumerate(fin):
            self._guard_step(bool(ok), first + i)

    def _guard_step(self, ok: bool, step_idx: int) -> None:
        """Host half of the divergence guard: count a dropped step (the
        device already rolled it back) and abort after max_bad_rounds
        CONSECUTIVE such steps."""
        if ok:
            self._bad_consec = 0
            return
        self._bad_consec += 1
        self.bad_rounds += 1
        self._skipped_steps += 1
        telemetry.inc("fault.nan_rollback")
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

    # ------------------------------------------------------------------
    # rounds and the step profiler (utils/profiler.py)
    # ------------------------------------------------------------------
    def start_round(self, round_counter: int) -> None:
        """Close out and report the previous round's profile, then arm
        the next (the trace_round-th profiled round also writes the
        trace). The stderr summary is profile = 1 only; a
        telemetry-only profiler feeds round records silently."""
        self.round = round_counter
        if self.profiler is not None:
            if self.profile and self.profiler.step_s:
                sys.stderr.write(self.profiler.summary() + "\n")
            self.profiler.round_end()
            self.profiler.round_start()

    def finish_round_profile(self) -> None:
        """Close the round's trace right after the update loop, so it
        holds the training steps only, not the evaluation or the
        checkpoint save that follow (round_end is idempotent;
        start_round still prints the summary)."""
        if self.profiler is not None:
            self.profiler.round_end()

    def profile_summary(self) -> str:
        """The summary line of the round in progress ('' when profiling
        is off or no steps ran); closes any open trace either way."""
        if self.profiler is None:
            return ""
        self.profiler.round_end()
        if not self.profile or not self.profiler.step_s:
            return ""
        return self.profiler.summary()

    def round_stats(self) -> Optional[Dict[str, float]]:
        """Step / data timing stats of the round in progress (None when
        nothing is instrumented or no steps ran): the payload of the
        telemetry `round` event and metrics record."""
        if self.profiler is None:
            return None
        return self.profiler.stats()

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
            rows.append(self.eval_rows(staged, params, step))
            telemetry.beacon("eval.step")
            step += 1
        if not rows:
            vals = np.zeros((len(specs), 2))
        else:
            # float32 rows read back once; the cross-batch sum in
            # float64 on the host, as the JAX trainer reduces them
            vals = torch.stack(rows).cpu().numpy().astype(np.float64).sum(0)
        if self._dsize > 1:
            # every rank evaluated its shard: the sums over the ranks
            vals = distributed.host_sum(vals, self.mesh.group)
        return format_metrics(data_name, specs, vals)

    def eval_rows(self, staged: StagedBatch, params: Params,
                  step: int = 0) -> torch.Tensor:
        """One evaluation batch's (n_metrics, 2) float32 metric rows on
        the device - evaluate's per-batch step: the forward of a batch
        staged for evaluation (`_stage(batch, train=False)`) with
        compute params (compute_params()), then the metric rows, the
        tie-breaks drawn from stream (seed + 200, step, 2000 + i)."""
        gdata = staged.data
        with self._flight_record(
                ("eval_step", tuple(gdata.shape)), kind="eval",
                name=f"eval_step@b{gdata.shape[0]}",
                shape=gdata.shape,
                nbytes=gdata.numel() * gdata.element_size()), \
                torch.inference_mode(), self._mesh_scope():
            values = self.net(params, self._model_input(gdata),
                              extras=staged.extras,
                              keep_nodes=[nid for _, nid in
                                          self.eval_nodes])[0]
            return self._metric_rows(self.metric, values, staged.labels,
                                     staged.mask, self.seed + 200, step,
                                     2000)

    def eval_train_metric(self) -> str:
        """The round's train metrics (`\\ttrain-metric:value...`), then
        the accumulator is cleared."""
        if not len(self.train_metric) or self._tmetric is None:
            return ""
        acc = self._tmetric.cpu().numpy()
        # resolve the Kahan pair: true sum ~= sum - comp
        vals = np.stack([acc[:, 0] - acc[:, 1], acc[:, 2]], axis=1)
        out = format_metrics("train", self.train_metric.specs, vals)
        self.clear_train_metric()
        return out

    def clear_train_metric(self) -> None:
        self._tmetric = torch.zeros((len(self.train_metric), 3),
                                    dtype=torch.float32, device=self.device)

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

        def fn(params: Params, data: torch.Tensor,
               extras: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
            return net(params, self._model_input(data), extras=extras,
                       keep_nodes=[node])[0][node].float()
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

    def stage_extras(self, extras) -> Tuple[torch.Tensor, ...]:
        """Host arrays of the extra input nodes (row-aligned with the
        data) -> device tensors: crossed in float32 and cast on the
        device as the JAX package's `_cast` casts them."""
        return tuple(self._cast(torch.from_numpy(np.ascontiguousarray(
            e, dtype=np.float32)).to(self.device)) for e in extras)

    @staticmethod
    def _host_rows(data) -> np.ndarray:
        """Contiguous host rows as they are staged: uint8 or float32 as
        given, any other dtype as float32."""
        data = np.asarray(data)
        return np.ascontiguousarray(
            data, None if data.dtype in (np.uint8, np.float32)
            else np.float32)

    def infer_rows(self, gdata: torch.Tensor, node: int = -1,
                   extras: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        """Run the inference forward on staged rows (and staged extra
        inputs, stage_extras); node=-1 is the final node."""
        if node < 0:
            node = self.net_cfg.num_nodes - 1
        with torch.inference_mode(), self._mesh_scope():
            return self.infer_graph(node)(gdata, extras)

    def _stage_padded(self, batch: DataBatch):
        """(staged data, row mask, staged extras) of a batch zero-padded
        up to batch_size, as the JAX package pads every inference batch;
        the mask is 0 on padding rows and on the iterator's
        num_batch_padd rows."""
        extras = self._pad_extras(batch)
        data, _label, valid = self._pad_batch(batch, train=False)
        return (self.stage_infer_rows(data),
                torch.from_numpy(valid).to(self.device),
                self.stage_extras(extras))

    def _infer_node(self, batch: DataBatch, node: int) -> np.ndarray:
        """One node's float32 rows for a batch: padded to batch_size,
        calibrated first if a graph pass still needs its statistics (the
        first inference batch is the calibration batch), run, padding
        rows (and num_batch_padd) trimmed."""
        gdata, gmask, gextras = self._stage_padded(batch)
        if self.passes_need_calibration():
            self._calibrate_staged(gdata, gmask, gextras)
        valid = batch.batch_size - batch.num_batch_padd
        with self._flight_record(
                ("infer", node, self._fold_epoch, tuple(gdata.shape)),
                kind="infer", name=f"infer:n{node}@b{gdata.shape[0]}",
                shape=gdata.shape,
                nbytes=gdata.numel() * gdata.element_size()):
            out = self.infer_rows(gdata, node, gextras)[:valid].cpu().numpy()
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

    def _calibration_taps(self, gdata: torch.Tensor, gextras=()):
        """One forward of the untransformed net with the fold sites'
        batch_norm inputs and the quant sites' inputs tapped."""
        sites = self._fold_sites if self._needs_fold_stats() else []
        qsites = self._quant_sites if self._needs_quant_stats() else []
        taps: Dict[int, Any] = {j: None for _i, j in sites}
        taps.update({q: None for q in qsites})
        if sites and self._dsize > 1:
            telemetry.stderr(
                "graph_passes: fold_conv_bn calibrating GLOBAL batch "
                "statistics on a data-sharded mesh; the unfolded BN "
                "uses per-shard stats, so folded outputs are not "
                "ULP-comparable to unfolded ones here "
                "(docs/GRAPH_PASSES.md)\n",
                event_kind="graph_passes", op="calibrate_sharded",
                data_axis=self._dsize)
        with torch.inference_mode(), self._mesh_scope():
            self.net(self.compute_params(), self._model_input(gdata),
                     extras=gextras, taps=taps)
        return sites, qsites, taps

    def _site_moments(self, xf: torch.Tensor, axes, m=None):
        """Per-channel (mean, var) of a tapped float32 activation over
        its rows, weighted by the row mask `m` where one is given. On a
        data mesh they are the global batch's, as the JAX package takes
        them over its globally sharded batch: the sums over the ranks,
        in two passes as sync-BN."""
        if self._dsize == 1:
            if m is None:
                mean = xf.mean(dim=axes, keepdim=True)
                return mean, ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
            denom = m.sum(dim=axes, keepdim=True)
            mean = (xf * m).sum(dim=axes, keepdim=True) / denom
            return mean, (m * (xf - mean) ** 2).sum(dim=axes,
                                                    keepdim=True) / denom
        w = torch.ones_like(xf) if m is None else m

        def total(t):
            return distributed.all_reduce_(t.sum(dim=axes, keepdim=True),
                                           self.mesh.group)
        denom = total(w)
        mean = total(xf * w) / denom
        return mean, total(w * (xf - mean) ** 2) / denom

    def _site_absmax(self, x: torch.Tensor, mask: torch.Tensor) -> float:
        """_masked_absmax over this rank's rows, or on a data mesh over
        the global batch's (the largest over the ranks)."""
        v = _masked_absmax(x, mask)
        if self._dsize > 1:
            v = float(distributed.all_reduce_(
                torch.tensor([v], dtype=torch.float32, device=x.device),
                self.mesh.group, op="max")[0])
        return v

    def _calibrate_staged(self, gdata: torch.Tensor, gmask: torch.Tensor,
                          gextras=()) -> bool:
        """Calibration on staged rows: each fold site's batch_norm input
        moments with the layer's own arithmetic (float32, rsqrt(var +
        eps)) - deliberately UNmasked, since on the single-batch path
        the calibration batch is the inference batch, padding included,
        and the unfolded batch_norm normalizes over all of it - and each
        quant site's input absmax over the valid rows only."""
        if not self.passes_need_calibration():
            return False
        sites, qsites, taps = self._calibration_taps(gdata, gextras)
        if sites:
            stats = {}
            for _i, j in sites:
                lay = self.net.layer_objs[j]
                xf = taps[j].float()
                axes, _ = lay._axes(xf.shape)
                mean, var = self._site_moments(xf, axes)
                rstd = torch.rsqrt(var + lay.eps)
                stats[param_key(self.net_cfg, j)] = (
                    mean.reshape(-1).cpu().numpy(),
                    rstd.reshape(-1).cpu().numpy())
            self._fold_stats = stats
        if qsites:
            self._quant_stats = {
                param_key(self.net_cfg, q): self._site_absmax(taps[q], gmask)
                for q in qsites}
        self._fold_epoch += 1
        self._evict_stale_infer_caches()
        telemetry.event("graph_passes", op="calibrate",
                        sites=sorted(self._fold_stats or {}),
                        quant_sites=sorted(self._quant_stats or {}))
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
            gdata, gmask, gextras = self._stage_padded(b)
            sites, qsites, taps = self._calibration_taps(gdata, gextras)
            res = {}
            for _i, j in sites:
                lay = self.net.layer_objs[j]
                xf = taps[j].float()
                axes, _ = lay._axes(xf.shape)
                m = gmask.float().reshape(
                    (-1,) + (1,) * (xf.dim() - 1)).expand(xf.shape)
                mean, var = self._site_moments(xf, axes, m)
                res[param_key(self.net_cfg, j)] = (
                    mean.reshape(-1).cpu().numpy(),
                    var.reshape(-1).cpu().numpy())
            per_batch.append(res)
            q_batch.append({param_key(self.net_cfg, q):
                            self._site_absmax(taps[q], gmask)
                            for q in qsites})
            valid = gmask.float().sum().reshape(1)
            if self._dsize > 1:
                distributed.all_reduce_(valid, self.mesh.group)
            weights.append(float(valid[0]))
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
        telemetry.event("graph_passes", op="calibrate",
                        sites=sorted(self._fold_stats or {}),
                        quant_sites=sorted(self._quant_stats or {}),
                        batches=len(batches))
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

    def extract_feature(self, batch: DataBatch,
                        node_name: str) -> np.ndarray:
        """Any node's float32 rows, by name or `top[-k]`
        (nnet_impl-inl.hpp:200-223), in the node's own shape."""
        return self._infer_node(batch, self.net.node_index(node_name))

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _host_params(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Every param whole, as numpy (gathered over the model and ZeRO
        cuts: every rank calls this together)."""
        return convert.params_to_numpy(self._whole_params(),
                                       self.net.param_shapes())

    def save_model(self, fo) -> None:
        """The JAX package's checkpoint format (the updater state rides
        along under `save_optimizer = 1`), or the reference binary
        under `model_format = cxxnet` (no updater state, as in the
        reference)."""
        params = self._host_params()
        if self.model_format == "cxxnet":
            legacy_format.save_legacy_model(fo, self.net_cfg, self.net,
                                            params, self.epoch)
            return
        opt = (convert.ustate_to_numpy(self._full_ustate())
               if self.save_optimizer else None)
        checkpoint.save_model(fo, 0, self.net_cfg.to_dict(), self.epoch,
                              params, opt)

    @staticmethod
    def _is_native(fi) -> bool:
        """Sniff the format: native files start with the magic,
        reference-binary files with a little-endian int32 net_type."""
        head = fi.read(len(checkpoint.MAGIC))
        fi.seek(-len(head), 1)
        return head == checkpoint.MAGIC

    def load_model(self, fi) -> None:
        """Load a checkpoint of either format. A native file supplies
        structure, weights, the update counter and, if it carries one,
        the updater state (for `continue = 1`); the config supplies the
        layer settings. A reference-binary file, as in the reference,
        needs the netconfig from the config: the file's structure is
        checked equal to it and supplies the weights and the counter."""
        if not self._is_native(fi):
            self._load_legacy(fi)
            return
        blob = checkpoint.load_model(fi)
        self.net_cfg = NetConfig.from_dict(blob["net"])
        self.net_cfg.configure(self.cfg_pairs)
        self._build_net()
        self.epoch = blob["epoch"]
        self._reset_counters()
        self._loaded_opt = blob["opt_state"]
        self._init_state(convert.params_from_numpy(
            blob["params"], self.net.param_shapes(), self.device))

    def _load_legacy(self, fi) -> None:
        self.net_cfg = NetConfig()
        self.net_cfg.configure(self.cfg_pairs)
        self._build_net()
        # expected shapes only (the file's tensors are validated
        # against them); no throwaway init
        expected = {lk: {pn: np.empty(shape, np.float32)
                         for pn, shape in d.items()}
                    for lk, d in self.net.param_shapes().items()}
        blob = legacy_format.load_legacy_model(fi, self.net_cfg, self.net,
                                               expected)
        self.epoch = blob["epoch"]
        self._reset_counters()
        self._init_state(convert.params_from_numpy(
            blob["params"], self.net.param_shapes(), self.device))

    def copy_model_from(self, fi) -> None:
        """Finetune: copy the params of layers whose names match
        (nnet_impl-inl.hpp:101-134); call after init_model. The updater
        state starts fresh."""
        if self.state is None:
            raise RuntimeError("copy_model_from requires init_model first")
        blob = (checkpoint.load_model(fi) if self._is_native(fi)
                else legacy_format.read_legacy_model(fi))
        params = self._host_params()
        copied = []
        for lk, d in blob["params"].items():
            if lk.startswith("layer_"):
                continue  # unnamed layers are not matched
            if lk in params:
                for pn, arr in d.items():
                    if pn not in params[lk]:
                        continue
                    want = params[lk][pn].shape
                    if arr.shape != want and arr.size == params[
                            lk][pn].size:
                        # a reference-binary conv wmat arrives in the
                        # file's 3-D layout: the memory order of OIHW
                        arr = arr.reshape(want)
                    if arr.shape == want:
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
        flattening = (shape[0], prod(rest)) (visitor.h:26-100). The
        weight whole, gathered over the model and ZeRO cuts (every rank
        calls this together)."""
        lk, pn = self._weight_key(layer_name, tag)
        t = self.state["params"][lk][pn]
        z, mc = self._zero, self._pcut
        if z is not None and self._zero_run >= 3 and z.is_cut(lk, pn):
            t = z.gather_full({(lk, pn): t})[(lk, pn)]
        if mc is not None and mc.is_cut(lk, pn):
            t = mc.gather({lk: {pn: t}})[lk][pn]
        arr = t.cpu().numpy()
        return arr.reshape(arr.shape[0], -1), arr.shape

    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str) -> None:
        lk, pn = self._weight_key(layer_name, tag)
        params = self.state["params"]
        whole = self.net.param_shapes()[lk][pn]
        arr = np.asarray(weight, dtype=np.float32).reshape(tuple(whole))
        t = self._cut_params({lk: {pn: torch.from_numpy(arr.copy()).to(
            self.device)}})[lk][pn]
        params[lk][pn] = t
        self._weights_changed(retire=True)

    def check_weights(self) -> List[str]:
        """test_on_server (async_updater-inl.hpp:144-153): what is
        replicated must be bitwise the same on every rank that holds
        it - each param over the data group (but a weight cut there
        under zero_stage = 3), each param not cut over the model, expert
        or pipe axis over that axis's group, every param over the seq
        group; returns a description of each that differs ([] on one
        rank)."""
        if self.mesh is None:
            return []
        params = self.state["params"]
        z, mc = self._zero, self._pcut
        bad = []
        if self._dsize > 1:
            skip = ([f"[{lk!r}][{pn!r}]" for lk, pn, _, _ in z.cut]
                    if z is not None and self._zero_run >= 3 else [])
            bad += distributed.check_replicated(
                params, group=self.mesh.group, skip=skip)
        for axis in (MODEL_AXIS, EXPERT_AXIS, PIPE_AXIS):
            if self.mesh.shape.get(axis, 1) > 1:
                # what is not cut over the axis is replicated over it
                bad += distributed.check_replicated(
                    params, group=self.mesh.group_of(axis),
                    skip=[f"[{lk!r}][{pn!r}]" for lk, d in params.items()
                          for pn in d
                          if mc is not None and mc.is_cut(lk, pn, axis)])
        if self._nseq > 1:
            # every param is replicated over the seq ranks
            bad += distributed.check_replicated(
                params, group=self.mesh.seq_group)
        return bad

    def _weight_key(self, layer_name: str, tag: str) -> Tuple[str, str]:
        idx = self.net_cfg.get_layer_index(layer_name)
        for pname, t in self.net.layer_objs[idx].param_tags().items():
            if t == tag or pname == tag:
                return param_key(self.net_cfg, idx), pname
        raise KeyError(f"layer {layer_name} has no weight tagged {tag}")
