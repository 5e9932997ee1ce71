"""graftlint tier 2 for the port: audit what a path really dispatches
(the port's counterpart of cxxnet_tpu/analysis/jaxpr_audit.py).

Eager PyTorch has no jaxpr and no lowered module, so the audit watches
the dispatch itself while a target runs (`Probe`):

- every aten op, with its dtypes and shapes, through a
  `torch.utils._python_dispatch.TorchDispatchMode` (`OpLog`). The
  hand-written CUDA kernels are ctypes launches that no dispatch mode
  and no profiler op list sees; they are counted by their wrappers
  (`kernels.LAUNCHES`);
- every call of a plain version of a kernel (`ops/lrn.py`
  lrn_reference / lrn_bwd_reference, `ops/flash_attention.py`
  flash_fwd_reference / flash_bwd_reference / flash_dq_reference /
  flash_dkv_reference, `ops/int8.py` int8_matmul_reference /
  int8_conv2d_reference) and of `F.local_response_norm`, by wrappers
  over the module globals the kernels' callers look up (`PlainCalls`);
- every host read of a tensor: `Tensor.item` / `.cpu` / `.tolist` /
  `.numpy` (the last only on a card tensor; `.numpy()` of a CPU copy
  reads nothing new) and `torch.cuda.synchronize` / `Stream.synchronize`
  / `Event.synchronize` (`HostReads`), plus the op `aten::_local_scalar_
  dense` that `float()` / `int()` / `bool()` of a tensor dispatch. On
  the card the target also runs under `torch.cuda.set_sync_debug_mode`
  (`"error"` where it may not sync at all, `"warn"` with the warnings
  counted where one readback is its design). That mode flags the
  blocking copies and synchronizing ops of the CUDA backend; a pinned
  non-blocking copy is not a sync and is not flagged.

Checks (the JAX audit's names where the meaning carries over):

- **no-f64**: no aten op of the target reads or produces float64;
- **no-host-sync** (JAX: no-host-callback): no host read inside a step;
  `train_chunk[K=4,check_nan=1]` is allowed exactly one readback a chunk
  (the guard's finite vector), counted, never more;
- **update-in-place** (JAX: donation-applied): every param and updater
  slot keeps its `data_ptr` across `update` and `update_chunk`;
- **eval-leaves-params** (JAX: no-spurious-donation): eval, infer and
  serve leave the params' `data_ptr` and `_version` untouched;
- **no-param-sized-copy** (JAX: no-captured-consts): no `aten::clone` /
  `aten::copy_` of a param's shape inside a step under check_nan = 0;
- **recompile** (the JAX recompile audit in torch terms): no kernel
  library is built or loaded after warm-up across a 4+4+1 round, the
  chunk path registers two chunk programs (K = 4 and the short K = 1),
  stable on round 2, and padded short batches add no train or infer
  program (the trainer's dispatch fingerprints, telemetry/flight.py);
- **serve**: one registered bucket program per ladder entry, 4 for
  (1, 2, 4, 8), none added by 100 mixed-size requests, and the
  executable registry lists and counts them;
- **passes/** and **quant**: the fold removes the batch-norm moment ops
  (vacuity-guarded: the unfolded trace has them), dead_layer_elim runs
  none of the pruned layers' matmuls, fuse_activation / merge_conv_1x1 /
  cse_share / elim_reshape each shrink the op count against the same
  pipeline without them, every data-path product of the int8 infer is an
  int8 product with no float one left (vacuity-guarded against the float
  trace) and `layer_quant = float` keeps exactly its layer float;
- **executables**: the registry is non-empty, covers train, infer and
  serve, and every entry has the schema;
- **kernel-routing** (card only): AlexNet.conf's served bf16 b64 bucket
  launches K1-fwd 2, its b64 train step K1-fwd 2 and K1-bwd 2,
  seq_mnist.conf's b100 step K2-fwd, K2-dq and K2-dkv 1 each, and the
  int8 AlexNet bucket K3 11 - with no plain-version call, no
  `F.local_response_norm`, no `aten::_scaled_dot_product_*` and no
  `aten::_int_mm`; guarded against vacuity by the float bucket's trace,
  which must carry the float products the int8 trace removes.

- **zero-audit** (the JAX audit's zero audit in torch terms): two ranks
  joined over gloo (subprocesses of the audit, on its device) run one
  logged step each of the tiny MLP at `mesh = data:2` under zero_stage
  = 2 and 3 and of an attention net at `mesh = model:2`; every
  collective the port issues is logged with its group and size. At
  stage >= 2 a reduce-scatter carries exactly the cut weights'
  gradients and no all-reduce carries any of them (the all-reduce
  holds the loss, the uncut gradients and the metric rows, nothing
  more); stage 2 all-gathers the updated slices after the update,
  stage 3 all-gathers the weights before the forward and stores only
  its cut between steps. Under model:2 every column-parallel layer
  pairs tensor.enter with tensor.gather, the row-parallel projection
  closes with tensor.reduce, and no data-group collective runs.

Targets run over the tiny-MLP conf of the JAX audit (`_CONF`) and the
pass / quant confs beside it; `run_audit(device)` runs on the card
unless asked for the CPU.
"""

from __future__ import annotations

import collections
import os
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the JAX audit's tiny MLP (cxxnet_tpu/analysis/jaxpr_audit.py _CONF);
# telemetry_steps = 0 keeps the per-step instruments' loss readback out
# of the audited step
_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1:sg1] = tanh
layer[sg1->fc2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,36
batch_size = 32
eta = 0.3
metric = error
eval_train = 1
silent = 1
seed = 7
telemetry_steps = 0
"""

_CONF_BN = _CONF.replace(
    "layer[+1:sg1] = tanh",
    "layer[+1:bn1] = batch_norm:bn1\nlayer[+1:sg1] = tanh")

# fuse_activation workload: fullc + separate bias layer + relu
_CONF_ACT = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+0] = bias:bs1
  init_bias = 0.05
layer[+1:r1] = relu
layer[+1:fc2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,36
batch_size = 32
eta = 0.3
silent = 1
seed = 7
telemetry_steps = 0
"""

# merge_conv_1x1 / elim_reshape workload: 3x3 conv feeding a 1x1 conv
_CONF_1X1 = """
netconfig=start
layer[+1:c1] = conv:c1
  nchannel = 4
  kernel_size = 3
  pad = 1
layer[+1:c2] = conv:c2
  nchannel = 6
  kernel_size = 1
layer[+1:fl] = flatten
layer[+1:fc] = fullc:fc
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 3,8,8
batch_size = 8
eta = 0.1
silent = 1
seed = 5
telemetry_steps = 0
"""

# cse_share workload: a primary and its share[...] sibling reading the
# same input node
_CONF_CSE = """
netconfig=start
layer[0->a] = fullc:fc1
  nhidden = 8
  init_sigma = 0.1
layer[0->b] = share[fc1]
layer[a,b->c] = concat
layer[+1:fc2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,12
batch_size = 8
eta = 0.1
silent = 1
seed = 3
telemetry_steps = 0
"""

_QUANT_PASSES = "dead_layer_elim,fold_conv_bn,quantize_int8"

# aten ops that are a matrix product or a convolution (the data-path
# product classes), the batch-norm moment pipeline and the reshapes
# (a composite op such as aten::matmul is recorded where the dispatcher
# hands it to the mode whole; the ops it decomposes into are then run
# with the mode off, so a product is never counted twice)
DOTS = frozenset({"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
                  "aten::mv", "aten::dot", "aten::_int_mm", "aten::matmul",
                  "aten::linear", "aten::einsum"})
CONVS = frozenset({"aten::convolution", "aten::_convolution",
                   "aten::cudnn_convolution", "aten::mkldnn_convolution",
                   "aten::_slow_conv2d_forward", "aten::conv2d"})
BN_MOMENTS = frozenset({"aten::rsqrt", "aten::batch_norm",
                        "aten::native_batch_norm", "aten::var_mean",
                        "aten::var", "aten::_native_batch_norm_legit"})
RESHAPES = frozenset({"aten::view", "aten::_unsafe_view", "aten::reshape",
                      "aten::flatten"})
# library kernels no main path of the port may reach
FORBIDDEN = ("aten::_scaled_dot_product", "aten::_int_mm",
             "aten::_flash_attention", "aten::_efficient_attention",
             "aten::_cudnn_attention")
HOST_SYNC_OPS = frozenset({"aten::_local_scalar_dense"})
# what torch.cuda.set_sync_debug_mode("warn") says at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"


def _check(target: str, check: str, ok: bool,
           detail: str = "") -> Dict[str, Any]:
    return {"target": target, "check": check, "ok": bool(ok),
            "detail": detail}


# ---------------------------------------------------------------------------
# the probe: aten ops, host reads, plain-version calls, kernel launches
# ---------------------------------------------------------------------------
class Op(NamedTuple):
    name: str
    in_dtypes: Tuple[torch.dtype, ...]
    out_dtypes: Tuple[torch.dtype, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_shapes: Tuple[Tuple[int, ...], ...]


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpLog(TorchDispatchMode):
    """Records every aten op dispatched while it is entered (on this
    thread and on the autograd engine's threads, which inherit the
    mode)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.ops.append(Op(
            func._schema.name, tuple(t.dtype for t in ins),
            tuple(t.dtype for t in outs),
            tuple(tuple(t.shape) for t in ins),
            tuple(tuple(t.shape) for t in outs)))
        return out


class _Patches:
    """Attribute patches restored in reverse order on exit."""

    def __init__(self) -> None:
        self._saved: List[Tuple[Any, str, Any]] = []

    def patch(self, owner, name: str, new) -> None:
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def restore(self) -> None:
        while self._saved:
            owner, name, old = self._saved.pop()
            setattr(owner, name, old)


# (module, global) of every plain version of a kernel
PLAIN_VERSIONS = (
    ("cxxnet_tpu_torch.ops.lrn", "lrn_reference"),
    ("cxxnet_tpu_torch.ops.lrn", "lrn_bwd_reference"),
    ("cxxnet_tpu_torch.ops.flash_attention", "flash_fwd_reference"),
    ("cxxnet_tpu_torch.ops.flash_attention", "flash_bwd_reference"),
    ("cxxnet_tpu_torch.ops.flash_attention", "flash_dq_reference"),
    ("cxxnet_tpu_torch.ops.flash_attention", "flash_dkv_reference"),
    ("cxxnet_tpu_torch.ops.int8", "int8_matmul_reference"),
    ("cxxnet_tpu_torch.ops.int8", "int8_conv2d_reference"),
)


def _counting(fn, counts: Dict[str, int], key: str):
    def wrapped(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", key)
    return wrapped


class PlainCalls:
    """Counts the calls of every plain version of a kernel and of
    `F.local_response_norm` (process-wide: a backward may run on the
    autograd engine's thread)."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = collections.Counter()
        self._p = _Patches()

    def __enter__(self) -> "PlainCalls":
        import importlib
        for mod_name, name in PLAIN_VERSIONS:
            mod = importlib.import_module(mod_name)
            self._p.patch(mod, name, _counting(getattr(mod, name),
                                               self.counts, name))
        import torch.nn.functional as F
        self._p.patch(F, "local_response_norm", _counting(
            F.local_response_norm, self.counts, "F.local_response_norm"))
        return self

    def __exit__(self, *exc) -> bool:
        self._p.restore()
        return False


class HostReads:
    """Counts the host's reads of tensors and waits on the card:
    Tensor.item / .cpu / .tolist, .numpy of a card tensor, and the
    synchronize of torch.cuda, a Stream and an Event. `on_read(name)`,
    when given, is called at each one (the lock audit's dispatch
    boundary). Every wrapper is restored on exit."""

    TENSOR_METHODS = ("item", "cpu", "tolist", "numpy")

    def __init__(self, on_read=None) -> None:
        self.counts: Dict[str, int] = collections.Counter()
        self._on_read = on_read
        self._p = _Patches()

    def _hit(self, name: str) -> None:
        self.counts[name] += 1
        if self._on_read is not None:
            self._on_read(name)

    def __enter__(self) -> "HostReads":
        for name in self.TENSOR_METHODS:
            orig = getattr(torch.Tensor, name)

            def wrapped(t, *args, __orig=orig, __name=name, **kwargs):
                if __name != "numpy" or t.device.type != "cpu":
                    self._hit(f"Tensor.{__name}")
                return __orig(t, *args, **kwargs)
            self._p.patch(torch.Tensor, name, wrapped)
        for owner, name, label in (
                (torch.cuda, "synchronize", "torch.cuda.synchronize"),
                (torch.cuda.Stream, "synchronize", "Stream.synchronize"),
                (torch.cuda.Event, "synchronize", "Event.synchronize")):
            orig = getattr(owner, name)

            def wrapped(*args, __orig=orig, __label=label, **kwargs):
                self._hit(__label)
                return __orig(*args, **kwargs)
            self._p.patch(owner, name, wrapped)
        return self

    def __exit__(self, *exc) -> bool:
        self._p.restore()
        return False

    @property
    def total(self) -> int:
        return sum(self.counts.values())


class Probe:
    """One target under audit: its aten ops (`ops`), host reads
    (`reads`), plain-version calls (`plain`), kernel launches (`launches`,
    the delta of kernels.LAUNCHES) and, on the card, the target run under
    `torch.cuda.set_sync_debug_mode(sync_mode)` with its sync warnings
    counted (`sync_warnings`); an error raised in the target is kept in
    `error` rather than propagated."""

    def __init__(self, device: torch.device,
                 sync_mode: Optional[str] = "error") -> None:
        self.device = torch.device(device)
        self.sync_mode = sync_mode if self.device.type == "cuda" else None
        self.ops: List[Op] = []
        self.reads = 0
        self.read_kinds: Dict[str, int] = {}
        self.plain: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.sync_warnings = 0
        self.error = ""

    def __enter__(self) -> "Probe":
        from cxxnet_tpu_torch import kernels
        # the probe's own syncs stay outside what it counts
        if self.sync_mode is not None:
            torch.cuda.synchronize(self.device)
        self._k0 = kernels.launches()
        self._log = OpLog()
        self._reads = HostReads()
        self._plain = PlainCalls()
        self._plain.__enter__()
        self._reads.__enter__()
        self._warn = warnings.catch_warnings(record=True)
        self._warned = self._warn.__enter__()
        warnings.simplefilter("always")
        if self.sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self.sync_mode)
        self._log.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        from cxxnet_tpu_torch import kernels
        self._log.__exit__(None, None, None)
        if self.sync_mode is not None:
            torch.cuda.set_sync_debug_mode(0)
        self.sync_warnings = sum(1 for w in self._warned
                                 if SYNC_WARNING in str(w.message))
        self._warn.__exit__(None, None, None)
        self._reads.__exit__(None, None, None)
        self._plain.__exit__(None, None, None)
        if self.sync_mode is not None:
            torch.cuda.synchronize(self.device)
        self.ops = self._log.ops
        self.reads = self._reads.total
        self.read_kinds = dict(self._reads.counts)
        self.plain = dict(self._plain.counts)
        k1 = kernels.launches()
        self.launches = {n: k1[n] - self._k0.get(n, 0) for n in k1
                         if k1[n] != self._k0.get(n, 0)}
        if exc is not None:
            self.error = f"{type(exc).__name__}: {exc}"[:300]
            return True   # kept, reported by the checks
        return False

    # -- views of the op log ---------------------------------------------
    def count(self, names) -> int:
        names = {names} if isinstance(names, str) else set(names)
        return sum(1 for op in self.ops if op.name in names)

    def f64_ops(self) -> List[str]:
        return sorted({op.name for op in self.ops
                       if torch.float64 in op.in_dtypes + op.out_dtypes})

    def forbidden(self) -> List[str]:
        return sorted({op.name for op in self.ops
                       if op.name.startswith(FORBIDDEN)})

    def data_path_products(self, batch: int) -> Tuple[int, int]:
        """(int products, float products) among the op log's matrix
        products and convolutions whose output leads with the batch -
        the data path; weight-side products are excluded."""
        ints = floats = 0
        for op in self.ops:
            if op.name not in DOTS and op.name not in CONVS:
                continue
            if not op.out_shapes or not op.out_shapes[0] \
                    or op.out_shapes[0][0] != batch:
                continue
            if op.in_dtypes and all(not d.is_floating_point
                                    for d in op.in_dtypes):
                ints += 1
            elif any(d.is_floating_point for d in op.in_dtypes):
                floats += 1
        return ints, floats


# ---------------------------------------------------------------------------
# trainers and batches
# ---------------------------------------------------------------------------
def _make_trainer(device="cpu", conf: str = _CONF, extra: str = ""):
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    tr = NetTrainer(cfg=conf + extra, device=str(device))
    tr.init_model()
    return tr


def _batch(i: int, b: int = 32, shape=(1, 1, 36), classes: int = 3):
    from cxxnet_tpu_torch.io.data import DataBatch
    rng = np.random.RandomState(100 + i)
    return DataBatch(
        data=rng.rand(b, *shape).astype(np.float32),
        label=rng.randint(0, classes, size=(b, 1)).astype(np.float32))


class _ListIter:
    """A DataIter over a fixed list of batches."""

    def __init__(self, batches) -> None:
        self.batches = list(batches)
        self.i = -1

    def before_first(self) -> None:
        self.i = -1

    def next(self) -> bool:
        self.i += 1
        return self.i < len(self.batches)

    def value(self):
        return self.batches[self.i]


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _ptrs(tr) -> List[int]:
    return [t.data_ptr() for t in
            _leaves(tr.state["params"]) + _leaves(tr.state["ustate"])]


def _param_marks(tr) -> List[Tuple[int, int]]:
    return [(t.data_ptr(), t._version) for t in _leaves(tr.state["params"])]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# per-target checks
# ---------------------------------------------------------------------------
def _sync_checks(target: str, p: Probe, reads: int = 0
                 ) -> List[Dict[str, Any]]:
    """no-f64 and no-host-sync of one probed target; `reads` is the
    number of host reads the target's design allows."""
    checks = []
    f64 = p.f64_ops()
    checks.append(_check(
        target, "no-f64", not f64 and not p.error,
        p.error or (f"float64 in {f64}" if f64
                    else f"{len(p.ops)} aten ops, none float64")))
    scalar = p.count(HOST_SYNC_OPS)
    ok = not p.error and p.reads == reads and scalar == 0
    detail = (f"{p.reads} host read(s) {p.read_kinds} (want {reads}), "
              f"{scalar} _local_scalar_dense")
    if p.sync_mode is not None:
        want_warn = reads if p.sync_mode == "warn" else 0
        ok = ok and p.sync_warnings == want_warn
        detail += (f"; set_sync_debug_mode({p.sync_mode!r}): "
                   f"{p.sync_warnings} sync warning(s)")
    checks.append(_check(target, "no-host-sync", ok,
                         p.error or detail))
    return checks


def _param_sized_copies(tr, p: Probe) -> List[str]:
    shapes = {tuple(t.shape) for t in _leaves(tr.state["params"])
              if t.dim() >= 2}
    return [op.name for op in p.ops
            if op.name in ("aten::clone", "aten::copy_")
            and any(s in shapes for s in op.out_shapes)]


def _train_targets(device, checks) -> None:
    tr = _make_trainer(device)
    # warm-up outside the probes: first-use allocations and the updater
    # state's creation
    tr.update(_batch(0))
    tr.update_chunk([_batch(i) for i in range(4)])
    _sync(device)
    staged = tr.stage_batch(_batch(1))
    ptrs = _ptrs(tr)
    with Probe(device) as p:
        tr.update(staged)
    target = "train_step"
    checks += _sync_checks(target, p)
    checks.append(_check(
        target, "update-in-place", _ptrs(tr) == ptrs,
        f"{len(ptrs)} param and updater tensors keep their storage"))
    copies = _param_sized_copies(tr, p)
    checks.append(_check(
        target, "no-param-sized-copy", not copies,
        f"param-sized {copies}" if copies else
        f"no clone/copy_ of a param's shape in {len(p.ops)} ops"))
    for k in (1, 4):
        target = f"train_chunk[K={k}]"
        chunk = tr.stage_chunk([_batch(i) for i in range(k)])
        ptrs = _ptrs(tr)
        with Probe(device) as p:
            tr.update_chunk(chunk)
        checks += _sync_checks(target, p)
        checks.append(_check(
            target, "update-in-place", _ptrs(tr) == ptrs,
            f"{len(ptrs)} param and updater tensors keep their storage"))
        copies = _param_sized_copies(tr, p)
        checks.append(_check(
            target, "no-param-sized-copy", not copies,
            f"param-sized {copies}" if copies else
            f"no clone/copy_ of a param's shape in {len(p.ops)} ops"))
    # the guard's one readback a chunk under check_nan = 1
    trg = _make_trainer(device, extra="check_nan = 1\n")
    trg.update_chunk([_batch(i) for i in range(4)])
    _sync(device)
    chunk = trg.stage_chunk([_batch(i) for i in range(4, 8)])
    g0 = trg.guard_readbacks
    ptrs = _ptrs(trg)
    target = "train_chunk[K=4,check_nan=1]"
    with Probe(device, sync_mode="warn") as p:
        trg.update_chunk(chunk)
    checks += _sync_checks(target, p, reads=1)
    checks.append(_check(
        target, "one-guard-readback-a-chunk",
        trg.guard_readbacks - g0 == 1 and p.reads == 1,
        f"guard_readbacks +{trg.guard_readbacks - g0}, host reads "
        f"{p.read_kinds} over one K=4 chunk"))
    checks.append(_check(
        target, "update-in-place", _ptrs(trg) == ptrs,
        f"{len(ptrs)} param and updater tensors keep their storage"))


def _eval_targets(device, checks) -> None:
    tr = _make_trainer(device)
    tr.update(_batch(0))
    final = tr.net_cfg.num_nodes - 1
    params = tr.compute_params()
    staged = tr._stage(_batch(2), train=False)
    tr.eval_rows(staged, params)          # warm
    fwd = tr.infer_fn(final)
    gdata = tr.stage_infer_rows(_batch(3).data)
    _sync(device)
    targets = (
        ("eval_step", lambda: fwd(params, staged.data)),
        ("eval_metric_step", lambda: tr.eval_rows(staged, params, 1)),
        ("infer_step", lambda: tr.infer_rows(gdata)),
    )
    for target, fn in targets:
        marks = _param_marks(tr)
        with torch.inference_mode(), Probe(device) as p:
            fn()
        checks += _sync_checks(target, p)
        checks.append(_check(
            target, "eval-leaves-params", _param_marks(tr) == marks,
            "params' data_ptr and _version unchanged"))


# ---------------------------------------------------------------------------
# recompile audit: programs and kernel libraries across rounds
# ---------------------------------------------------------------------------
def _programs(tr, kind: str) -> int:
    return sum(1 for key in tr._flight_fps if key[0] == kind)


def _recompile_audit(device, checks) -> Dict[str, int]:
    from cxxnet_tpu_torch import kernels
    tr = _make_trainer(device)
    builds = collections.Counter()
    real_build = kernels.build_all

    def counting_build(names=None):
        builds["build_all"] += 1
        return real_build(names)

    def round_of(k: int, n: int) -> None:
        """One pass: n batches in chunks of k with the round-boundary
        short-chunk flush (the CLI's fused round loop)."""
        pending = []
        for i in range(n):
            pending.append(_batch(i))
            if len(pending) >= k:
                tr.update_chunk(pending)
                pending = []
        if pending:
            tr.update_chunk(pending)

    round_of(4, 9)                      # warm-up round: 4 + 4 + 1
    _sync(device)
    libs0 = sorted(kernels._libs)
    sizes = {"train_chunk_round1": _programs(tr, "train_chunk")}
    checks.append(_check(
        "recompile", "chunk-programs==2 after 4+4+1 round",
        sizes["train_chunk_round1"] == 2,
        f"{sizes['train_chunk_round1']} chunk programs (want 2: K=4 and "
        "the short K=1)"))
    kernels.build_all = counting_build
    try:
        round_of(4, 9)
        sizes["train_chunk_round2"] = _programs(tr, "train_chunk")
        checks.append(_check(
            "recompile", "chunk-programs stable across rounds",
            sizes["train_chunk_round2"] == sizes["train_chunk_round1"],
            f"{sizes['train_chunk_round2']} after round 2"))
        tr.update(_batch(50))
        tr.update(_batch(51, b=20))
        sizes["train_step"] = _programs(tr, "train_step")
        checks.append(_check(
            "recompile", "step-programs==1 incl. padded short batch",
            sizes["train_step"] == 1,
            f"{sizes['train_step']} (padding keeps the program shape)"))
        tr.predict(_batch(60))
        tr.predict(_batch(61, b=20))
        sizes["infer_step"] = _programs(tr, "infer")
        checks.append(_check(
            "recompile", "infer-programs==1 incl. padded short batch",
            sizes["infer_step"] == 1, f"{sizes['infer_step']}"))
    finally:
        kernels.build_all = real_build
    libs1 = sorted(kernels._libs)
    checks.append(_check(
        "recompile", "no-kernel-build-or-load-after-warmup",
        builds["build_all"] == 0 and libs1 == libs0,
        f"{builds['build_all']} build_all call(s); libraries {libs0} -> "
        f"{libs1}"))
    return sizes


# ---------------------------------------------------------------------------
# serve audit
# ---------------------------------------------------------------------------
def _serve_audit(device, checks) -> Dict[str, int]:
    from cxxnet_tpu_torch import telemetry
    from cxxnet_tpu_torch.serve import Server
    tr = _make_trainer(device)
    srv = Server(tr, max_batch=8, max_wait_ms=1.0, replicas=2,
                 device=str(device))
    srv.warmup()
    n_warm = srv.executable_cache_size()
    checks.append(_check(
        "serve", "bucket-programs==bucket-count",
        n_warm == len(srv.buckets),
        f"{n_warm} programs, buckets {list(srv.buckets)}"))
    srv.start()
    rng = np.random.RandomState(7)
    futs = [srv.submit(rng.rand(1 + int(rng.randint(8)), 1, 1, 36)
                       .astype(np.float32)) for _ in range(100)]
    for f in futs:
        f.result(timeout=120)
    stats = srv.stop()
    n_after = srv.executable_cache_size()
    checks.append(_check(
        "serve", "no-new-program-over-100-mixed-requests",
        n_after == n_warm,
        f"{n_warm} -> {n_after} after {stats['batches']} batches / "
        f"{stats['rows']} rows"))
    checks.append(_check("serve", "no-dispatch-errors",
                         stats["errors"] == 0,
                         f"{stats['errors']} dispatch errors"))
    by_fp = {e["fingerprint"]: e
             for e in telemetry.executables().snapshot()}
    want = {b: srv._exec_fp.get(b) for b in srv.buckets}
    missing = [b for b, fp in want.items() if fp not in by_fp]
    checks.append(_check(
        "serve", "executables-registry-lists-buckets", not missing,
        f"buckets missing: {missing}" if missing
        else f"{len(want)} bucket entries registered"))
    if not missing:
        no_compile = [b for b, fp in want.items()
                      if by_fp[fp]["compile_s"] is None]
        checks.append(_check(
            "serve", "executables-compile-walltime-recorded",
            not no_compile, f"no compile_s: {no_compile}"
            if no_compile else ""))
        n_disp = sum(by_fp[fp]["dispatches"] for fp in want.values())
        checks.append(_check(
            "serve", "executables-dispatch-counts-accumulate",
            n_disp >= stats["batches"],
            f"{n_disp} dispatches counted over {stats['batches']} "
            "batches"))
    # each bucket's forward, as a replica runs it on its lane
    graph, cparams = srv._graph, srv._slot.cparams
    for b in srv.buckets:
        gdata = tr.stage_infer_rows(np.zeros((b, 1, 1, 36), np.float32))
        _sync(device)
        marks = _param_marks(tr)
        with torch.inference_mode(), Probe(device) as p:
            graph.run(cparams, gdata, ())
        checks += _sync_checks(f"serve[b={b}]", p)
        checks.append(_check(
            f"serve[b={b}]", "eval-leaves-params",
            _param_marks(tr) == marks,
            "params' data_ptr and _version unchanged"))
    return {"serve_programs_warm": n_warm, "serve_programs_after": n_after}


# ---------------------------------------------------------------------------
# pass audit
# ---------------------------------------------------------------------------
def _probe_infer(tr, node: int, shape, device) -> Probe:
    """The op log of one inference forward of `node` on zero rows (the
    graph built and warmed first)."""
    gdata = tr.stage_infer_rows(np.zeros(shape, np.float32))
    tr.infer_rows(gdata, node)
    _sync(device)
    with torch.inference_mode(), Probe(device) as p:
        tr.infer_rows(gdata, node)
    return p


def _gm_layers(tr, node: int) -> int:
    gm = tr.infer_graph(node).gm
    return len((gm.cfg if gm is not None else tr.net_cfg).layers)


def _pass_audit(device, checks) -> Dict[str, int]:
    off = _make_trainer(device, _CONF_BN)
    on = _make_trainer(device, _CONF_BN,
                       "graph_passes = fold_conv_bn,dead_layer_elim\n")
    on.calibrate_graph_passes(_batch(0))
    final = on.net_cfg.num_nodes - 1
    early = on.net.node_index("fc1")
    shape = (32, 1, 1, 36)
    p_on = _probe_infer(on, final, shape, device)
    p_off = _probe_infer(off, final, shape, device)
    bn_on, bn_off = p_on.count(BN_MOMENTS), p_off.count(BN_MOMENTS)
    checks.append(_check(
        "passes/fold", "no-bn-moment-ops", bn_on == 0 and bn_off > 0,
        f"folded {bn_on} moment op(s), unfolded {bn_off} (the unfolded "
        "trace must carry them or this check is vacuous)"))
    d_on, d_off = p_on.count(DOTS), p_off.count(DOTS)
    checks.append(_check(
        "passes/fold", "strictly-smaller-op-trace",
        len(p_on.ops) < len(p_off.ops) and d_on == d_off,
        f"folded {len(p_on.ops)} ops/{d_on} matmuls vs unfolded "
        f"{len(p_off.ops)}/{d_off} (the fold removes the BN pipeline, "
        "never a matmul)"))
    p_early = _probe_infer(on, early, shape, device)
    pruned = len(on.net_cfg.layers) - _gm_layers(on, early)
    checks.append(_check(
        "passes/dle", "pruned-subgraph-absent",
        p_early.count(DOTS) == 1 and len(p_early.ops) < len(p_off.ops)
        and pruned > 0,
        f"early-node extract runs {p_early.count(DOTS)} matmul(s)/"
        f"{len(p_early.ops)} ops (full graph {d_off}/{len(p_off.ops)}); "
        f"{pruned} layer(s) pruned"))
    # steady state: full + padded short predicts and extracts add no
    # inference program past the first
    on.predict(_batch(70))
    on.predict(_batch(71, b=20))
    on.predict(_batch(72))
    on.extract_feature(_batch(73), "fc1")
    on.extract_feature(_batch(74, b=20), "fc1")
    progs = collections.Counter(key[1] for key in on._flight_fps
                                if key[0] == "infer")
    checks.append(_check(
        "passes/fold", "zero-new-steady-state-programs",
        progs.get(final) == 1 and progs.get(early) == 1,
        f"final-node programs {progs.get(final)}, early-node "
        f"{progs.get(early)} after full+short predicts and extracts "
        "(want 1 each)"))
    _new_pattern_audit(device, checks)
    return {"dle_pruned_layers": pruned}


def _new_pattern_audit(device, checks) -> None:
    """fuse_activation, merge_conv_1x1, cse_share and elim_reshape, each
    against the same pipeline without the pattern pass, each
    vacuity-guarded by what the off trace must carry."""

    def traces(conf, passes, shape):
        off = _make_trainer(device, conf,
                            "graph_passes = dead_layer_elim\n")
        on = _make_trainer(device, conf,
                           f"graph_passes = dead_layer_elim,{passes}\n")
        node = on.net_cfg.num_nodes - 1
        return (_probe_infer(off, node, shape, device),
                off.infer_graph(node).gm,
                _probe_infer(on, node, shape, device),
                on.infer_graph(node).gm)

    p_off, gm_off, p_on, gm_on = traces(_CONF_ACT, "fuse_activation",
                                        (32, 1, 1, 36))
    checks.append(_check(
        "passes/fuse_activation", "pattern-matched",
        len(gm_on.cfg.layers) < len(gm_off.cfg.layers),
        f"fused graph keeps {len(gm_on.cfg.layers)} layers vs "
        f"{len(gm_off.cfg.layers)} unfused (vacuity guard)"))
    checks.append(_check(
        "passes/fuse_activation", "fewer-ops-equal-matmuls",
        len(p_on.ops) < len(p_off.ops)
        and p_on.count(DOTS) == p_off.count(DOTS),
        f"fused {len(p_on.ops)} ops/{p_on.count(DOTS)} matmuls vs "
        f"unfused {len(p_off.ops)}/{p_off.count(DOTS)}"))

    p_off, gm_off, p_on, gm_on = traces(_CONF_1X1, "merge_conv_1x1",
                                        (8, 3, 8, 8))
    co, cn = p_off.count(CONVS), p_on.count(CONVS)
    checks.append(_check(
        "passes/merge_conv_1x1", "one-conv-fewer",
        co >= 2 and cn == co - 1 and bool(gm_on.merges),
        f"merged trace runs {cn} convs vs {co} unmerged (want one "
        "fewer, the unmerged trace carrying >= 2, and a merge site)"))

    p_off, gm_off, p_on, gm_on = traces(_CONF_CSE, "cse_share",
                                        (8, 1, 1, 12))
    do, dn = p_off.count(DOTS), p_on.count(DOTS)
    checks.append(_check(
        "passes/cse_share", "duplicate-matmul-deduped",
        do >= 3 and dn == do - 1 and len(p_on.ops) < len(p_off.ops)
        and len(gm_on.cfg.layers) < len(gm_off.cfg.layers),
        f"deduped trace runs {dn} matmuls/{len(p_on.ops)} ops vs "
        f"{do}/{len(p_off.ops)} undeduped (want one matmul fewer)"))

    p_off, gm_off, p_on, gm_on = traces(_CONF_1X1, "elim_reshape",
                                        (8, 3, 8, 8))
    ro, rn = p_off.count(RESHAPES), p_on.count(RESHAPES)
    checks.append(_check(
        "passes/elim_reshape", "fewer-ops-equal-matmuls",
        len(p_on.ops) < len(p_off.ops) and rn < ro
        and p_on.count(DOTS) == p_off.count(DOTS)
        and p_on.count(CONVS) == p_off.count(CONVS)
        and len(gm_on.cfg.layers) < len(gm_off.cfg.layers),
        f"elim trace runs {rn} reshapes/{len(p_on.ops)} ops vs {ro}/"
        f"{len(p_off.ops)} (fewer reshapes at equal matmul/conv "
        "counts; the off trace carries the flatten)"))


# ---------------------------------------------------------------------------
# quant audit
# ---------------------------------------------------------------------------
def int8_products(p: Probe) -> int:
    """int8 data-path products of a probed forward: K3 launches on the
    card, the plain int8 GEMM's calls on the CPU."""
    return (p.launches.get("int8_mm", 0)
            + p.plain.get("int8_matmul_reference", 0))


def _quant_audit(device, checks) -> Dict[str, int]:
    from cxxnet_tpu_torch.serve import Server
    off = _make_trainer(device, _CONF_BN,
                        "graph_passes = dead_layer_elim,fold_conv_bn\n")
    on = _make_trainer(device, _CONF_BN, f"graph_passes = {_QUANT_PASSES}\n")
    pin = _make_trainer(
        device, _CONF_BN.replace("nhidden = 3",
                                 "nhidden = 3\n  layer_quant = float"),
        f"graph_passes = {_QUANT_PASSES}\n")
    for tr in (off, on, pin):
        tr.calibrate_graph_passes(_batch(0))
    final = on.net_cfg.num_nodes - 1
    shape = (32, 1, 1, 36)

    def products(tr):
        p = _probe_infer(tr, final, shape, device)
        return int8_products(p), p.data_path_products(32)[1], p

    i8_on, fp_on, p_on = products(on)
    i8_off, fp_off, _ = products(off)
    i8_pin, fp_pin, _ = products(pin)
    checks.append(_check(
        "quant", "int8-data-path-engaged", i8_on == 2 and fp_on == 0,
        f"quantized forward: {i8_on} int8 products, {fp_on} float "
        "data-path products (want 2 and 0)"))
    checks.append(_check(
        "quant", "float-trace-vacuity-guard", i8_off == 0 and fp_off == 2,
        f"float (fold-only) forward: {i8_off} int8 / {fp_off} float "
        "data-path products (want 0 and 2)"))
    checks.append(_check(
        "quant", "layer_quant-float-pin-honored",
        i8_pin == 1 and fp_pin == 1,
        f"pinned forward: {i8_pin} int8 / {fp_pin} float data-path "
        "products (want 1 each)"))
    checks += _sync_checks("quant/infer", p_on)
    srv = Server(on, max_batch=8, max_wait_ms=1.0, replicas=2,
                 device=str(device))
    srv.warmup()
    n_warm = srv.executable_cache_size()
    gdata = on.stage_infer_rows(np.zeros((8, 1, 1, 36), np.float32))
    _sync(device)
    with torch.inference_mode(), Probe(device) as p:
        srv._graph.run(srv._slot.cparams, gdata, ())
    i8_srv, fp_srv = int8_products(p), p.data_path_products(8)[1]
    checks.append(_check(
        "quant/serve", "bucket-programs-int8-engaged",
        i8_srv == 2 and fp_srv == 0
        and srv.executable_cache_size() == n_warm,
        f"bucket-8 forward: {i8_srv} int8 / {fp_srv} float data-path "
        "products"))
    srv.start()
    rng = np.random.RandomState(11)
    futs = [srv.submit(rng.rand(1 + int(rng.randint(8)), 1, 1, 36)
                       .astype(np.float32)) for _ in range(30)]
    for f in futs:
        f.result(timeout=120)
    stats = srv.stop()
    n_after = srv.executable_cache_size()
    checks.append(_check(
        "quant/serve", "no-new-program-after-calibration",
        n_warm == len(srv.buckets) and n_after == n_warm
        and stats["errors"] == 0,
        f"{n_warm} -> {n_after} programs over {stats['batches']} batches "
        f"(buckets {list(srv.buckets)}, errors {stats['errors']})"))
    return {"int8_products": i8_on, "float_products_quant": fp_on,
            "quant_serve_programs": n_after}


# ---------------------------------------------------------------------------
# executable registry
# ---------------------------------------------------------------------------
def _executables_audit(checks) -> None:
    from cxxnet_tpu_torch import telemetry
    execs = telemetry.executables().snapshot()
    checks.append(_check("executables", "registry-non-empty",
                         len(execs) > 0, f"{len(execs)} registered"))
    kinds = {e["kind"] for e in execs}
    checks.append(_check(
        "executables", "covers-train-infer-serve",
        {"train", "infer", "serve"} <= kinds,
        f"kinds registered: {sorted(kinds)}"))
    required = {"fingerprint", "name", "kind", "shape", "arg_bytes",
                "device", "donated", "compile_s", "flops", "cost_bytes",
                "out_bytes", "dispatches", "dispatch_s", "last_used_ts"}
    bad = [e.get("name", "?") for e in execs if not required <= set(e)]
    checks.append(_check(
        "executables", "entry-schema", not bad,
        f"entries missing fields: {bad[:5]}" if bad
        else f"all {len(execs)} entries carry the schema"))
    dispatched = sum(1 for e in execs if e["dispatches"] > 0)
    checks.append(_check(
        "executables", "dispatch-counts-accumulate", dispatched > 0,
        f"{dispatched}/{len(execs)} entries saw dispatches"))
    train = [e for e in execs if e["kind"] == "train"]
    checks.append(_check(
        "executables", "train-in-place-footprint-recorded",
        bool(train) and all(e["donated"] for e in train),
        f"{len(train)} train entries, donated="
        f"{sorted({e['donated'] for e in train})}"))


# ---------------------------------------------------------------------------
# kernel routing on the card
# ---------------------------------------------------------------------------
IMAGENET = os.path.join(REPO, "examples", "ImageNet", "AlexNet.conf")
SEQ_MNIST = os.path.join(REPO, "examples", "LongSeq", "seq_mnist.conf")
# AlexNet.conf's int8 serving passes (the CLI's quantize_int8 run)
_ALEX_QUANT = "graph_passes=dead_layer_elim,fold_conv_bn,quantize_int8"


def conf_trainer(conf: str, overrides: Sequence[str] = ()):
    """A trainer as the CLI builds it from a shipped conf: the file
    unmodified, its iterator blocks split off (their files are never
    opened), the device from its `dev` (the card)."""
    from cxxnet_tpu_torch.main import LearnTask
    task = LearnTask()
    task.load_conf(conf, ["seed=7", "silent=1", "telemetry_steps=0"]
                   + list(overrides))
    tr = task.create_net()
    tr.init_model()
    return tr


def _routing_checks(target: str, p: Probe, want: Dict[str, int]
                    ) -> List[Dict[str, Any]]:
    got = {n: p.launches.get(n, 0) for n in want}
    plain = {n: c for n, c in p.plain.items() if c}
    bad = p.forbidden()
    return [_check(
        target, "kernel-routing",
        not p.error and got == want and not plain and not bad,
        p.error or (f"launches {got} (want {want}); plain versions "
                    f"{plain or 'none'}; library kernels "
                    f"{bad or 'none'}"))]


def _kernel_routing(device, checks) -> Dict[str, Any]:
    """AlexNet.conf served (bf16, bucket 64) and trained (b64), the int8
    AlexNet bucket and seq_mnist.conf's b100 step, each probed."""
    from cxxnet_tpu_torch.serve import Server
    out: Dict[str, Any] = {}
    rng = np.random.RandomState(3)
    alex = conf_trainer(IMAGENET, ["batch_size=64"])
    images = rng.rand(64, 3, 227, 227).astype(np.float32)
    srv = Server(alex, max_batch=64, ladder=[64], replicas=1,
                 device=str(device))
    srv.warmup()
    gdata = alex.stage_infer_rows(images)
    _sync(device)
    with torch.inference_mode(), Probe(device) as pf:
        srv._graph.run(srv._slot.cparams, gdata, ())
    checks += _routing_checks("alexnet serve[b=64] bf16", pf,
                              {"lrn_fwd": 2, "lrn_bwd": 0, "int8_mm": 0})
    ints, floats = pf.data_path_products(64)
    out["alexnet_float_products"] = floats
    from cxxnet_tpu_torch.io.data import DataBatch
    batch = DataBatch(data=images, label=rng.randint(
        0, 1000, (64, 1)).astype(np.float32))
    alex.update(batch)                                # warm
    staged = alex.stage_batch(batch)
    _sync(device)
    with Probe(device) as pt:
        alex.update(staged)
    checks += _routing_checks("alexnet train_step[b=64] bf16", pt,
                              {"lrn_fwd": 2, "lrn_bwd": 2})
    checks += _sync_checks("alexnet train_step[b=64] bf16", pt)
    out["alexnet_train"] = pt.launches
    del alex, srv, staged
    q = conf_trainer(IMAGENET, ["batch_size=64", _ALEX_QUANT])
    q.calibrate_graph_passes(DataBatch(data=images, label=batch.label))
    qsrv = Server(q, max_batch=64, ladder=[64], replicas=1,
                  device=str(device))
    qsrv.warmup()
    gq = q.stage_infer_rows(images)
    _sync(device)
    with torch.inference_mode(), Probe(device) as pq:
        qsrv._graph.run(qsrv._slot.cparams, gq, ())
    checks += _routing_checks("alexnet int8 serve[b=64]", pq,
                              {"int8_mm": 11, "lrn_fwd": 2})
    qi, qf = pq.data_path_products(64)
    checks.append(_check(
        "alexnet int8 serve[b=64]", "float-trace-vacuity-guard",
        floats >= 8 and qf == 0,
        f"the float bucket runs {floats} float data-path products, the "
        f"int8 bucket {qf} (the int8 trace removes them all)"))
    out["alexnet_int8"] = pq.launches
    del q, qsrv
    seq = conf_trainer(SEQ_MNIST)
    sb = DataBatch(
        data=rng.rand(seq.batch_size, *seq.net_cfg.input_shape)
        .astype(np.float32),
        label=rng.randint(0, 10, (seq.batch_size, 1)).astype(np.float32))
    seq.update(sb)
    staged = seq.stage_batch(sb)
    _sync(device)
    with Probe(device) as ps:
        seq.update(staged)
    checks += _routing_checks(
        f"seq_mnist train_step[b={seq.batch_size}]", ps,
        {"attn_fwd": 1, "attn_dq": 1, "attn_dkv": 1})
    out["seq_train"] = ps.launches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------
DEFERRED: List[Dict[str, str]] = []

_ATTN_CONF = """
netconfig=start
layer[0->1] = pos_embed:pe
layer[1->2] = attention:att
  nhead = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 4
layer[4->4] = softmax
netconfig=end
input_shape = 1,4,8
batch_size = 8
eta = 0.1
silent = 1
seed = 7
telemetry_steps = 0
"""

ZERO_CASES = {
    "zero-audit/stage2[data:2]": (_CONF, "mesh = data:2\nzero_stage = 2\n",
                                  (1, 1, 36)),
    "zero-audit/stage3[data:2]": (_CONF, "mesh = data:2\nzero_stage = 3\n",
                                  (1, 1, 36)),
    "zero-audit/tp[model:2]": (_ATTN_CONF, "mesh = model:2\n", (1, 4, 8)),
}


def _zero_worker() -> None:
    """One rank of a zero-audit case (CXN_* set by the parent; the case
    in CXN_AUDIT_CASE, the device in CXN_AUDIT_DEVICE): a warm-up step,
    then one step with every collective of the port logged. Prints one
    JSON report."""
    import json
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.parallel import distributed, tensor
    conf, extra, shape = ZERO_CASES[os.environ["CXN_AUDIT_CASE"]]
    tr = NetTrainer(device=os.environ["CXN_AUDIT_DEVICE"],
                    cfg=conf + extra + "param_server = dist\n"
                    "dist_init_deadline = 60\n")
    tr.init_model()
    rng = np.random.RandomState(1)
    lb = tr._local_batch

    def batch():
        return DataBatch(
            data=rng.randn(lb, *shape).astype(np.float32),
            label=rng.randint(0, 3, size=(lb, 1)).astype(np.float32))

    tr.update(batch())
    mesh = tr.mesh
    groups = {}
    if tr._msize > 1:
        groups[id(mesh.model_group)] = "model"
    if tr._dsize > 1:
        groups[id(mesh.group)] = "data"
    log: List[Tuple[str, str, int]] = []
    patches = _Patches()

    def logged(name, fn):
        def wrapped(t, group=None, *a, **k):
            log.append((name, groups.get(id(group), "world"),
                        int(t.numel())))
            return fn(t, group, *a, **k)
        return wrapped

    for name in ("all_reduce_", "all_gather", "reduce_scatter"):
        patches.patch(distributed, name,
                      logged(name, getattr(distributed, name)))
    tensor.reset()
    try:
        tr.update(batch())
    finally:
        patches.restore()
    z = tr._zero
    cut = (0 if z is None else sum(
        int(np.prod(tr._local_shapes[lk][pn])) for lk, pn, _, _ in z.cut))
    whole = sum(int(np.prod(s)) for d in tr._local_shapes.values()
                for s in d.values())
    rows = 2 * len(tr.train_metric) if tr.eval_train else 0
    print(json.dumps({
        "log": log, "calls": dict(tensor.calls), "cut": cut,
        "whole": whole, "rows": rows, "stage": tr._zero_run,
        "param_elems": sum(t.numel() for t in _leaves(tr.state["params"])),
    }), flush=True)


def _start_zero_case(case: str, device) -> List[Any]:
    """Start the two ranks of one zero-audit case (not waited for)."""
    import socket
    import subprocess
    import sys
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for r in range(2):
        env = dict(os.environ, CXN_COORDINATOR=f"127.0.0.1:{port}",
                   CXN_NUM_WORKER="2", CXN_WORKER_RANK=str(r),
                   CXN_AUDIT_CASE=case, OMP_NUM_THREADS="1",
                   CXN_AUDIT_DEVICE=("cuda:0" if device.type == "cuda"
                                     else "cpu"),
                   PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("CXN_LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch.analysis.graph_audit",
             "--zero-worker"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _finish_zero_case(case: str, procs) -> List[Dict[str, Any]]:
    """The two ranks' reports of a started zero-audit case."""
    import json
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    reps = []
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"zero-audit {case}: a rank failed "
                               f"({p.returncode}):\n{out[-2000:]}")
        reps.append(json.loads(out.strip().splitlines()[-1]))
    return reps


def _zero_audit(device, checks) -> Dict[str, Any]:
    """The zero audit (see the module docstring) over ZERO_CASES."""
    counts: Dict[str, Any] = {}
    # the cases' jobs side by side (each case its own store and group)
    started = {case: _start_zero_case(case, device) for case in ZERO_CASES}
    for case, procs in started.items():
        reps = _finish_zero_case(case, procs)
        counts[case] = {"log": reps[0]["log"], "calls": reps[0]["calls"]}
        for r, rep in enumerate(reps):
            tgt = f"{case}/rank{r}"
            log = rep["log"]
            ar = [n for op, g, n in log if op == "all_reduce_" and g != "model"]
            rs = [n for op, g, n in log if op == "reduce_scatter"]
            ag = [n for op, g, n in log if op == "all_gather" and g == "data"]
            if case.startswith("zero-audit/stage"):
                cut, whole = rep["cut"], rep["whole"]
                # the all-reduce: the loss, the uncut gradients and the
                # metric rows - no cut weight's gradient
                want_ar = 1 + (whole - cut) + rep["rows"]
                checks.append(_check(
                    tgt, "zero-reduce-scatter-present", rs == [cut]
                    and cut > 0, f"reduce-scatters {rs}, cut {cut}"))
                checks.append(_check(
                    tgt, "zero-no-full-grad-allreduce", ar == [want_ar],
                    f"all-reduces {ar}, want [{want_ar}] (loss + uncut "
                    "gradients + metric rows)"))
                checks.append(_check(
                    tgt, "zero-weight-all-gather-present",
                    ag == [cut // 2], f"data all-gathers {ag}, want one "
                    f"of {cut // 2} (the cut slices)"))
                if rep["stage"] >= 3:
                    checks.append(_check(
                        tgt, "zero3-params-stored-sharded",
                        rep["param_elems"] == whole - cut // 2,
                        f"{rep['param_elems']} param elements kept, want "
                        f"{whole - cut // 2}"))
            else:
                c = rep["calls"]
                checks.append(_check(
                    tgt, "tp-enter-gather-pairs",
                    c["enter"] >= c["gather"] > 0,
                    f"enter {c['enter']}, gather {c['gather']}"))
                checks.append(_check(
                    tgt, "tp-row-parallel-all-reduce", c["reduce"] == 1,
                    f"reduce {c['reduce']} (the attention projection)"))
                checks.append(_check(
                    tgt, "tp-no-data-collective",
                    not ar and not rs and not ag,
                    f"data-group collectives: {ar} {rs} {ag}"))
    return counts


def run_audit(device: str = DEFAULT_DEVICE,
              routing: Optional[bool] = None) -> Dict[str, Any]:
    """Run every target and check on `device` (the card unless asked
    for the CPU; with no card it raises). `routing` runs the card-only
    kernel-routing targets (default: on the card). Returns {platform,
    device, checks, counts, deferred, failed}."""
    dev = resolve_device(device)
    checks: List[Dict[str, Any]] = []
    counts: Dict[str, Any] = {}
    _train_targets(dev, checks)
    _eval_targets(dev, checks)
    counts.update(_recompile_audit(dev, checks))
    counts.update(_serve_audit(dev, checks))
    counts.update(_pass_audit(dev, checks))
    counts.update(_quant_audit(dev, checks))
    _executables_audit(checks)
    if routing is None:
        routing = dev.type == "cuda"
    if routing:
        counts["kernel_routing"] = _kernel_routing(dev, checks)
    counts["zero_audit"] = _zero_audit(dev, checks)
    return {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"),
        "checks": checks,
        "counts": counts,
        "deferred": DEFERRED,
        "failed": sum(1 for c in checks if not c["ok"]),
    }


if __name__ == "__main__":
    import sys as _sys
    if _sys.argv[1:] == ["--zero-worker"]:
        _zero_worker()
