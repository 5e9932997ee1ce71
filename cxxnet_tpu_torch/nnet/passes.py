"""Graph-level optimizing passes over the NetConfig DAG (counterpart of
cxxnet_tpu/nnet/passes.py; the port's own copy of the IR, the pattern
engine, the registry and all nine passes).

The trainer runs a `PassPipeline` of named `GraphPass`es: graph-stage
passes stamp the live NetConfig at build time (layer configs and the
per-layer dtype plan only - structure, and with it the checkpoint
format, is untouched); infer-stage passes run per requested output
node on a CLONE of the config, which only the inference forward uses.

- space_to_depth (graph): stamps `space_to_depth = 0|1` on each conv
  from `ops.conv.s2d_auto` (inert in the port's convolution, which
  computes the same sums either way);
- autocast (graph): under `dtype = bfloat16` a compute dtype per layer
  (`GraphModule.dtype_plan`, cast by `Network.forward`): batch_norm,
  lrn and the loss heads stay float32; `layer_dtype` pins a layer;
- dead_layer_elim (infer): prune layers not on a path to the target
  node (a kept share whose primary died is promoted);
- elim_reshape (infer): a flatten feeding one fullc is dropped and the
  fullc stamped `flatten_input = 1`;
- cse_share (infer): dedupe siblings that provably compute one value;
- fold_conv_bn (infer): fold a batch_norm into its conv/fullc with
  frozen calibration statistics (mean, rstd);
- merge_conv_1x1 (infer): contract conv + 1x1 conv into one conv;
- fuse_activation (infer): stamp `fused_act = relu` into a conv/fullc
  and absorb separate bias layers into its bias;
- quantize_int8 (infer): int8 post-training quantization of conv/fullc
  sites with a frozen per-tensor activation scale (calibration absmax
  / 127, Python float64) and a per-channel weight scale the trainer
  fills from the transformed float weights (`_fill_quant_scales`).

`make_param_fn` maps the live float32 params to the transformed
graph's params with torch ops: fold, merge and bias absorption from the
LIVE weights, then the int8 quantize stage (ops/int8.py) - only the
calibration statistics and scales are frozen.

One difference from the JAX package: `layer_obj` also returns None for
a layer type the port has not ported (the JAX package builds it), so
`cse_share` never dedupes such a layer - a net holding one cannot run
in the port anyway.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from cxxnet_tpu_torch.nnet.net_config import NetConfig

# layer types whose math is one big contraction - the autocast
# policy's bf16 set is "everything except the fragile ones", this set
# only documents the headline beneficiaries
_F32_SENSITIVE_TYPES = frozenset((
    "batch_norm", "lrn", "softmax", "l2_loss", "multi_logistic"))

# fold pattern: the producing layer types a batch_norm folds into
_FOLDABLE_TYPES = frozenset(("conv", "fullc"))

# fuse_activation pattern: producers that accept a `fused_act` stamp,
# and the elementwise layer types that fuse into them (bias layers
# absorb into the producer's bias; ONE activation ends the chain)
_ACT_PRODUCER_TYPES = frozenset(("conv", "fullc"))
_ACT_CHAIN_TYPES = frozenset(("bias", "relu"))
_ACT_TYPES = frozenset(("relu",))

# quantize_int8 pattern: the layer types whose data-path contraction
# has an int8 kernel (ops/int8.py); everything else - BN, LRN, the
# loss heads - stays float by construction
_QUANT_TYPES = frozenset(("conv", "fullc"))

# elim_reshape pattern: reshape-only layers, and the consumers that
# can absorb the flatten (fullc's apply flattens its input anyway -
# the `flatten_input = 1` stamp makes its shape inference agree)
_RESHAPE_TYPES = frozenset(("flatten",))
_RESHAPE_CONSUMER_TYPES = frozenset(("fullc",))


def dtype_name(d: torch.dtype) -> str:
    """"float32" / "bfloat16": a torch dtype as the JAX package names it
    (the autocast log and the tests compare plans by these names)."""
    return str(d).rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# the IR the passes transform
# ---------------------------------------------------------------------------
@dataclass
class FoldSite:
    """One folded conv/fullc + batch_norm pair: the live-params keys
    of both layers plus the frozen per-channel calibration statistics
    (mean of the BN input, rsqrt(var + eps))."""

    conv_key: str
    bn_key: str
    mean: np.ndarray
    rstd: np.ndarray


@dataclass
class MergeSite:
    """One conv + 1x1-conv pair collapsed into the first conv: the
    live-params keys of both convs. make_param_fn contracts
    `W' = W2 . W1` / `b' = W2 . b1 + b2` from the LIVE weights."""

    first_key: str
    second_key: str


@dataclass
class ActFuseSite:
    """One producer whose trailing bias layers were absorbed: the
    producer's live-params key plus the absorbed bias layers' keys
    (in chain order). The activation itself is a config stamp
    (`fused_act`), not a param transform."""

    producer_key: str
    bias_keys: List[str]


@dataclass
class QuantSite:
    """One int8-quantized conv/fullc: the live-params key, the frozen
    per-tensor activation scale (calibration absmax / 127), and the
    frozen per-channel weight scale. `wscale` is filled by the
    TRAINER after the pipeline runs (`_fill_quant_scales`) from the
    TRANSFORMED float weights - a folded or merged weight is
    quantized at its folded/merged values, not its raw checkpoint
    values; a site whose wscale was never filled executes float
    (make_param_fn skips its quantize stage)."""

    key: str
    act_scale: float
    wscale: Optional[np.ndarray] = None


@dataclass
class GraphModule:
    """A NetConfig DAG in flight through the pass pipeline.

    `param_keys[i]` is the LIVE params-pytree key layer i's weights
    come from (None for param-less or shared layers) - structural
    passes keep it aligned so `make_param_fn` can rebuild the
    transformed graph's params from the live train params no matter
    how indices shifted."""

    cfg: NetConfig
    batch_size: int
    compute_dtype: Any = None
    param_keys: List[Optional[str]] = field(default_factory=list)
    folds: List[FoldSite] = field(default_factory=list)
    merges: List[MergeSite] = field(default_factory=list)
    act_fuses: List[ActFuseSite] = field(default_factory=list)
    quants: List[QuantSite] = field(default_factory=list)
    dtype_plan: Dict[int, Any] = field(default_factory=dict)
    log: List[str] = field(default_factory=list)

    @classmethod
    def from_net_config(cls, cfg: NetConfig, batch_size: int,
                        compute_dtype: Any = None) -> "GraphModule":
        from cxxnet_tpu_torch.nnet.network import param_key
        keys: List[Optional[str]] = []
        for idx, info in enumerate(cfg.layers):
            keys.append(None if info.is_shared
                        else param_key(cfg, idx))
        return cls(cfg=cfg, batch_size=batch_size,
                   compute_dtype=compute_dtype, param_keys=keys)

    # -- structural edits -------------------------------------------------
    def remove_layers(self, indices: Sequence[int]) -> None:
        """Drop layers by index, remapping share back-references and
        keeping layercfg/param_keys/dtype_plan aligned."""
        drop = set(indices)
        if not drop:
            return
        cfg = self.cfg
        remap: Dict[int, int] = {}
        for old in range(len(cfg.layers)):
            if old not in drop:
                remap[old] = len(remap)
        for old in drop:
            info = cfg.layers[old]
            if any(li.primary_layer_index == old
                   for i, li in enumerate(cfg.layers)
                   if i not in drop and li.is_shared):
                raise ValueError(
                    f"cannot remove layer {old} "
                    f"({info.type_name}): a kept share[...] layer "
                    "references it as primary")
        cfg.layers = [li for i, li in enumerate(cfg.layers)
                      if i not in drop]
        cfg.layercfg = [c for i, c in enumerate(cfg.layercfg)
                        if i not in drop]
        self.param_keys = [k for i, k in enumerate(self.param_keys)
                           if i not in drop]
        self.dtype_plan = {remap[i]: d for i, d in
                           self.dtype_plan.items() if i in remap}
        for li in cfg.layers:
            if li.is_shared:
                li.primary_layer_index = remap[li.primary_layer_index]
        cfg.layer_name_map = {
            li.name: i for i, li in enumerate(cfg.layers)
            if li.name and not li.is_shared}

    def param_map(self) -> Dict[str, str]:
        """Transformed-graph param key -> live-params key."""
        from cxxnet_tpu_torch.nnet.network import param_key
        out: Dict[str, str] = {}
        for idx, info in enumerate(self.cfg.layers):
            if info.is_shared or self.param_keys[idx] is None:
                continue
            out[param_key(self.cfg, idx)] = self.param_keys[idx]
        return out


@dataclass
class PassContext:
    """Per-run inputs the passes read (never mutate)."""

    #: requested output node for infer-stage passes (None = train
    #: graph, where only graph-stage passes apply)
    target_node: Optional[int] = None
    #: bn live-params key -> (mean, rstd) calibration stats; None =
    #: not calibrated yet (fold defers)
    fold_stats: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None
    #: quant-eligible live-params key -> activation absmax from the
    #: calibration sweep; None = not calibrated yet (quantize defers)
    quant_stats: Optional[Dict[str, float]] = None


# ---------------------------------------------------------------------------
# pattern-rewrite engine: DAG queries shared by every pass
# ---------------------------------------------------------------------------
def node_consumers(cfg: NetConfig) -> Dict[int, List[int]]:
    """node index -> layer indices reading it (declaration order)."""
    cons: Dict[int, List[int]] = {}
    for idx, info in enumerate(cfg.layers):
        for j in info.nindex_in:
            cons.setdefault(j, []).append(idx)
    return cons


def share_primaries(cfg: NetConfig) -> set:
    """Layer indices that are the primary of some share[...] layer."""
    return {li.primary_layer_index for li in cfg.layers if li.is_shared}


def find_fold_sites(cfg: NetConfig) -> List[Tuple[int, int]]:
    """(producer_idx, bn_idx) pairs matching the fold pattern: a
    non-shared conv/fullc whose single output node feeds EXACTLY one
    batch_norm (self-loop BN allowed - later readers then see the
    post-BN value, which the folded layer reproduces). Weight-shared
    layers are excluded on both sides: folding a shared weight would
    specialize it per site."""
    sites: List[Tuple[int, int]] = []
    primaries = share_primaries(cfg)
    cons = node_consumers(cfg)
    for j, bn in enumerate(cfg.layers):
        if (bn.type_name != "batch_norm" or bn.is_shared
                or j in primaries):
            continue
        if len(bn.nindex_in) != 1 or len(bn.nindex_out) != 1:
            continue
        a = bn.nindex_in[0]
        writers = [i for i, li in enumerate(cfg.layers)
                   if a in li.nindex_out and i != j]
        if len(writers) != 1:
            continue
        i = writers[0]
        conv = cfg.layers[i]
        if (i > j or conv.type_name not in _FOLDABLE_TYPES
                or conv.is_shared or i in primaries):
            continue
        if len(conv.nindex_out) != 1 or conv.nindex_out[0] != a:
            continue
        readers = [c for c in cons.get(a, ()) if c != j]
        if bn.nindex_out[0] == a:
            # self-loop BN overwrites a: only a reader BETWEEN the
            # conv and the bn would see the raw conv output
            if any(i < c < j for c in readers):
                continue
        elif readers:
            continue
        sites.append((i, j))
    return sites


def layer_quant_pin(cfg: NetConfig, idx: int) -> str:
    """The effective `layer_quant` config of layer `idx` ("" = no
    pin, policy applies). Shared layers resolve through their
    primary's config like every other structured param."""
    src = (cfg.layers[idx].primary_layer_index
           if cfg.layers[idx].is_shared else idx)
    pin = ""
    for k, v in cfg.defcfg + cfg.layercfg[src]:
        if k == "layer_quant":
            pin = v
    return pin


def find_quant_sites(cfg: NetConfig) -> List[int]:
    """Layer indices matching the quantize_int8 pattern: non-shared,
    non-primary conv/fullc layers not pinned `layer_quant = float`.
    The ONE definition - the pass matches the transformed graph with
    it and the trainer matches the live graph for calibration taps,
    so the two can never disagree on what needs an activation
    range."""
    primaries = share_primaries(cfg)
    out: List[int] = []
    for idx, info in enumerate(cfg.layers):
        if (info.type_name not in _QUANT_TYPES or info.is_shared
                or idx in primaries):
            continue
        if layer_quant_pin(cfg, idx) == "float":
            continue
        out.append(idx)
    return out


def node_writers(cfg: NetConfig, node: int) -> List[int]:
    """Layer indices writing a node (declaration order)."""
    return [k for k, li in enumerate(cfg.layers)
            if node in li.nindex_out]


def layer_obj(cfg: NetConfig, idx: int):
    """Instantiate layer `idx` with its effective (defcfg + layercfg)
    config - the pattern matchers' way to read structured layer
    params (kernel size, stride, groups) without building a Network.
    Shared layers resolve to their primary's object. None when the
    config is rejected (an invalid layer cannot match a pattern)."""
    from cxxnet_tpu_torch.layers import create_layer
    info = cfg.layers[idx]
    src = info.primary_layer_index if info.is_shared else idx
    try:
        lay = create_layer(cfg.layers[src].type_name,
                           cfg.layers[src].name)
        for k, v in cfg.defcfg + cfg.layercfg[src]:
            lay.set_param(k, v)
    except (KeyError, ValueError, NotImplementedError):
        return None
    return lay


def next_fusable_link(cfg: NetConfig, cons, primaries, node: int,
                      last_writer: int,
                      target: Optional[int]) -> Optional[int]:
    """The single fusable elementwise consumer of `node` downstream
    of `last_writer`, or None. Mirrors find_fold_sites' reader rules:
    a self-loop layer may have later readers (they see the post-layer
    value the fused producer reproduces) but none between the writer
    and itself; a new-node layer must be the node's sole reader."""
    if node == target:
        return None  # the caller asked for this intermediate value
    readers = sorted(cons.get(node, ()))
    after = [c for c in readers if c > last_writer]
    if not after:
        return None
    j = after[0]
    info = cfg.layers[j]
    if (info.is_shared or j in primaries
            or info.type_name not in _ACT_CHAIN_TYPES
            or len(info.nindex_in) != 1 or len(info.nindex_out) != 1
            or info.nindex_in[0] != node):
        return None
    if any(last_writer < w < j for w in node_writers(cfg, node)):
        return None  # a foreign writer clobbers the chain value
    if info.nindex_out[0] == node:
        if any(last_writer < c < j for c in readers if c != j):
            return None
        return j
    if len(after) > 1:
        return None  # a second reader needs the raw value
    return j


def find_act_chains(cfg: NetConfig, target: Optional[int],
                    dtype_plan: Optional[Dict[int, Any]] = None,
                    ) -> List[Tuple[int, List[int]]]:
    """(producer_idx, [chain layer indices]) for every conv/fullc
    whose output feeds a fusable bias*/relu chain. Bias layers absorb
    until ONE activation ends the chain; weight-shared layers are
    excluded on both sides, and a chain stops at the first layer
    whose per-layer dtype stamp differs from the producer's (a fused
    layer runs at the producer's dtype - a `layer_dtype` pin on the
    bias/relu must survive)."""
    primaries = share_primaries(cfg)
    cons = node_consumers(cfg)
    out: List[Tuple[int, List[int]]] = []
    claimed: set = set()
    for i, prod in enumerate(cfg.layers):
        if (prod.type_name not in _ACT_PRODUCER_TYPES or prod.is_shared
                or i in primaries or len(prod.nindex_out) != 1):
            continue
        if any(k == "fused_act"
               for k, _ in cfg.defcfg + cfg.layercfg[i]):
            continue  # already carries a stamp: nothing to add
        node, last = prod.nindex_out[0], i
        chain: List[int] = []
        while True:
            j = next_fusable_link(cfg, cons, primaries, node, last,
                                  target)
            if (j is None or j in claimed
                    or (dtype_plan or {}).get(j)
                    != (dtype_plan or {}).get(i)):
                break
            chain.append(j)
            node, last = cfg.layers[j].nindex_out[0], j
            if cfg.layers[j].type_name in _ACT_TYPES:
                break  # bias past the activation must stay separate
        if chain:
            out.append((i, chain))
            claimed.update(chain)
    return out


def find_merge_site(cfg: NetConfig, target: Optional[int],
                    dtype_plan: Optional[Dict[int, Any]] = None,
                    ) -> Optional[Tuple[int, int]]:
    """First (conv_idx, onexone_idx) pair matching the 1x1-merge
    pattern, or None: an ungrouped conv whose single output node
    feeds EXACTLY one ungrouped 1x1/stride-1/pad-0 conv, neither
    weight-shared, no activation stamped on either, and the
    intermediate node not the requested output. Convs with DIFFERENT
    per-layer dtype stamps never merge - the merged conv runs at the
    first conv's dtype, which would silently override the other
    layer's `layer_dtype` pin (explicit-keys-always-win)."""
    primaries = share_primaries(cfg)
    cons = node_consumers(cfg)
    for j, second in enumerate(cfg.layers):
        if (second.type_name != "conv" or second.is_shared
                or j in primaries or len(second.nindex_in) != 1
                or len(second.nindex_out) != 1
                or second.nindex_out[0] == second.nindex_in[0]):
            continue
        a = second.nindex_in[0]
        if a == target:
            continue
        obj2 = layer_obj(cfg, j)
        if (obj2 is None or obj2.param.kernel_height != 1
                or obj2.param.kernel_width != 1
                or obj2.param.stride != 1
                or obj2.param.pad_y or obj2.param.pad_x
                or obj2.param.num_group != 1
                or getattr(obj2, "fused_act", "")):
            continue
        writers = node_writers(cfg, a)
        if len(writers) != 1 or writers[0] >= j:
            continue
        i = writers[0]
        first = cfg.layers[i]
        if (first.type_name != "conv" or first.is_shared
                or i in primaries or len(first.nindex_out) != 1):
            continue
        if (dtype_plan or {}).get(i) != (dtype_plan or {}).get(j):
            continue  # differing dtype stamps: a pin must survive
        if ((layer_quant_pin(cfg, i) == "float")
                != (layer_quant_pin(cfg, j) == "float")):
            # the merged conv runs at ONE quantization setting, and
            # only "float" excludes a site (find_quant_sites) - ""
            # and an explicit "int8" are the same effective route,
            # so only a float-vs-quantized mismatch would silently
            # override a pin (explicit-keys-always-win, the
            # layer_dtype exclusion rule applied to the quant axis)
            continue
        if [c for c in cons.get(a, ()) if c != j]:
            continue  # another reader needs the intermediate value
        obj1 = layer_obj(cfg, i)
        if (obj1 is None or obj1.param.num_group != 1
                or getattr(obj1, "fused_act", "")):
            continue
        return i, j
    return None


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------
class GraphPass:
    """One named transform over a GraphModule. `stage` declares when
    it runs: "graph" passes apply to the train+eval network at build
    time and must preserve values and checkpoint structure; "infer"
    passes apply per requested output node to the clone the inference
    executables are built from."""

    name: str = ""
    stage: str = "graph"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        raise NotImplementedError


PASS_REGISTRY: Dict[str, Type[GraphPass]] = {}

# canonical application order (infer passes prune first so the fold
# never sees - or folds - a dead subgraph; elim_reshape/cse next so
# cleanup/dedupe exposes single-consumer fold/merge sites;
# fuse_activation after the structural rewrites so chains uncovered
# by the fold and the 1x1 merge still fuse; quantize_int8 LAST so it
# quantizes the final transformed layers - a folded/merged conv is
# quantized once, at its composed weights)
_CANONICAL_ORDER = ("space_to_depth", "autocast",
                    "dead_layer_elim", "elim_reshape", "cse_share",
                    "fold_conv_bn", "merge_conv_1x1",
                    "fuse_activation", "quantize_int8")


def register_pass(cls: Type[GraphPass]) -> Type[GraphPass]:
    assert cls.name, "pass class must define a name"
    PASS_REGISTRY[cls.name] = cls
    return cls


def resolve_pass_name(name: str) -> str:
    """Validate a pass name with did-you-mean (the `serve_max_batchh`
    precedent applied to pass names: a typo'd pass must cost an error
    with a suggestion, never a silently-unoptimized run)."""
    if name in PASS_REGISTRY:
        return name
    hint = difflib.get_close_matches(name, PASS_REGISTRY.keys(), n=1,
                                     cutoff=0.6)
    msg = f"unknown graph pass '{name}'"
    if hint:
        msg += f" (did you mean '{hint[0]}'?)"
    raise ValueError(
        msg + f"; available passes: {', '.join(sorted(PASS_REGISTRY))}")


@register_pass
class SpaceToDepthPass(GraphPass):
    """Stamp the space-to-depth input-conv rewrite decision onto the
    DAG (module docstring). Value-identical to the in-op auto
    heuristic by construction: both evaluate `ops.conv.s2d_auto`."""

    name = "space_to_depth"
    stage = "graph"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        from cxxnet_tpu_torch.ops.conv import s2d_auto

        def unstamped(idx, info):
            return (info.type_name == "conv" and not info.is_shared
                    and not any(k == "space_to_depth"
                                for k, _ in (gm.cfg.defcfg
                                             + gm.cfg.layercfg[idx])))

        if not any(unstamped(i, li)
                   for i, li in enumerate(gm.cfg.layers)):
            # nothing to stamp: skip the shape-inference Network
            # build entirely (the common MLP/no-conv case)
            return gm
        from cxxnet_tpu_torch.nnet.network import Network
        net = Network(gm.cfg, gm.batch_size)
        for idx, info in enumerate(gm.cfg.layers):
            if not unstamped(idx, info):
                continue
            lay = net.layer_objs[idx]
            in_ch = net.node_shapes[info.nindex_in[0]][1]
            on = s2d_auto(in_ch, lay.param.stride,
                          lay.param.kernel_height,
                          lay.param.kernel_width, lay.param.num_group)
            gm.cfg.layercfg[idx].append(
                ("space_to_depth", "1" if on else "0"))
            gm.log.append(
                f"space_to_depth: conv[{idx}] in_ch={in_ch} "
                f"stride={lay.param.stride} -> {int(on)}")
        return gm


@register_pass
class AutocastPass(GraphPass):
    """Stamp a compute dtype per layer (module docstring). A no-op
    under f32 compute; under bf16 the fragile layer types stay f32
    and `layer_dtype = float32|bfloat16` pins individual layers."""

    name = "autocast"
    stage = "graph"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        if gm.compute_dtype is None or gm.compute_dtype == torch.float32:
            gm.log.append("autocast: f32 compute, nothing to stamp")
            return gm
        parse = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        for idx, info in enumerate(gm.cfg.layers):
            src = (info.primary_layer_index if info.is_shared else idx)
            ltype = gm.cfg.layers[src].type_name
            override = ""
            for k, v in gm.cfg.defcfg + gm.cfg.layercfg[src]:
                if k == "layer_dtype":
                    override = v
            if override:
                if override not in parse:
                    raise ValueError(
                        "layer_dtype must be float32 or bfloat16, "
                        f"got {override!r}")
                d = parse[override]
            elif ltype in _F32_SENSITIVE_TYPES:
                d = torch.float32
            else:
                d = gm.compute_dtype
            gm.dtype_plan[idx] = d
            gm.log.append(f"autocast: layer[{idx}] {ltype} -> "
                          f"{dtype_name(d)}")
        return gm


@register_pass
class DeadLayerElimPass(GraphPass):
    """Prune layers not on a path to the requested output node
    (module docstring)."""

    name = "dead_layer_elim"
    stage = "infer"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        if ctx.target_node is None:
            return gm
        cfg = gm.cfg
        needed = {ctx.target_node}
        keep: set = set()
        for idx in reversed(range(len(cfg.layers))):
            info = cfg.layers[idx]
            if any(o in needed for o in info.nindex_out):
                keep.add(idx)
                needed.update(info.nindex_in)
        if ctx.target_node >= cfg.num_nodes:
            raise ValueError(
                f"dead_layer_elim: unknown target node "
                f"{ctx.target_node}")
        # kept share layers whose primary died: promote to primary -
        # the weights arrive through the param map, so the dead
        # ancestor chain need not be retained for them
        for idx in sorted(keep):
            info = cfg.layers[idx]
            if not info.is_shared:
                continue
            prim = info.primary_layer_index
            if prim in keep:
                continue
            primary = cfg.layers[prim]
            info.type_name = primary.type_name
            info.primary_layer_index = -1
            info.name = ""
            cfg.layercfg[idx] = list(cfg.layercfg[prim])
            gm.param_keys[idx] = gm.param_keys[prim]
            gm.log.append(
                f"dead_layer_elim: promoted share[{idx}] to primary "
                f"(its primary {prim} is dead)")
        dropped = [i for i in range(len(cfg.layers)) if i not in keep]
        if dropped:
            gm.log.append(
                f"dead_layer_elim: pruned {len(dropped)}/"
                f"{len(cfg.layers)} layers not reaching node "
                f"{ctx.target_node}")
        gm.remove_layers(dropped)
        return gm


@register_pass
class FoldConvBNPass(GraphPass):
    """Fold conv/fullc + batch_norm chains using frozen calibration
    statistics (module docstring). Defers (logs, no rewrite) until
    `ctx.fold_stats` exists; skips any site whose raw pre-BN value is
    the requested output."""

    name = "fold_conv_bn"
    stage = "infer"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        sites = find_fold_sites(gm.cfg)
        if not sites:
            return gm
        if ctx.fold_stats is None:
            gm.log.append(
                f"fold_conv_bn: {len(sites)} site(s) deferred - no "
                "calibration stats yet")
            return gm
        drop: List[int] = []
        for i, j in sites:
            conv, bn = gm.cfg.layers[i], gm.cfg.layers[j]
            bn_key, conv_key = gm.param_keys[j], gm.param_keys[i]
            stats = ctx.fold_stats.get(bn_key)
            if stats is None:
                gm.log.append(
                    f"fold_conv_bn: no stats for {bn_key}, skipped")
                continue
            if (bn.nindex_out[0] != bn.nindex_in[0]
                    and bn.nindex_in[0] == ctx.target_node):
                # the caller asked for the RAW conv output
                gm.log.append(
                    f"fold_conv_bn: target node is {conv_key}'s raw "
                    "output, site skipped")
                continue
            conv.nindex_out = list(bn.nindex_out)
            gm.folds.append(FoldSite(conv_key=conv_key, bn_key=bn_key,
                                     mean=stats[0], rstd=stats[1]))
            drop.append(j)
            gm.log.append(
                f"fold_conv_bn: folded {bn_key} into {conv_key}")
        gm.remove_layers(drop)
        return gm


@register_pass
class CseSharePass(GraphPass):
    """Common-subexpression sharing (module docstring): dedupe
    sibling layers that provably compute the same value - same input
    nodes AND same function (same live-params source for weighted
    layers, or identical type+config for param-less ones). Runs to a
    fixpoint so a dedupe that makes two downstream siblings identical
    cascades."""

    name = "cse_share"
    stage = "infer"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        while self._sweep(gm, ctx):
            pass
        return gm

    @staticmethod
    def _signature(gm: GraphModule, idx: int):
        from cxxnet_tpu_torch.layers.loss import LossLayer
        cfg = gm.cfg
        info = cfg.layers[idx]
        if (len(info.nindex_out) != 1
                or info.nindex_out[0] in info.nindex_in):
            return None  # multi-output or self-loop: not a candidate
        if node_writers(cfg, info.nindex_out[0]) != [idx]:
            return None  # aliased output node
        obj = layer_obj(cfg, idx)
        if obj is None or isinstance(obj, LossLayer):
            return None
        src = info.primary_layer_index if info.is_shared else idx
        # layers stamped with different compute dtypes produce
        # different values - never "the same function"
        plan_d = gm.dtype_plan.get(idx)
        if obj.param_tags():
            # weighted layer: identical only when the params COME from
            # the same place (a primary and its share[...], or two
            # shares of one primary) - equal weights of two distinct
            # primaries cannot be proven from the graph
            return ("params", src, tuple(info.nindex_in), plan_d)
        return ("pure", cfg.layers[src].type_name,
                tuple(cfg.layercfg[src]), tuple(info.nindex_in),
                plan_d)

    def _sweep(self, gm: GraphModule, ctx: PassContext) -> bool:
        cfg = gm.cfg
        groups: Dict[Any, List[int]] = {}
        for idx in range(len(cfg.layers)):
            sig = self._signature(gm, idx)
            if sig is not None:
                groups.setdefault(sig, []).append(idx)
        drops: List[int] = []
        remap: Dict[int, int] = {}
        for members in groups.values():
            if len(members) < 2:
                continue
            kept = members[0]
            kept_info = cfg.layers[kept]
            kept_src = (kept_info.primary_layer_index
                        if kept_info.is_shared else kept)
            for j in members[1:]:
                dj = cfg.layers[j].nindex_out[0]
                if dj == ctx.target_node:
                    continue  # the duplicate's node IS the output
                # shares of a dropped primary re-point to the kept
                # duplicate's param source (same params by the
                # signature) - the dead-primary promotion machinery's
                # rule applied sideways
                for s_li in cfg.layers:
                    if (s_li.is_shared
                            and s_li.primary_layer_index == j):
                        s_li.primary_layer_index = kept_src
                remap[dj] = kept_info.nindex_out[0]
                drops.append(j)
                gm.log.append(
                    f"cse_share: layer[{j}] duplicates layer[{kept}]"
                    f" ({cfg.layers[kept_src].type_name}); consumers "
                    f"re-read node {kept_info.nindex_out[0]}")
        if not drops:
            return False
        for li in cfg.layers:
            li.nindex_in = [remap.get(n, n) for n in li.nindex_in]
        gm.remove_layers(drops)
        return True


@register_pass
class MergeConv1x1Pass(GraphPass):
    """Collapse conv + 1x1-conv chains into one conv via live weight
    contraction (module docstring). Runs to a fixpoint so a
    conv->1x1->1x1 tower folds flat."""

    name = "merge_conv_1x1"
    stage = "infer"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        while True:
            site = find_merge_site(gm.cfg, ctx.target_node,
                                   gm.dtype_plan)
            if site is None:
                return gm
            i, j = site
            cfg = gm.cfg
            first_key, second_key = gm.param_keys[i], gm.param_keys[j]
            obj2 = layer_obj(cfg, j)
            # the merged conv keeps the first conv's geometry (kernel,
            # stride, pad, s2d stamp) and takes the second's output
            # width; its weights/bias arrive contracted via the param
            # function, so no init-time config beyond nchannel changes
            cfg.layercfg[i].append(
                ("nchannel", str(obj2.param.num_channel)))
            cfg.layers[i].nindex_out = list(cfg.layers[j].nindex_out)
            gm.merges.append(MergeSite(first_key=first_key,
                                       second_key=second_key))
            gm.remove_layers([j])
            gm.log.append(
                f"merge_conv_1x1: contracted {second_key} (1x1) into "
                f"{first_key}")


@register_pass
class FuseActivationPass(GraphPass):
    """Stamp trailing relu chains into their conv/fullc producer and
    absorb separate bias layers into the producer's bias (module
    docstring). Runs LAST in canonical order so chains exposed by
    fold_conv_bn / merge_conv_1x1 fuse too."""

    name = "fuse_activation"
    stage = "infer"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        cfg = gm.cfg
        chains = find_act_chains(cfg, ctx.target_node, gm.dtype_plan)
        if not chains:
            return gm
        drops: List[int] = []
        for i, chain in chains:
            bias_keys = [gm.param_keys[j] for j in chain
                         if cfg.layers[j].type_name == "bias"]
            act = next((cfg.layers[j].type_name for j in chain
                        if cfg.layers[j].type_name in _ACT_TYPES), "")
            cfg.layers[i].nindex_out = list(
                cfg.layers[chain[-1]].nindex_out)
            if act:
                cfg.layercfg[i].append(("fused_act", act))
            if bias_keys:
                gm.act_fuses.append(ActFuseSite(
                    producer_key=gm.param_keys[i],
                    bias_keys=bias_keys))
            drops.extend(chain)
            gm.log.append(
                f"fuse_activation: {gm.param_keys[i]} absorbs "
                f"{len(bias_keys)} bias layer(s)"
                + (f" + {act}" if act else ""))
        gm.remove_layers(drops)
        return gm


@register_pass
class ElimReshapePass(GraphPass):
    """Eliminate flatten layers feeding a single fullc (module
    docstring): the consumer re-reads the flatten's input node and
    gets a `flatten_input = 1` stamp so its shape inference accepts
    the 4-D node (its apply flattens in the same memory order, so the
    rewrite is bitwise value-identical). Runs to a fixpoint."""

    name = "elim_reshape"
    stage = "infer"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        while True:
            hit = self._find(gm.cfg, ctx.target_node)
            if hit is None:
                return gm
            i, j = hit
            cfg = gm.cfg
            gm.log.append(
                f"elim_reshape: dropped {cfg.layers[i].type_name}"
                f"[{i}]; fullc[{j}] consumes node "
                f"{cfg.layers[i].nindex_in[0]} directly")
            cfg.layers[j].nindex_in = [cfg.layers[i].nindex_in[0]]
            cfg.layercfg[j].append(("flatten_input", "1"))
            gm.remove_layers([i])

    @staticmethod
    def _find(cfg: NetConfig,
              target: Optional[int]) -> Optional[Tuple[int, int]]:
        primaries = share_primaries(cfg)
        cons = node_consumers(cfg)
        for i, info in enumerate(cfg.layers):
            if (info.type_name not in _RESHAPE_TYPES or info.is_shared
                    or i in primaries or len(info.nindex_in) != 1
                    or len(info.nindex_out) != 1
                    or info.nindex_out[0] == info.nindex_in[0]):
                continue
            a = info.nindex_out[0]
            if a == target:
                continue  # the caller asked for the flat view
            if node_writers(cfg, a) != [i]:
                continue  # aliased output node
            readers = cons.get(a, [])
            if len(readers) != 1:
                continue  # a second reader still needs the flat node
            j = readers[0]
            cinfo = cfg.layers[j]
            if (j <= i or cinfo.is_shared or j in primaries
                    or cinfo.type_name not in _RESHAPE_CONSUMER_TYPES
                    or len(cinfo.nindex_in) != 1):
                continue
            if any(i < w < j
                   for w in node_writers(cfg, info.nindex_in[0])):
                # a self-loop between flatten and the fullc rewrites
                # the input node; the fullc would read the wrong value
                continue
            return i, j
        return None


@register_pass
class QuantizeInt8Pass(GraphPass):
    """Int8 post-training quantization of eligible conv/fullc layers
    (module docstring). Defers (logs, no sites) until the calibration
    sweep recorded activation ranges (`ctx.quant_stats`); the
    per-channel weight scales are filled by the trainer AFTER the
    pipeline runs, from the transformed float weights."""

    name = "quantize_int8"
    stage = "infer"

    def run(self, gm: GraphModule, ctx: PassContext) -> GraphModule:
        from cxxnet_tpu_torch.ops.int8 import act_scale
        sites = find_quant_sites(gm.cfg)
        if not sites:
            return gm
        if ctx.quant_stats is None:
            gm.log.append(
                f"quantize_int8: {len(sites)} site(s) deferred - no "
                "calibration stats yet")
            return gm
        for idx in sites:
            key = gm.param_keys[idx]
            amax = (ctx.quant_stats.get(key)
                    if key is not None else None)
            if amax is None:
                gm.log.append(
                    f"quantize_int8: no activation stats for {key}, "
                    "site stays float")
                continue
            gm.quants.append(QuantSite(
                key=key,
                act_scale=act_scale(amax)))
            gm.log.append(
                f"quantize_int8: {key} -> int8 (activation absmax "
                f"{float(amax):.4g})")
        return gm


# ---------------------------------------------------------------------------
# params of a transformed graph, from the live train params
# ---------------------------------------------------------------------------
def make_param_fn(gm: GraphModule, quantize: bool = True):
    """Function: live float32 train params -> the transformed graph's
    params (torch ops on the params' device). Key remaps are free; fold
    sites compute `W' = W * (slope * rstd)` and `b' = (b - mean) * k +
    beta` from the LIVE weights, with only mean/rstd frozen at
    calibration (rstd precomputed). Merge sites contract `W' = W2 . W1`
    / `b' = W2 . b1 + b2` and act-fuse sites absorb separate bias-layer
    params (`b' = b + sum(b_i)`) - applied in stages after the folds,
    each reading the previous stage's transform of the same live key.
    Quant sites run LAST: the int8 weights are one round/clip/convert
    of the staged float weight against the FROZEN per-channel scale
    (ops/int8.py), so they too follow the live params - only the scales
    are calibration constants. `quantize=False` yields the float view
    of the same transforms (the trainer evaluates it once to freeze the
    weight scales)."""
    pairs = list(gm.param_map().items())

    def param_fn(params):
        cur: Dict[str, Any] = {}

        def live(key):
            return cur.get(key, params.get(key))

        for site in gm.folds:
            if site.conv_key not in params:
                continue
            conv_p, bn_p = params[site.conv_key], params[site.bn_key]
            dev = bn_p["slope"].device
            k = bn_p["slope"] * torch.as_tensor(site.rstd, device=dev)
            w = conv_p["wmat"]
            kw = k.reshape((-1,) + (1,) * (w.dim() - 1))
            bias = conv_p.get("bias", torch.zeros_like(k))
            cur[site.conv_key] = {
                "wmat": w * kw.to(w.dtype),
                "bias": (bias - torch.as_tensor(site.mean, device=dev)) * k
                        + bn_p["bias"],
            }
        for site in gm.merges:
            # BOTH convs read through live(): either side may carry
            # an earlier fold's transform, and a missing key skips the
            # transform like the fold guard above
            p1, p2 = live(site.first_key), live(site.second_key)
            if p1 is None or p2 is None:
                continue
            w1, w2 = p1["wmat"], p2["wmat"]
            # (O2, O1, 1, 1) -> (O2, O1); contract over the first
            # conv's output channels - a weight-sized product
            k2 = w2.reshape(w2.shape[0], w2.shape[1])
            entry = {"wmat": torch.einsum("oi,i...->o...",
                                          k2.to(w1.dtype), w1)}
            b1, b2 = p1.get("bias"), p2.get("bias")
            if b1 is not None:
                b = k2 @ b1
                entry["bias"] = b + b2 if b2 is not None else b
            elif b2 is not None:
                entry["bias"] = b2
            cur[site.first_key] = entry
        for site in gm.act_fuses:
            src = live(site.producer_key)
            if src is None or any(bk not in params
                                  for bk in site.bias_keys):
                continue
            p = dict(src)
            b = p.get("bias")
            for bk in site.bias_keys:
                extra = params[bk]["bias"]
                b = extra if b is None else b + extra
            if b is not None:
                p["bias"] = b
            cur[site.producer_key] = p
        if quantize:
            from cxxnet_tpu_torch.ops import int8 as int8_ops
            for site in gm.quants:
                if site.wscale is None:
                    continue  # scales never frozen: the site runs float
                src = live(site.key)
                if src is None or "wmat" not in src:
                    continue
                dev = src["wmat"].device
                entry = {
                    "wmat_q": int8_ops.quantize_weight(src["wmat"],
                                                       site.wscale),
                    "wscale": torch.as_tensor(
                        np.asarray(site.wscale, np.float32), device=dev),
                    "ascale": torch.tensor(site.act_scale,
                                           dtype=torch.float32, device=dev),
                }
                b = src.get("bias")
                if b is not None:
                    entry["bias"] = b
                cur[site.key] = entry

        out = {}
        for new_key, live_key in pairs:
            v = live(live_key)
            if v is not None:
                out[new_key] = v
        return out

    return param_fn


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
class PassPipeline:
    """An ordered set of GraphPasses (canonical order, module
    docstring). Built from the `graph_passes = a,b,...` config key
    plus the per-pass `pass_<name> = 0|1` toggles; unknown names get
    did-you-mean errors."""

    def __init__(self, passes: Sequence[GraphPass]):
        order = {n: i for i, n in enumerate(_CANONICAL_ORDER)}
        self.passes = sorted(passes,
                             key=lambda p: order.get(p.name, 99))

    @classmethod
    def from_config(cls, spec: str,
                    toggles: Optional[Dict[str, int]] = None,
                    ) -> "PassPipeline":
        spec = (spec or "").strip()
        if spec in ("0", "none", "off"):
            spec = ""
        if spec == "all":
            # every REGISTERED pass - not the canonical-order tuple,
            # which only sorts: a pass added via @register_pass must
            # not be silently excluded from `graph_passes = all`
            enabled = set(PASS_REGISTRY)
        else:
            enabled = {resolve_pass_name(t.strip())
                       for t in spec.split(",") if t.strip()}
        for name, on in (toggles or {}).items():
            resolve_pass_name(name)
            if on:
                enabled.add(name)
            else:
                enabled.discard(name)
        return cls([PASS_REGISTRY[n]() for n in enabled])

    @property
    def graph_passes(self) -> List[GraphPass]:
        return [p for p in self.passes if p.stage == "graph"]

    @property
    def infer_passes(self) -> List[GraphPass]:
        return [p for p in self.passes if p.stage == "infer"]

    def has(self, name: str) -> bool:
        return any(p.name == name for p in self.passes)

    def run_graph(self, gm: GraphModule,
                  ctx: Optional[PassContext] = None) -> GraphModule:
        ctx = ctx or PassContext()
        for p in self.graph_passes:
            gm = p.run(gm, ctx)
        return gm

    def run_infer(self, gm: GraphModule,
                  ctx: PassContext) -> GraphModule:
        for p in self.infer_passes:
            gm = p.run(gm, ctx)
        return gm

    def names(self) -> List[str]:
        return [p.name for p in self.passes]
