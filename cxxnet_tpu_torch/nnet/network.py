"""Network: NetConfig DAG -> forward (counterpart of
cxxnet_tpu/nnet/network.py).

Connections run in declaration order exactly like the reference
(neural_net-inl.hpp Forward :107-132). A shared connection
(`share[tag]`) reuses the primary layer's module and its entry in the
params dict; a self-loop layer (`layer[+0]`, in == out) overwrites its
node. Params are passed in as {param_key: {"wmat", "bias"}} - the JAX
package's keys - so the trainer can hold a float32 master copy and a
compute-dtype copy side by side.

`dtype_plan` ({layer index: torch dtype}, stamped by the autocast graph
pass) casts each listed layer's floating inputs and params to its
compute dtype before the layer runs; None (no plan) leaves the casts to
the trainer, which casts wholesale.

Rematerialisation (the trainer's `remat = 1`, the JAX package's
jax.checkpoint of the loss): the training forward runs in segments of
consecutive connections (`remat_segments`), each under
torch.utils.checkpoint (non-reentrant). A segment keeps only the node
values read after it; its inner activations are dropped and recomputed
in the backward pass, one segment at a time, so the peak holds the
segment boundaries plus one segment's activations. One checkpoint
around the whole forward would recompute every activation at once
before the backward and lower nothing. Random layers draw from
generators made anew from (seed, step, layer index) on each call, so
the recompute draws the same masks.

The 'seq' mesh axis (parallel/mesh.py, the JAX package's input
sharding `P(data, None, seq, None)`): where the active mesh has a seq
axis of n > 1 that divides the input's y dim, every rank gets its data
index's whole rows and the network cuts its sequence block of node 0.
A node stays seq-sharded through the layers that declare `seq_local`
(position-wise layers, and the attention layers' ring / Ulysses
routes), which run on the block under `seq_block`; before any other
layer reads a seq-sharded node - flatten, fullc or pooling on a
sequence node, the losses - it is gathered along the sequence
(ring.seq_gather: all-gather forward, reduce-scatter backward), and
that layer and every layer after it compute the same values on every
seq rank. The nodes a caller keeps (`keep_nodes`) come back whole.
`seq_plan` is that decision, made once per structure and pipe axis
from the layers' declarations (a transformer_stack pipelined over a
`pipe` axis is not seq_local: the sequence is gathered before it); a y
dim the axis does not divide shards nothing (every layer sees the whole
sequence, the JAX package's fallback).

The expert and pipe axes need nothing of the network: their ranks of
one data index run every layer but moe's experts and the stack's stages
on the same rows, and a random layer draws the same mask on each (the
draw follows the data index, layers/base.py rank_rand).
"""

from __future__ import annotations

import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
import torch.utils.checkpoint
from torch import nn

from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.layers.base import Layer, Shape, seq_block
from cxxnet_tpu_torch.layers.common import SplitLayer
from cxxnet_tpu_torch.layers.loss import LossLayer
from cxxnet_tpu_torch.nnet.net_config import NetConfig
from cxxnet_tpu_torch.parallel.mesh import (
    get_active_mesh, pipe_axis_size, seq_axis_size)


class SeqPlan(NamedTuple):
    """Where a seq-sharded forward runs on blocks: per connection,
    whether it runs on the block (`local`) and which of its input nodes
    it gathers first (`gather`); `sharded` - the nodes still sharded
    after the last connection."""
    local: Tuple[bool, ...]
    gather: Tuple[Tuple[int, ...], ...]
    sharded: frozenset


def param_key(cfg: NetConfig, layer_index: int) -> str:
    """Stable key for a layer's params: its name, else its index."""
    info = cfg.layers[layer_index]
    return info.name if info.name else f"layer_{layer_index}"


class Network(nn.Module):
    """Layer modules + inferred node shapes; the forward."""

    def __init__(self, cfg: NetConfig, batch_size: int):
        super().__init__()
        self.cfg = cfg
        self.layer_objs = nn.ModuleList()
        self.node_shapes: List[Optional[Shape]] = [None] * cfg.num_nodes
        self.dtype_plan: Optional[Dict[int, torch.dtype]] = None
        self._seq_plans: Dict[Tuple[int, int], Optional[SeqPlan]] = {}

        c, y, x = cfg.input_shape
        if c * y * x == 0:
            raise ValueError("input_shape must be set")
        # node 0 is the data input; in_1..in_k are the extra inputs
        self.node_shapes[0] = (batch_size, c, y, x)
        for i in range(cfg.extra_data_num):
            ec, ey, ex = cfg.extra_shape[3 * i: 3 * i + 3]
            self.node_shapes[i + 1] = (batch_size, ec, ey, ex)

        # build layer modules and run shape inference in declaration order
        for idx, info in enumerate(cfg.layers):
            if info.is_shared:
                layer = self.layer_objs[info.primary_layer_index]
            else:
                layer = create_layer(info.type_name, info.name)
                for k, v in cfg.defcfg:
                    layer.set_param(k, v)
                for k, v in cfg.layercfg[idx]:
                    layer.set_param(k, v)
            self.layer_objs.append(layer)
            if isinstance(layer, SplitLayer):
                layer.num_out = len(info.nindex_out)
            if isinstance(layer, LossLayer):
                if info.nindex_in != info.nindex_out:
                    raise ValueError(
                        f"{info.type_name}: loss layer must be a self-loop")
                if layer.target not in cfg.label_name_map:
                    raise ValueError(
                        f"LossLayer: unknown target={layer.target}")
            in_shapes = []
            for j in info.nindex_in:
                if self.node_shapes[j] is None:
                    raise ValueError(
                        f"node {cfg.node_names[j]} used before it is "
                        "produced")
                in_shapes.append(self.node_shapes[j])
            out_shapes = layer.infer_shapes(list(in_shapes))
            if len(out_shapes) != len(info.nindex_out):
                raise ValueError(
                    f"{info.type_name}: produced {len(out_shapes)} outputs "
                    f"for {len(info.nindex_out)} output nodes")
            for j, s in zip(info.nindex_out, out_shapes):
                self.node_shapes[j] = s

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Float32 CPU params from `seed`: one torch.Generator per layer,
        seeded from (seed, layer index) - the role jax.random.fold_in
        plays in the JAX package."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for idx, info in enumerate(self.cfg.layers):
            if info.is_shared:
                continue
            gen = torch.Generator().manual_seed(seed * 1000003 + idx)
            in_shapes = [self.node_shapes[j] for j in info.nindex_in]
            p = self.layer_objs[idx].init_params(gen, list(in_shapes))
            if p:
                params[param_key(self.cfg, idx)] = p
        return params

    def param_shapes(self) -> Dict[str, Dict[str, tuple]]:
        """{param_key: {name: shape}} - what a checkpoint must carry."""
        out = {}
        for idx, info in enumerate(self.cfg.layers):
            if info.is_shared:
                continue
            in_shapes = [self.node_shapes[j] for j in info.nindex_in]
            shapes = self.layer_objs[idx].param_shapes(list(in_shapes))
            if shapes:
                out[param_key(self.cfg, idx)] = shapes
        return out

    # ------------------------------------------------------------------
    def remat_segments(self) -> List[range]:
        """Consecutive connections cut into checkpoint segments. The
        cost of a cut is the bytes of the nodes live across it, the
        cost of a segment the bytes its connections write (an upper
        bound of what its recompute holds at once in the backward);
        the cuts minimise twice the sum of the cuts' costs (a cut's
        nodes are held through every later segment's recompute, and a
        segment's writes are not all saved) plus the largest segment's,
        over segment bounds total / k, k = 1 .. 16. A CNN is cut after
        its pooling / LRN layers, where the activations are small."""
        layers = self.cfg.layers
        n = len(layers)
        size = [math.prod(s) if s else 0 for s in self.node_shapes]
        out = [sum(size[j] for j in info.nindex_out) for info in layers]
        last_read: Dict[int, int] = {}
        written: Dict[int, int] = {0: -1}
        for i in range(self.cfg.extra_data_num):
            written[1 + i] = -1
        for idx, info in enumerate(layers):
            for j in info.nindex_in:
                last_read[j] = idx
            for j in info.nindex_out:
                written.setdefault(j, idx)
        # live[c]: bytes of the nodes written at or before connection c
        # and read after it
        live = [sum(size[j] for j, w in written.items()
                    if w <= c < last_read.get(j, -1)) for c in range(n)]
        pre = [0]
        for o in out:
            pre.append(pre[-1] + o)
        best = None
        for k in range(1, 17):
            bound = pre[n] / k
            # dp[i]: least cut cost of segmenting connections [0, i)
            dp = [0.0] + [math.inf] * n
            arg = [0] * (n + 1)
            for i in range(1, n + 1):
                for j in range(i - 1, -1, -1):
                    if pre[i] - pre[j] > bound and j < i - 1:
                        break
                    c = dp[j] + (2 * live[j - 1] if j else 0)
                    if c < dp[i]:
                        dp[i], arg[i] = c, j
            cuts, i = [], n
            while i:
                cuts.append(i)
                i = arg[i]
            cuts = [0] + cuts[::-1]
            segs = [range(a, b) for a, b in zip(cuts, cuts[1:])]
            cost = dp[n] + max(pre[r.stop] - pre[r.start] for r in segs)
            if best is None or cost < best[0]:
                best = (cost, segs)
        return best[1]

    def seq_plan(self, nseq: int) -> Optional[SeqPlan]:
        """The seq-sharded forward at a seq axis of `nseq` on the active
        mesh (None: nothing is sharded - no axis, or one that does not
        divide the input's y dim). Node 0 starts sharded; a connection
        runs on the block when every input it reads is sharded and its
        layer is seq_local, and then writes sharded nodes; any other
        connection gathers its sharded inputs and writes whole nodes."""
        if nseq <= 1 or self.cfg.input_shape[1] % nseq:
            return None
        key = (nseq, pipe_axis_size(get_active_mesh()))
        if key in self._seq_plans:
            return self._seq_plans[key]
        sharded = {0}
        local, gather = [], []
        for idx, info in enumerate(self.cfg.layers):
            ins = [j for j in info.nindex_in if j in sharded]
            run_local = (bool(ins) and len(ins) == len(info.nindex_in)
                         and self.layer_objs[idx].seq_local())
            local.append(run_local)
            gather.append(() if run_local else tuple(ins))
            if run_local:
                sharded.update(info.nindex_out)
            else:
                sharded.difference_update(info.nindex_out)
        plan = SeqPlan(tuple(local), tuple(gather), frozenset(sharded))
        self._seq_plans[key] = plan
        return plan

    def _seq(self) -> Tuple[Optional[object], Optional[SeqPlan]]:
        """(the active mesh, its seq plan) - (None, None) outside a seq
        mesh."""
        mesh = get_active_mesh()
        plan = self.seq_plan(seq_axis_size(mesh))
        return (mesh, plan) if plan is not None else (None, None)

    def _run_layer(self, idx, values, params, train, gens, keep, labels,
                   mask, taps, seq=(None, None)):
        """One connection: reads its input nodes from `values`, writes
        its output nodes there; returns its contribution to the loss
        (None when it adds none)."""
        cfg = self.cfg
        info = cfg.layers[idx]
        layer: Layer = self.layer_objs[idx]
        pkey = param_key(
            cfg, info.primary_layer_index if info.is_shared else idx)
        xs = [values[j] for j in info.nindex_in]
        smesh, plan = seq
        local = plan is not None and plan.local[idx]
        if plan is not None and plan.gather[idx]:
            from cxxnet_tpu_torch.parallel.ring import seq_gather
            xs = [seq_gather(x, smesh) if j in plan.gather[idx] else x
                  for j, x in zip(info.nindex_in, xs)]
        p = params.get(pkey, {})
        want = (self.dtype_plan.get(idx)
                if self.dtype_plan is not None else None)
        if want is not None:
            xs = [x.to(want) if x.is_floating_point() else x
                  for x in xs]
            p = {k: (v.to(want) if v.is_floating_point() else v)
                 for k, v in p.items()}
        if taps is not None and idx in taps:
            taps[idx] = xs[0]
        loss = None
        if isinstance(layer, LossLayer) and labels is not None:
            flat = xs[0].reshape(xs[0].shape[0], -1)
            per_ex = layer.per_example_loss(flat, labels[layer.target])
            if mask is not None:
                per_ex = per_ex * mask
            loss = layer.grad_scale * torch.sum(per_ex)
        lkeep = keep.get(idx) if (train and keep) else None
        if local and lkeep is not None and lkeep.dim() == 4 \
                and lkeep.shape[2] != xs[0].shape[2]:
            # a whole-sequence draw injected into a seq-sharded layer:
            # this rank's block of it
            s = xs[0].shape[2]
            lkeep = lkeep[:, :, smesh.seq_rank * s:(smesh.seq_rank + 1) * s]
        gen = (gens(idx) if (train and layer.uses_rng and lkeep is None
                             and gens is not None) else None)
        with seq_block(smesh if local else None):
            if train and layer.has_aux:
                # an auxiliary loss term (moe's load balance) joins the
                # total the loss layers accumulate
                outs, aux = layer.forward_with_aux(
                    p, xs, train=train, gen=gen, keep=lkeep, mask=mask)
                loss = aux if loss is None else loss + aux
            else:
                outs = layer(p, xs, train=train, gen=gen, keep=lkeep)
        for j, o in zip(info.nindex_out, outs):
            values[j] = o
        return loss

    def forward(
        self, params: Dict[str, Dict[str, torch.Tensor]],
        data: torch.Tensor, *, extras: Sequence[torch.Tensor] = (),
        train: bool = False,
        gens: Optional[Callable[[int], torch.Generator]] = None,
        keep: Optional[Dict[int, torch.Tensor]] = None,
        labels: Optional[Dict[str, torch.Tensor]] = None,
        mask: Optional[torch.Tensor] = None,
        taps: Optional[Dict[int, Optional[torch.Tensor]]] = None,
        remat_segments: Optional[Sequence[range]] = None,
        keep_nodes: Sequence[int] = (),
    ) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
        """Run all connections in declaration order on node-0 `data`
        and the extra-input nodes 1..k (`extras`, one tensor each).

        train: training semantics (dropout draws a mask, a `has_aux`
        layer's auxiliary loss joins the total; inference runs every
        layer's plain forward). A layer that draws random numbers gets
        `gens(layer_index)` - the trainer seeds one generator per
        (seed, step, layer index), the role fold_in(rng, idx) plays in
        the JAX package - unless `keep` holds an injected draw for that
        layer index (dropout's boolean mask, or the uniform tensor of
        insanity, prelu and insanity_max_pooling).
        labels: label field -> (b, width) tensor; when given, each loss
        layer adds grad_scale * sum(mask * per_example_loss) to the
        total. mask: (b,) validity of the rows (padding rows 0), also
        handed to `has_aux` layers.
        taps: {layer index: None}, filled in place with each listed
        layer's first INPUT as the layer receives it (after the dtype
        plan's cast) - before a self-loop layer overwrites its node, so
        a `layer[+0] = batch_norm` is tapped at its input, which the
        graph passes' calibration needs.
        remat_segments (training only): run under checkpoint in these
        segments (remat_segments()); the returned values then hold only
        the `keep_nodes` and the nodes read by the last segment.
        keep_nodes: the nodes the caller reads; under a seq mesh they
        come back whole (gathered), every other node as the forward
        left it.

        Returns (every node's value - None for nodes never written -,
        total_loss as a float32 scalar). A loss layer writes its
        forward_transform into its node, as in the JAX package."""
        cfg = self.cfg
        values: List[Optional[torch.Tensor]] = [None] * cfg.num_nodes
        seq = self._seq()
        if seq[1] is not None:
            # this rank's sequence block of its rows
            s = data.shape[2] // seq_axis_size(seq[0])
            data = data[:, :, seq[0].seq_rank * s:(seq[0].seq_rank + 1) * s]
        values[0] = data
        for i, e in enumerate(extras):
            values[1 + i] = e
        total_loss = torch.zeros((), dtype=torch.float32,
                                 device=data.device)
        if train and remat_segments:
            values, total_loss = self._forward_remat(
                values, total_loss, params, remat_segments, keep_nodes,
                gens, keep, labels, mask, seq)
        else:
            for idx in range(len(cfg.layers)):
                loss = self._run_layer(idx, values, params, train, gens,
                                       keep, labels, mask, taps, seq)
                if loss is not None:
                    total_loss = total_loss + loss
        if seq[1] is not None:
            from cxxnet_tpu_torch.parallel.ring import seq_gather
            for j in set(keep_nodes) & seq[1].sharded:
                values[j] = seq_gather(values[j], seq[0])
        return values, total_loss

    def _forward_remat(self, values, total_loss, params, segments,
                       keep_nodes, gens, keep, labels, mask, seq):
        """The training forward segment by segment under checkpoint: a
        segment's inputs are the nodes it reads that an earlier one
        wrote, its outputs the nodes it writes that a later connection
        reads or the caller keeps (`keep_nodes`); every other node is
        dropped as soon as nothing reads it any more."""
        layers = self.cfg.layers
        last_read = {}
        for idx, info in enumerate(layers):
            for j in info.nindex_in:
                last_read[j] = idx
        keep_nodes = set(keep_nodes or ())
        for seg in segments:
            written = set()
            ins = []
            for idx in seg:
                for j in layers[idx].nindex_in:
                    if j not in written and j not in ins:
                        ins.append(j)
                written.update(layers[idx].nindex_out)
            outs = sorted(j for j in written
                          if j in keep_nodes
                          or last_read.get(j, -1) > seg[-1])

            def run(*xs, seg=seg, ins=ins, outs=outs):
                vals: List[Optional[torch.Tensor]] = [None] * len(values)
                for j, x in zip(ins, xs):
                    vals[j] = x
                loss = torch.zeros((), dtype=torch.float32,
                                   device=total_loss.device)
                for idx in seg:
                    part = self._run_layer(idx, vals, params, True, gens,
                                           keep, labels, mask, None, seq)
                    if part is not None:
                        loss = loss + part
                return (loss, *(vals[j] for j in outs))

            loss, *res = torch.utils.checkpoint.checkpoint(
                run, *(values[j] for j in ins), use_reentrant=False)
            total_loss = total_loss + loss
            for j, o in zip(outs, res):
                values[j] = o
            for j in range(len(values)):
                if (values[j] is not None and j not in keep_nodes
                        and last_read.get(j, -1) <= seg[-1]):
                    values[j] = None
        return values, total_loss

    # ------------------------------------------------------------------
    def node_index(self, name: str) -> int:
        """Resolve a node reference: name, or `top[-k]` counting from the
        last node (ExtractFeature syntax, nnet_impl-inl.hpp:200-223)."""
        if name.startswith("top[-") and name.endswith("]"):
            k = int(name[5:-1])
            return self.cfg.num_nodes - k
        if name in self.cfg.node_name_map:
            return self.cfg.node_name_map[name]
        raise KeyError(f"unknown node name {name}")
