"""transformer_stack: L identical pre-norm transformer blocks with their
params stacked on a leading L dim (counterpart of
cxxnet_tpu/layers/transformer_stack.py).

    x = x + Wproj . attn(layernorm(x))
    x = x + W2 . relu(W1 . layernorm(x) + b1) + b2

on (b, 1, s, e) sequence nodes. The params keep the JAX package's names,
shapes (L, ...) and tags, so convert.py and the checkpoint format carry
them unchanged. The attention core is ops/flash_attention.py - K2-fwd,
and in training K2-dq / K2-dkv, on the card; their plain versions on
the CPU - the function the JAX package's blockwise core computes.

Two routes, as in the JAX package:

- sequential: a Python loop over the L stacked slices (the JAX
  package's lax.scan). On a seq-sharded block (a `seq` mesh axis,
  nnet/network.py) every block's attention core is ring or Ulysses
  attention over the seq ranks (parallel/ring.py), as `seq_parallel`
  says - the JAX package's sequential route with its `seq_mesh`;
  `seq_parallel = none` makes the network gather the sequence first.
- pipelined, under a `pipe` mesh axis of P that divides nlayer
  (`pipe_shard_dims`: every stacked param on dim 0, so stage p holds
  its L/P slices): a GPipe schedule over the pipe group. The rows of
  this rank's data index split into M microbatches (`microbatch`; an
  explicit value that does not divide them raises the JAX text, the
  default is the largest divisor <= P, a degenerate batch takes the
  sequential route). Stage p runs its blocks on microbatch m as soon as
  stage p - 1 sent it (parallel/distributed.py send / recv, one
  batch_isend_irecv each, staged through pinned host memory under
  gloo), so the JAX schedule's idle ticks - computed on zeros there and
  masked away - are skipped: the same function. The last stage's output
  is broadcast to every pipe rank (the JAX `psum`), so the layers after
  the stack run replicated. `_GPipe` is the schedule as one autograd
  Function: its forward keeps each microbatch's stage graph, its
  backward walks the microbatches in reverse, sends each input gradient
  upstream, and broadcasts stage 0's input gradient to every pipe rank
  (the layers before the stack run replicated too); the stage params'
  gradient is the one pass's, once. A stack under `pipe` is not
  `seq_local`: on a mesh with `seq` the network gathers the sequence
  first, as GSPMD does with the JAX shard_map's `P(data, None, None)`
  in-spec, and the attention core is K2 per device. nlayer % P != 0
  leaves the params whole (sharding.py's fallback) and runs the
  sequential route.

Config keys: nlayer, nhead, nhidden (the FFN width), causal, eps,
microbatch, kv_block and seq_parallel, validated as in the JAX package;
kv_block tiles the JAX package's XLA core and does not change the
function.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from cxxnet_tpu_torch.layers.attention import (
    heads_proj, layer_norm, qkv_heads)
from cxxnet_tpu_torch.layers.base import (
    Layer, Params, Shape, register_layer, seq_block_mesh)
from cxxnet_tpu_torch.ops import nn as nn_ops
from cxxnet_tpu_torch.ops.flash_attention import flash_attention
from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.mesh import (
    Mesh, data_axis_size, get_active_mesh, pipe_axis_size)
from cxxnet_tpu_torch.parallel.ring import (
    SEQ_SCHEMES, seq_parallel_attention)

# the stacked params, in the JAX package's order
_PARAMS = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "ln2_s", "ln2_b",
           "w1", "b1", "w2", "b2")


@register_layer
class TransformerStackLayer(Layer):
    """L stacked pre-norm transformer blocks on (b, 1, s, e) nodes."""

    type_name = "transformer_stack"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.nlayer = 1
        self.nhead = 1
        self.causal = 0
        self.microbatch = 0
        self.kv_block = 512
        self.eps = 1e-5
        self.seq_parallel = "ring"

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "nlayer":
            self.nlayer = int(val)
        if name == "nhead":
            self.nhead = int(val)
        if name == "causal":
            self.causal = int(val)
        if name == "microbatch":
            self.microbatch = int(val)
        if name == "kv_block":
            self.kv_block = int(val)
        if name == "eps":
            self.eps = float(val)
        if name == "seq_parallel":
            if val not in SEQ_SCHEMES:
                raise ValueError(
                    "seq_parallel must be ring, ulysses or none")
            self.seq_parallel = val

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        b, c, s, e = in_shapes[0]
        if c != 1:
            raise ValueError(
                "transformer_stack: input must be a sequence node")
        if self.nlayer < 1:
            raise ValueError("transformer_stack: must set nlayer >= 1")
        if self.param.num_hidden <= 0:
            raise ValueError(
                "transformer_stack: must set nhidden correctly")
        if e % self.nhead != 0:
            raise ValueError(
                f"transformer_stack: embed {e} not divisible by "
                f"nhead {self.nhead}")
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        e = in_shapes[0][3]
        h, L = self.param.num_hidden, self.nlayer
        return {"ln1_s": (L, e), "ln1_b": (L, e), "wqkv": (L, 3 * e, e),
                "bqkv": (L, 3 * e), "wproj": (L, e, e), "ln2_s": (L, e),
                "ln2_b": (L, e), "w1": (L, h, e), "b1": (L, h),
                "w2": (L, e, h), "b2": (L, e)}

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        e = in_shapes[0][3]
        h, L = self.param.num_hidden, self.nlayer
        rw = self.param.rand_init_weight
        shapes = self.param_shapes(in_shapes)
        params = {k: (torch.ones(v) if k.endswith("_s") else torch.zeros(v))
                  for k, v in shapes.items()}
        params["wqkv"] = rw(gen, (L, 3 * e, e), in_num=e, out_num=3 * e)
        params["wproj"] = rw(gen, (L, e, e), in_num=e, out_num=e)
        params["w1"] = rw(gen, (L, h, e), in_num=e, out_num=h)
        params["w2"] = rw(gen, (L, e, h), in_num=h, out_num=e)
        return params

    def param_tags(self) -> Dict[str, str]:
        return {"wqkv": "wmat", "wproj": "wmat", "w1": "wmat",
                "w2": "wmat", "ln1_s": "wmat", "ln2_s": "wmat",
                "bqkv": "bias", "b1": "bias", "b2": "bias",
                "ln1_b": "bias", "ln2_b": "bias"}

    def pipe_shard_dims(self) -> Dict[str, int]:
        # every stacked param's leading (layer) dim rides 'pipe'
        return {pn: 0 for pn in _PARAMS}

    def pipe_route(self, mesh: Optional[Mesh]) -> int:
        """P, the pipe axis's size, when the stack runs pipelined on
        `mesh`; 0 for the sequential route (no pipe axis above 1, or one
        that does not divide nlayer)."""
        P = pipe_axis_size(mesh)
        return P if P > 1 and self.nlayer % P == 0 else 0

    def seq_local(self) -> bool:
        return (self.seq_parallel != "none"
                and not self.pipe_route(get_active_mesh()))

    def block(self, bp: Params, x: torch.Tensor) -> torch.Tensor:
        """One block; bp's tensors have no layer dim; x (b, s, e) - this
        rank's sequence block on a seq-sharded node. The weights are
        cast to x's dtype before each product, as in the JAX package's
        `_block`."""
        h = layer_norm(x, bp["ln1_s"], bp["ln1_b"], self.eps)
        q, k, v = qkv_heads(h, bp["wqkv"], bp["bqkv"], self.nhead)
        o = seq_parallel_attention(q, k, v, seq_block_mesh(),
                                   self.seq_parallel,
                                   causal=bool(self.causal))
        if o is None:
            o = flash_attention(q, k, v, bool(self.causal))
        x = x + heads_proj(o, bp["wproj"])
        h2 = layer_norm(x, bp["ln2_s"], bp["ln2_b"], self.eps)
        f = h2 @ bp["w1"].to(x.dtype).t()
        f = nn_ops.relu(f + bp["b1"].to(x.dtype)[None, None])
        f = f @ bp["w2"].to(x.dtype).t()
        return x + f + bp["b2"].to(x.dtype)[None, None]

    def stage(self, stacked: Sequence[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """The blocks of `stacked` (the params in _PARAMS order, each with
        its leading layer dim) on x (b, s, e), in order."""
        for i in range(stacked[0].shape[0]):
            x = self.block({k: t[i] for k, t in zip(_PARAMS, stacked)}, x)
        return x

    def microbatches(self, mesh: Mesh, b_local: int, P: int) -> int:
        """M for the pipelined route over a data shard of `b_local`
        rows (0: the sequential route), as the JAX package's
        `_pipelined` picks it."""
        dsize = data_axis_size(mesh)
        if self.microbatch:
            if b_local % self.microbatch != 0:
                raise ValueError(
                    f"transformer_stack: microbatch={self.microbatch} "
                    f"does not divide the per-data-shard batch "
                    f"{b_local} (batch {b_local * dsize} over "
                    f"data:{dsize})")
            return self.microbatch
        if b_local == 0:
            return 0
        return next(m for m in range(min(P, b_local), 0, -1)
                    if b_local % m == 0)

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b, _, s, e = x.shape
        out = x.reshape(b, s, e)
        stacked = [params[k] for k in _PARAMS]
        mesh = get_active_mesh()
        P = self.pipe_route(mesh)
        M = self.microbatches(mesh, b, P) if P else 0
        if M:
            out = pipelined(self, mesh, M, out, stacked)
        else:
            out = self.stage(stacked, out)
        return [out.reshape(b, 1, s, e)]


def _stage_peers(mesh: Mesh):
    """(the previous and the next stage's job ranks (None at the ends),
    the first and the last stage's, the pipe group) of this stage."""
    peers, p = mesh.pipe_peers, mesh.pipe_rank
    return (peers[p - 1] if p > 0 else None,
            peers[p + 1] if p < len(peers) - 1 else None, peers[0],
            peers[-1], mesh.pipe_group)


def _schedule(layer, mesh: Mesh, M: int, x: torch.Tensor, stacked,
              keep_graph: bool):
    """The forward of the GPipe schedule on this stage: (the last stage's
    output, broadcast to every pipe rank; each microbatch's (input,
    output) graph when keep_graph)."""
    prv, nxt, _, last, group = _stage_peers(mesh)
    b, s, e = x.shape
    mb = b // M
    like = [torch.empty((mb, s, e), dtype=x.dtype, device="meta")]
    sent, outs, graphs = [], [], []
    for m in range(M):
        inp = (x[m * mb:(m + 1) * mb] if prv is None else
               distributed.recv(like, group, prv, x.device)[0])
        if keep_graph:
            inp = inp.detach().requires_grad_(True)
            with torch.enable_grad():
                y = layer.stage(stacked, inp)
            graphs.append((inp, y))
        else:
            y = layer.stage(stacked, inp)
        if nxt is not None:
            sent.append(distributed.send([y.detach()], group, nxt))
        else:
            outs.append(y.detach())
    for h in sent:
        h.wait()
    out = torch.cat(outs) if outs else torch.empty_like(x)
    return distributed.broadcast(out, last, group), graphs


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, layer, mesh, M, x, *stacked):
        leaves = [t.detach().requires_grad_(True) for t in stacked]
        out, graphs = _schedule(layer, mesh, M, x, leaves, True)
        ctx.mesh, ctx.M, ctx.graphs, ctx.leaves = mesh, M, graphs, leaves
        return out

    @staticmethod
    def backward(ctx, g):
        prv, nxt, first, _, group = _stage_peers(ctx.mesh)
        M, leaves = ctx.M, ctx.leaves
        mb = g.shape[0] // M
        like = [torch.empty((mb,) + tuple(g.shape[1:]), dtype=g.dtype,
                            device="meta")]
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in leaves]
        sent, dxs = [], []
        for m in reversed(range(M)):
            go = (g[m * mb:(m + 1) * mb] if nxt is None else
                  distributed.recv(like, group, nxt, g.device)[0])
            inp, y = ctx.graphs[m]
            grads = torch.autograd.grad(y, [inp] + leaves, go,
                                        allow_unused=True)
            for a, t in zip(acc, grads[1:]):
                if t is not None:
                    a.add_(t.float())
            if prv is not None:
                sent.append(distributed.send([grads[0]], group, prv))
            else:
                dxs.append(grads[0])
        for h in sent:
            h.wait()
        ctx.graphs = None
        dx = torch.cat(dxs[::-1]) if dxs else torch.empty_like(g)
        dx = distributed.broadcast(dx, first, group)
        return (None, None, None, dx,
                *(a.to(t.dtype) for a, t in zip(acc, leaves)))


def pipelined(layer: TransformerStackLayer, mesh: Mesh, M: int,
              x: torch.Tensor, stacked) -> torch.Tensor:
    """The stack on x (this data shard's rows, (b, s, e)) as the GPipe
    schedule over `mesh`'s pipe group in M microbatches, this rank's
    stage running `stacked` (its L/P slices)."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in stacked)):
        return _GPipe.apply(layer, mesh, M, x, *stacked)
    return _schedule(layer, mesh, M, x, stacked, False)[0]
