"""moe: top-k routed mixture-of-experts FFN on (b, 1, s, e) sequence
nodes (counterpart of cxxnet_tpu/layers/moe.py).

Every expert's FFN weights are stacked on a leading expert dim (w1
(E, H, e), w2 (E, e, H)), with the router `gate` (E, e); the names,
shapes and tags are the JAX package's, so checkpoints carry them. Two
compute routes, as there:

- dense (default, exact): every expert runs on every token and the
  router's top-k one-hot, scaled by the softmax probability, masks the
  sum;
- `moe_capacity > 0`: Switch/GShard capacity dispatch - each expert
  takes at most C = ceil(top_k * tokens / E * moe_capacity) tokens in
  arrival order (first choices before second ones), and a token over
  capacity gets 0 from the layer. The layer adds no residual, so a conf
  that sets moe_capacity must wire one around it (split + add);
  shape inference warns.

The load-balance auxiliary loss, E * sum_e fraction_e * mean_prob_e over
the valid rows (`mask`), scaled by moe_aux * batch, comes back from
`forward_with_aux`; the network adds it into the training loss. The
expert products are plain torch matmuls (the JAX package computes them
outside any Pallas kernel too).

On a mesh (parallel/), as the JAX package's GSPMD program computes the
layer on the global batch:

- a data axis: each rank holds its contiguous block of the rows, in
  rank order. The load-balance statistics (the valid-token count, the
  sums of the top-1 assignments and of the probabilities) are summed
  over the data group (tensor.shared_sum), so the term is the global
  product and the ranks' summed gradients are the global term's. The
  capacity route takes C from the global token count and each (token,
  slot)'s place from the global slot-major arrival order: one
  all-gather of every rank's per-(slot, expert) counts gives the
  arrivals before this rank's.
- an expert axis (`expert_shard_dims`: w1, w2, b1, b2 on dim 0, the
  gate replicated): each rank holds E/n experts and runs them on every
  token of its rows, masked by its columns of the routing weights -
  the all-to-all-free layout of the JAX package's docstring. The
  tokens and the routing weights `enter` the expert region (their
  gradient is summed over the expert group) and the local products'
  sum is `reduce`d (parallel/tensor.py). The gate, the route and the
  aux term are the same on every expert rank. nexpert % n != 0 leaves
  the expert weights whole (sharding.py's fallback) and the layer runs
  them all.

Config keys: nexpert, nhidden (each expert's FFN width), moe_top_k
(default 1), moe_aux (default 0.01), moe_capacity (0 = dense), no_bias.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from cxxnet_tpu_torch.layers.base import Layer, Params, Shape, register_layer
from cxxnet_tpu_torch.ops import nn as nn_ops
from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, data_axis_size, get_active_mesh)
from cxxnet_tpu_torch.parallel.tensor import enter, reduce, shared_sum


@register_layer
class MoELayer(Layer):
    """moe: top-k routed mixture-of-experts FFN on sequence nodes."""

    type_name = "moe"
    has_aux = True

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.nexpert = 0
        self.top_k = 1
        self.aux_scale = 0.01
        self.capacity = 0.0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "nexpert":
            self.nexpert = int(val)
        if name == "moe_top_k":
            self.top_k = int(val)
        if name == "moe_aux":
            self.aux_scale = float(val)
        if name == "moe_capacity":
            self.capacity = float(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        b, c, s, e = in_shapes[0]
        if c != 1:
            raise ValueError("moe: input must be a sequence node")
        if self.nexpert < 2:
            raise ValueError("moe: must set nexpert >= 2")
        if self.param.num_hidden <= 0:
            raise ValueError("moe: must set nhidden correctly")
        if not 1 <= self.top_k <= self.nexpert:
            raise ValueError("moe: moe_top_k out of range")
        if self.capacity > 0:
            warnings.warn(
                f"moe:{self.name}: moe_capacity={self.capacity} drops "
                "over-capacity tokens (output 0); wire a residual "
                "bypass around this layer (split + add, see the moe "
                "module docstring) or dropped tokens lose their "
                "activations", stacklevel=2)
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        e = in_shapes[0][3]
        h, g = self.param.num_hidden, self.nexpert
        shapes = {"gate": (g, e), "w1": (g, h, e), "w2": (g, e, h)}
        if self.param.no_bias == 0:
            shapes.update({"b1": (g, h), "b2": (g, e)})
        return shapes

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        e = in_shapes[0][3]
        h, g = self.param.num_hidden, self.nexpert
        rw = self.param.rand_init_weight
        params = {"gate": rw(gen, (g, e), in_num=e, out_num=g),
                  "w1": rw(gen, (g, h, e), in_num=e, out_num=h),
                  "w2": rw(gen, (g, e, h), in_num=h, out_num=e)}
        if self.param.no_bias == 0:
            params["b1"] = torch.zeros((g, h))
            params["b2"] = torch.zeros((g, e))
        return params

    def param_tags(self) -> Dict[str, str]:
        return {"gate": "wmat", "w1": "wmat", "w2": "wmat",
                "b1": "bias", "b2": "bias"}

    def expert_shard_dims(self) -> Dict[str, int]:
        # the gate stays replicated: every expert rank routes every token
        return {"w1": 0, "w2": 0, "b1": 0, "b2": 0}

    # ------------------------------------------------------------------
    def route(self, probs: torch.Tensor, mask: Optional[torch.Tensor] = None,
              need_combine: bool = True, need_aux: bool = True):
        """(b, s, E) float32 probs -> (combine (b, s, E) or None, aux (None
        without need_aux), topv (b, s, k), topi (b, s, k)). Padding rows
        (mask 0) stay out of the load-balance statistics; on a data mesh
        they are the global batch's."""
        topv, topi = torch.topk(probs, self.top_k, dim=-1)
        onehot = F.one_hot(topi, self.nexpert).to(probs.dtype)  # b,s,k,E
        combine = ((onehot * topv[..., None]).sum(dim=2)
                   if need_combine else None)
        if not need_aux:
            return combine, None, topv, topi
        top1 = onehot[:, :, 0]                                  # b,s,E
        mesh = get_active_mesh()
        if data_axis_size(mesh) > 1:
            frac, mean_p = self._global_stats(probs, top1, mask, mesh)
        elif mask is not None:
            w = mask.to(probs.dtype)[:, None, None]
            total = torch.clamp(w.sum() * probs.shape[1], min=1.0)
            frac = (top1 * w).sum(dim=(0, 1)) / total
            mean_p = (probs * w).sum(dim=(0, 1)) / total
        else:
            frac = top1.mean(dim=(0, 1))
            mean_p = probs.mean(dim=(0, 1))
        aux = self.nexpert * (frac * mean_p).sum()
        return combine, aux, topv, topi

    def _global_stats(self, probs, top1, mask, mesh):
        """(frac, mean_p) of the global batch on a data mesh: this rank's
        valid-token count and sums, summed over the data group."""
        b, s, E = probs.shape
        if mask is not None:
            w = mask.to(probs.dtype)[:, None, None]
            cnt = (w.sum() * s).reshape(1)
            top1, probs = top1 * w, probs * w
        else:
            cnt = torch.full((1,), float(b * s), dtype=probs.dtype,
                             device=probs.device)
        stats = shared_sum(torch.cat([cnt, top1.sum(dim=(0, 1)),
                                      probs.sum(dim=(0, 1))]), mesh)
        total = stats[0]
        if mask is not None:
            total = torch.clamp(total, min=1.0)
        return stats[1:1 + E] / total, stats[1 + E:] / total

    def _experts(self, params: Params):
        """(the mesh of the expert region or None, the index of this
        rank's first expert, its expert count): None when the rank holds
        every expert."""
        el = params["w1"].shape[0]
        if el == self.nexpert:
            return None, 0, el
        mesh = get_active_mesh()
        return mesh, mesh.expert_rank * el, el

    def _ffn_bias(self, params: Params, name: str, dt: torch.dtype):
        return params[name].to(dt) if name in params else None

    def dense_compute(self, params: Params, xs: torch.Tensor,
                      combine: torch.Tensor) -> torch.Tensor:
        """Every expert on every token, masked by `combine` (b, s, E); on
        an expert mesh this rank's experts, their sum reduced over the
        expert group."""
        dt = xs.dtype
        emesh, lo, el = self._experts(params)
        if emesh is not None:
            xs = enter(xs, emesh, EXPERT_AXIS)
            combine = enter(combine, emesh, EXPERT_AXIS)[..., lo:lo + el]
        h1 = torch.einsum("bse,ghe->bsgh", xs, params["w1"].to(dt))
        b1 = self._ffn_bias(params, "b1", dt)
        if b1 is not None:
            h1 = h1 + b1[None, None]
        h1 = nn_ops.relu(h1)
        ye = torch.einsum("bsgh,geh->bsge", h1, params["w2"].to(dt))
        b2 = self._ffn_bias(params, "b2", dt)
        if b2 is not None:
            ye = ye + b2[None, None]
        out = torch.einsum("bsge,bsg->bse", ye, combine.to(dt))
        return out if emesh is None else reduce(out, emesh, EXPERT_AXIS)

    def sparse_compute(self, params: Params, xs: torch.Tensor,
                       topv: torch.Tensor, topi: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Capacity dispatch: expert buffers of C slots filled in
        (slot-major, token) order; padding rows claim no slot. On a data
        mesh C and the order are the global batch's; on an expert mesh
        this rank fills and runs its experts' buffers only."""
        b, s, e = xs.shape
        t = b * s
        E, k = self.nexpert, self.top_k
        mesh = get_active_mesh()
        nd = data_axis_size(mesh)
        cap = max(1, min(int(math.ceil(k * t * nd / E * self.capacity)),
                         t * nd))
        xt = xs.reshape(t, e)
        dt = topv.dtype
        topv = topv.reshape(t, k)
        assign = F.one_hot(topi.reshape(t, k), E).to(dt)         # t,k,E
        if mask is not None:
            tok = mask.to(dt).repeat_interleave(s)
            assign = assign * tok[:, None, None]
        if nd == 1:
            flat = assign.transpose(0, 1).reshape(k * t, E)
            pos = torch.cumsum(flat, dim=0) - flat             # arrivals
            pos = pos.reshape(k, t, E).transpose(0, 1)         # t,k,E
        else:
            # arrivals before this rank's: every rank's in an earlier
            # slot, and the earlier ranks' in this slot
            every = torch.stack(distributed.all_gather(
                assign.sum(dim=0), mesh.group))                # nd,k,E
            tot = every.sum(dim=0)
            base = torch.cumsum(tot, dim=0) - tot + every[:mesh.rank].sum(0)
            pos = torch.cumsum(assign, dim=0) - assign + base[None]
        pos = (pos * assign).sum(dim=2).to(torch.int64)         # t,k
        keep = (pos < cap).to(dt)
        # a position past the buffer gets slot cap-1 here and is zeroed
        # by `keep` in the dispatch (jax.nn.one_hot gives it no slot)
        slot = F.one_hot(pos.clamp(max=cap - 1), cap).to(dt)   # t,k,cap
        emesh, lo, el = self._experts(params)
        if emesh is not None:
            xt = enter(xt, emesh, EXPERT_AXIS)
            topv = enter(topv, emesh, EXPERT_AXIS)
        disp = torch.einsum("tke,tkc,tk->tec", assign, slot, keep)
        comb = torch.einsum("tec,tk,tke->tec", disp, topv, assign)
        if emesh is not None:
            disp, comb = disp[:, lo:lo + el], comb[:, lo:lo + el]
        xdt = xt.dtype
        ein = torch.einsum("tec,td->ecd", disp.to(xdt), xt)
        h1 = torch.einsum("ecd,ehd->ech", ein, params["w1"].to(xdt))
        b1 = self._ffn_bias(params, "b1", xdt)
        if b1 is not None:
            h1 = h1 + b1[:, None]
        h1 = nn_ops.relu(h1)
        ye = torch.einsum("ech,edh->ecd", h1, params["w2"].to(xdt))
        b2 = self._ffn_bias(params, "b2", xdt)
        if b2 is not None:
            ye = ye + b2[:, None]
        out = torch.einsum("tec,ecd->td", comb.to(xdt), ye)
        if emesh is not None:
            out = reduce(out, emesh, EXPERT_AXIS)
        return out.reshape(b, s, e)

    def forward_with_aux(self, params, inputs, train=False, gen=None,
                         keep=None, mask=None
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        x = inputs[0]
        b, _, s, e = x.shape
        xs = x.reshape(b, s, e)
        logits = xs @ params["gate"].to(x.dtype).t()
        probs = torch.softmax(logits.float(), dim=-1)
        sparse = self.capacity > 0
        # inference has no use for the aux term: its statistics (a
        # collective on a data mesh) are taken in training only
        need_aux = train and bool(self.aux_scale)
        combine, aux, topv, topi = self.route(
            probs, mask, need_combine=not sparse, need_aux=need_aux)
        if sparse:
            out = self.sparse_compute(params, xs, topv, topi, mask)
        else:
            out = self.dense_compute(params, xs, combine)
        # scaled by this rank's rows: the trainer's 1/(batch *
        # update_period) leaves the aux term batch-size-invariant, and
        # on a data mesh the ranks' terms add up to the global one
        aux_term = ((self.aux_scale * b) * aux if need_aux
                    else torch.zeros((), device=x.device))
        return [out.reshape(b, 1, s, e)], aux_term.float()

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return self.forward_with_aux(params, inputs, train=train)[0]
