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

    # ------------------------------------------------------------------
    def route(self, probs: torch.Tensor, mask: Optional[torch.Tensor] = None,
              need_combine: bool = True):
        """(b, s, E) float32 probs -> (combine (b, s, E) or None, aux,
        topv (b, s, k), topi (b, s, k)). Padding rows (mask 0) stay out
        of the load-balance statistics."""
        topv, topi = torch.topk(probs, self.top_k, dim=-1)
        onehot = F.one_hot(topi, self.nexpert).to(probs.dtype)  # b,s,k,E
        combine = ((onehot * topv[..., None]).sum(dim=2)
                   if need_combine else None)
        top1 = onehot[:, :, 0]                                  # b,s,E
        if mask is not None:
            w = mask.to(probs.dtype)[:, None, None]
            total = torch.clamp(w.sum() * probs.shape[1], min=1.0)
            frac = (top1 * w).sum(dim=(0, 1)) / total
            mean_p = (probs * w).sum(dim=(0, 1)) / total
        else:
            frac = top1.mean(dim=(0, 1))
            mean_p = probs.mean(dim=(0, 1))
        aux = self.nexpert * (frac * mean_p).sum()
        return combine, aux, topv, topi

    def _ffn_bias(self, params: Params, name: str, dt: torch.dtype):
        return params[name].to(dt) if name in params else None

    def dense_compute(self, params: Params, xs: torch.Tensor,
                      combine: torch.Tensor) -> torch.Tensor:
        """Every expert on every token, masked by `combine` (b, s, E)."""
        dt = xs.dtype
        h1 = torch.einsum("bse,ghe->bsgh", xs, params["w1"].to(dt))
        b1 = self._ffn_bias(params, "b1", dt)
        if b1 is not None:
            h1 = h1 + b1[None, None]
        h1 = nn_ops.relu(h1)
        ye = torch.einsum("bsgh,geh->bsge", h1, params["w2"].to(dt))
        b2 = self._ffn_bias(params, "b2", dt)
        if b2 is not None:
            ye = ye + b2[None, None]
        return torch.einsum("bsge,bsg->bse", ye, combine.to(dt))

    def sparse_compute(self, params: Params, xs: torch.Tensor,
                       topv: torch.Tensor, topi: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Capacity dispatch: expert buffers of C slots filled in
        (slot-major, token) order; padding rows claim no slot."""
        b, s, e = xs.shape
        t = b * s
        E, k = self.nexpert, self.top_k
        cap = max(1, min(int(math.ceil(k * t / E * self.capacity)), t))
        xt = xs.reshape(t, e)
        dt = topv.dtype
        topv = topv.reshape(t, k)
        assign = F.one_hot(topi.reshape(t, k), E).to(dt)         # t,k,E
        if mask is not None:
            tok = mask.to(dt).repeat_interleave(s)
            assign = assign * tok[:, None, None]
        flat = assign.transpose(0, 1).reshape(k * t, E)
        pos = torch.cumsum(flat, dim=0) - flat                 # arrivals
        pos = pos.reshape(k, t, E).transpose(0, 1)             # t,k,E
        pos = (pos * assign).sum(dim=2).to(torch.int64)         # t,k
        keep = (pos < cap).to(dt)
        # a position past the buffer gets slot cap-1 here and is zeroed
        # by `keep` in the dispatch (jax.nn.one_hot gives it no slot)
        slot = F.one_hot(pos.clamp(max=cap - 1), cap).to(dt)   # t,k,cap
        disp = torch.einsum("tke,tkc,tk->tec", assign, slot, keep)
        comb = torch.einsum("tec,tk,tke->tec", disp, topv, assign)
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
        combine, aux, topv, topi = self.route(probs, mask,
                                              need_combine=not sparse)
        if sparse:
            out = self.sparse_compute(params, xs, topv, topi, mask)
        else:
            out = self.dense_compute(params, xs, combine)
        # scaled by batch: the trainer's 1/(batch*update_period) leaves
        # the aux term batch-size-invariant
        aux_term = ((self.aux_scale * b) * aux if self.aux_scale
                    else torch.zeros((), device=x.device))
        return [out.reshape(b, 1, s, e)], aux_term.float()

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return self.forward_with_aux(params, inputs, train=train)[0]
