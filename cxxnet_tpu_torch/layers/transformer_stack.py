"""transformer_stack: L identical pre-norm transformer blocks with their
params stacked on a leading L dim (counterpart of
cxxnet_tpu/layers/transformer_stack.py).

    x = x + Wproj . attn(layernorm(x))
    x = x + W2 . relu(W1 . layernorm(x) + b1) + b2

on (b, 1, s, e) sequence nodes. The params keep the JAX package's names,
shapes (L, ...) and tags, so convert.py and the checkpoint format carry
them unchanged. The port runs the JAX package's sequential route: a
Python loop over the L stacked slices (the JAX package's lax.scan). The
attention core is ops/flash_attention.py - K2-fwd, and in training
K2-dq / K2-dkv, on the card; their plain versions on the CPU - the
function the JAX package's blockwise core computes.

Config keys: nlayer, nhead, nhidden (the FFN width), causal, eps, and
the JAX package's pipeline / sequence-parallel keys microbatch,
kv_block and seq_parallel, validated as there. On a seq-sharded block
(a `seq` mesh axis, nnet/network.py) every block's attention core is
ring or Ulysses attention over the seq ranks (parallel/ring.py), as
`seq_parallel` says - the JAX package's sequential route with its
`seq_mesh`; `seq_parallel = none` makes the network gather the
sequence first. microbatch acts only under a `pipe` axis, which is not
ported (it raises); kv_block tiles the JAX package's XLA core and does
not change the function.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from cxxnet_tpu_torch.layers.attention import (
    heads_proj, layer_norm, qkv_heads)
from cxxnet_tpu_torch.layers.base import (
    Layer, Params, Shape, register_layer, seq_block_mesh)
from cxxnet_tpu_torch.ops import nn as nn_ops
from cxxnet_tpu_torch.ops.flash_attention import flash_attention
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

    def seq_local(self) -> bool:
        return self.seq_parallel != "none"

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

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b, _, s, e = x.shape
        out = x.reshape(b, s, e)
        for i in range(self.nlayer):
            out = self.block({k: params[k][i] for k in _PARAMS}, out)
        return [out.reshape(b, 1, s, e)]
