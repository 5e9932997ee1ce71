"""Sequence layers: attention, attention_naive, seq_fullc, layernorm,
pos_embed (counterpart of cxxnet_tpu/layers/attention.py).

They work on "sequence nodes" of shape (batch, 1, seq, embed) - the NCHW
matrix convention with a real y dim as the sequence.

attention  multi-head self-attention. Params: qkv projection `wmat`
           (3*embed, embed), output projection `wproj` (embed, embed),
           optional `bias` (3*embed,). `causal = 1` masks the future;
           `nhead` sets the heads. The core is ops/flash_attention.py:
           the hand-written kernels K2-fwd / K2-dq / K2-dkv on the card,
           at every head_dim and every length (past 256 on the kernels'
           wide route; the JAX package takes the TPU kernel only where
           Mosaic can tile the shapes),
           their plain versions on the CPU; on a data mesh each rank
           runs them on its own rows (the port of the JAX package's
           `flash_attention_sharded`, a shard_map with no collective).
           On a seq-sharded block (a `seq` mesh axis, nnet/network.py)
           the core is ring or Ulysses attention over the seq ranks
           (parallel/ring.py), as `seq_parallel = ring|ulysses` says;
           `seq_parallel = none` makes the network gather the sequence
           first and the layer runs whole. `kv_block` tiles the JAX
           package's XLA path and does not change the function.
attention_naive  the same layer with the full-matrix naive core - the
           trusted side of the pairtest harness.
seq_fullc  position-wise fully connected, (b,1,s,e) -> (b,1,s,nhidden).

Under a model mesh axis (parallel/tensor.py) attention's qkv rows and
seq_fullc's output features are column parallel and attention's output
projection `wproj` row parallel (its columns cut). The qkv rows are
laid out (3, nhead, e/nhead), so a contiguous block of them is not a
set of heads: the block's product is gathered whole, each rank takes
its nhead/M heads of q, k and v, runs the core on them, multiplies by
its columns of `wproj` (whole heads: the heads are head-major in the
projection's input) and one all-reduce sums the ranks' products.
Where nhead % M != 0 every rank runs every head and takes its block of
the heads' output before the projection.
layernorm  per-position normalisation over the embed dim with learnable
           slope/bias (eps 1e-5).
pos_embed  learned additive positional embedding `wmat` (seq, embed);
           on a seq-sharded block the rank adds its block of the table.

seq_fullc, layernorm and pos_embed are position-wise and run on a
seq-sharded block as they are (`seq_local`); attention_naive is not
(its core takes the whole sequence).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from cxxnet_tpu_torch.layers.base import (
    Layer, Params, Shape, register_layer, seq_block_mesh)
from cxxnet_tpu_torch.ops import attention as attn_ops
from cxxnet_tpu_torch.ops.flash_attention import flash_attention
from cxxnet_tpu_torch.parallel import tensor as tp
from cxxnet_tpu_torch.parallel.mesh import model_axis_size
from cxxnet_tpu_torch.parallel.ring import (
    SEQ_SCHEMES, seq_parallel_attention)


def layer_norm(x: torch.Tensor, slope: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Normalise the last dim in float32 (biased variance), then slope
    and bias, and cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * slope + bias).to(x.dtype)


def qkv_heads(xs: torch.Tensor, wqkv: torch.Tensor, bqkv, nhead: int):
    """(b, s, e) x (3e, e) [+ (3e,)] -> q, k, v as (b, h, s, e/h). The
    weights are cast to the activation dtype."""
    b, s, e = xs.shape
    qkv = xs @ wqkv.to(xs.dtype).t()
    if bqkv is not None:
        qkv = qkv + bqkv.to(xs.dtype)[None, None, :]
    qkv = qkv.reshape(b, s, 3, nhead, e // nhead)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def heads_proj(o: torch.Tensor, wproj: torch.Tensor) -> torch.Tensor:
    """(b, h, s, d) heads -> (b, s, e) through the output projection."""
    b, h, s, d = o.shape
    o = o.transpose(1, 2).reshape(b, s, h * d)
    return o @ wproj.to(o.dtype).t()


@register_layer
class AttentionLayer(Layer):
    """Multi-head self-attention on (b, 1, s, e) sequence nodes."""

    type_name = "attention"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.nhead = 1
        self.causal = 0
        self.seq_parallel = "ring"
        self.kv_block = 512

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "nhead":
            self.nhead = int(val)
        if name == "causal":
            self.causal = int(val)
        if name == "seq_parallel":
            if val not in SEQ_SCHEMES:
                raise ValueError(
                    "seq_parallel must be ring, ulysses or none")
            self.seq_parallel = val
        if name == "kv_block":
            self.kv_block = int(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        b, c, s, e = in_shapes[0]
        if c != 1:
            raise ValueError(
                "AttentionLayer: input must be a sequence node "
                f"(b,1,seq,embed); got channel={c}")
        if e % self.nhead != 0:
            raise ValueError(
                f"AttentionLayer: embed {e} not divisible by "
                f"nhead {self.nhead}")
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        e = in_shapes[0][3]
        shapes = {"wmat": (3 * e, e), "wproj": (e, e)}
        if self.param.no_bias == 0:
            shapes["bias"] = (3 * e,)
        return shapes

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        e = in_shapes[0][3]
        params = {
            "wmat": self.param.rand_init_weight(gen, (3 * e, e), in_num=e,
                                                out_num=3 * e),
            "wproj": self.param.rand_init_weight(gen, (e, e), in_num=e,
                                                 out_num=e)}
        if self.param.no_bias == 0:
            params["bias"] = torch.full((3 * e,), self.param.init_bias)
        return params

    def param_tags(self) -> Dict[str, str]:
        return {"wmat": "wmat", "wproj": "wmat", "bias": "bias"}

    def model_shard_dims(self) -> Dict[str, int]:
        # qkv rows column parallel, the output projection's columns
        # row parallel (closed by one all-reduce)
        return {"wmat": 0, "bias": 0, "wproj": 1}

    def seq_local(self) -> bool:
        return self.seq_parallel != "none"

    def core(self, q, k, v):
        """The attention core on (b, h, s, d) heads: ring / Ulysses
        attention on a seq-sharded block, else K2 (the plain versions on
        the CPU)."""
        o = seq_parallel_attention(q, k, v, seq_block_mesh(),
                                   self.seq_parallel,
                                   causal=bool(self.causal))
        if o is not None:
            return o
        return flash_attention(q, k, v, bool(self.causal))

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b, _, s, e = x.shape
        tmesh = tp.model_mesh()
        if tmesh is not None and (params["wmat"].shape[0] != 3 * e
                                  or params["wproj"].shape[1] != e):
            return [self._forward_tp(x.reshape(b, s, e), params,
                                     tmesh).reshape(b, 1, s, e)]
        q, k, v = qkv_heads(x.reshape(b, s, e), params["wmat"],
                            params.get("bias"), self.nhead)
        out = heads_proj(self.core(q, k, v), params["wproj"])
        return [out.reshape(b, 1, s, e)]

    def _forward_tp(self, xs, params, tmesh):
        """The layer with its params cut over 'model' (see the module
        docstring); xs (b, s, e) whole, the output (b, s, e) whole."""
        b, s, e = xs.shape
        h, d = self.nhead, e // self.nhead
        wq, wp, bq = params["wmat"], params["wproj"], params.get("bias")

        def proj(t):
            out = t @ wq.to(t.dtype).t()
            return out if bq is None else out + bq.to(t.dtype)[None, None, :]
        qkv = (tp.column(xs, 2, tmesh, proj) if wq.shape[0] != 3 * e
               else proj(xs))
        if wp.shape[1] == e:
            heads = qkv.reshape(b, s, 3, h, d)
            o = self.core(*(heads[:, :, i].transpose(1, 2)
                            for i in range(3)))
            return heads_proj(o, wp)
        if h % model_axis_size(tmesh) == 0:
            # this rank's heads only; the enter sums the ranks' head
            # gradients into the whole qkv gradient
            heads = tp.enter(qkv, tmesh).reshape(b, s, 3, h, d)
            mine = tp.block(h, tmesh)
            o = self.core(*(heads[:, :, i, mine].transpose(1, 2)
                            for i in range(3)))
            o = o.transpose(1, 2).reshape(b, s, -1)
        else:
            heads = qkv.reshape(b, s, 3, h, d)
            o = self.core(*(heads[:, :, i].transpose(1, 2)
                            for i in range(3)))
            o = tp.enter(o.transpose(1, 2).reshape(b, s, e), tmesh)
            o = o[:, :, tp.block(e, tmesh)]
        return tp.reduce(o @ wp.to(o.dtype).t(), tmesh)


@register_layer
class AttentionNaiveLayer(AttentionLayer):
    """attention_naive: the attention layer with the full-matrix naive
    core (plain torch on every device)."""

    type_name = "attention_naive"

    def seq_local(self) -> bool:
        return False

    def core(self, q, k, v):
        return attn_ops.naive_attention(q, k, v, causal=bool(self.causal))


@register_layer
class SeqFullcLayer(Layer):
    """seq_fullc: position-wise fully connected on (b, 1, s, e) sequence
    nodes -> (b, 1, s, nhidden); the transformer FFN building block."""

    type_name = "seq_fullc"

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        b, c, s, e = in_shapes[0]
        if c != 1:
            raise ValueError("seq_fullc: input must be a sequence node")
        if self.param.num_hidden <= 0:
            raise ValueError("seq_fullc: must set nhidden correctly")
        self.param.num_input_node = e
        return [(b, 1, s, self.param.num_hidden)]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        shapes = {"wmat": (self.param.num_hidden, in_shapes[0][3])}
        if self.param.no_bias == 0:
            shapes["bias"] = (self.param.num_hidden,)
        return shapes

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        e = in_shapes[0][3]
        nh = self.param.num_hidden
        params = {"wmat": self.param.rand_init_weight(gen, (nh, e), in_num=e,
                                                      out_num=nh)}
        if self.param.no_bias == 0:
            params["bias"] = torch.full((nh,), self.param.init_bias)
        return params

    def param_tags(self) -> Dict[str, str]:
        return {"wmat": "wmat", "bias": "bias"}

    def model_shard_dims(self) -> Dict[str, int]:
        return {"wmat": 0, "bias": 0}

    def seq_local(self) -> bool:
        return True

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b, _, s, e = x.shape
        xs = x.reshape(b, s, e)

        def local(t):
            out = t @ params["wmat"].t()
            if "bias" in params:
                out = out + params["bias"][None, None, :]
            return out
        tmesh = tp.model_mesh()
        if (tmesh is not None
                and params["wmat"].shape[0] != self.param.num_hidden):
            out = tp.column(xs, 2, tmesh, local)
        else:
            out = local(xs)
        return [out.reshape(b, 1, s, -1)]


@register_layer
class LayerNormLayer(Layer):
    """Per-position layer normalisation over the last (embed) dim."""

    type_name = "layernorm"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.eps = 1e-5
        self.init_slope = 1.0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "eps":
            self.eps = float(val)
        if name == "init_slope":
            self.init_slope = float(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        e = in_shapes[0][3]
        return {"slope": (e,), "bias": (e,)}

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        e = in_shapes[0][3]
        return {"slope": torch.full((e,), self.init_slope),
                "bias": torch.full((e,), self.param.init_bias)}

    def param_tags(self) -> Dict[str, str]:
        # batch_norm's visitor tags: slope under wmat, bias under bias
        return {"slope": "wmat", "bias": "bias"}

    def seq_local(self) -> bool:
        return True

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return [layer_norm(inputs[0], params["slope"], params["bias"],
                           self.eps)]


@register_layer
class PosEmbedLayer(Layer):
    """Learned additive positional embedding on (b, 1, s, e) nodes."""

    type_name = "pos_embed"

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        _, _, s, e = in_shapes[0]
        return {"wmat": (s, e)}

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        _, _, s, e = in_shapes[0]
        return {"wmat": self.param.rand_init_weight(gen, (s, e), in_num=e,
                                                    out_num=e)}

    def param_tags(self) -> Dict[str, str]:
        return {"wmat": "wmat"}

    def seq_local(self) -> bool:
        return True

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        w = params["wmat"]
        mesh = seq_block_mesh()
        if mesh is not None:
            s = x.shape[2]
            w = w[mesh.seq_rank * s:(mesh.seq_rank + 1) * s]
        return [x + w[None, None, :, :].to(x.dtype)]
