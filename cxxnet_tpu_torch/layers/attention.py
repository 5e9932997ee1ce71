"""Sequence layers: attention, attention_naive, seq_fullc, layernorm,
pos_embed (counterpart of cxxnet_tpu/layers/attention.py).

They work on "sequence nodes" of shape (batch, 1, seq, embed) - the NCHW
matrix convention with a real y dim as the sequence.

attention  multi-head self-attention. Params: qkv projection `wmat`
           (3*embed, embed), output projection `wproj` (embed, embed),
           optional `bias` (3*embed,). `causal = 1` masks the future;
           `nhead` sets the heads. The core is ops/flash_attention.py:
           the hand-written kernels K2-fwd / K2-dq / K2-dkv on the card,
           at every head_dim up to 256 and every length (the JAX package
           takes the TPU kernel only where Mosaic can tile the shapes),
           their plain versions on the CPU. `seq_parallel` and
           `kv_block` are accepted: the first acts only under a mesh
           (and `mesh` is not ported), the second tiles the JAX
           package's XLA path and does not change the function.
attention_naive  the same layer with the full-matrix naive core - the
           trusted side of the pairtest harness.
seq_fullc  position-wise fully connected, (b,1,s,e) -> (b,1,s,nhidden).
layernorm  per-position normalisation over the embed dim with learnable
           slope/bias (eps 1e-5).
pos_embed  learned additive positional embedding `wmat` (seq, embed).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from cxxnet_tpu_torch.layers.base import Layer, Params, Shape, register_layer
from cxxnet_tpu_torch.ops import attention as attn_ops
from cxxnet_tpu_torch.ops.flash_attention import flash_attention

SEQ_SCHEMES = ("ring", "ulysses", "none")


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

    def core(self, q, k, v):
        return flash_attention(q, k, v, bool(self.causal))

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b, _, s, e = x.shape
        q, k, v = qkv_heads(x.reshape(b, s, e), params["wmat"],
                            params.get("bias"), self.nhead)
        out = heads_proj(self.core(q, k, v), params["wproj"])
        return [out.reshape(b, 1, s, e)]


@register_layer
class AttentionNaiveLayer(AttentionLayer):
    """attention_naive: the attention layer with the full-matrix naive
    core (plain torch on every device)."""

    type_name = "attention_naive"

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

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b, _, s, e = x.shape
        out = x.reshape(b, s, e) @ params["wmat"].t()
        if "bias" in params:
            out = out + params["bias"][None, None, :]
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

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        return [x + params["wmat"][None, None, :, :].to(x.dtype)]
