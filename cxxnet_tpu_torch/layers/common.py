"""The non-loss layers of the port (counterpart of
cxxnet_tpu/layers/common.py): fullc, fixconn, conv, max/sum/avg
pooling, insanity_max_pooling, the activations (relu, sigmoid, tanh,
softplus, gelu, xelu, insanity, prelu), lrn, batch_norm, dropout, bias,
flatten, split, concat / ch_concat and add. Each class names the
reference file it mirrors; the backward is autograd's through the
forward.

The layers that draw random numbers in training (dropout, insanity,
prelu with `random > 0`, insanity_max_pooling) draw from the
generator the network hands them, or take the caller's injected draw
(`keep`): dropout's boolean mask, the others' uniform tensor.

fullc and conv take the graph passes' stamps (`fused_act = relu`,
fullc's `flatten_input = 1`) and, when the quantize_int8 pass hands
them `wmat_q` (int8) with frozen `ascale` / `wscale` instead of `wmat`,
run the int8 route of ops/int8.py: quantize the input, an int8 x int8
-> int32 contraction (K3 on the card), then in float32 the dequantize,
the bias and the fused activation, and a cast back to the input's
dtype - the JAX package's order.

Under a model mesh axis (parallel/tensor.py) fullc and conv are column
parallel (their output features / channels cut over 'model'), prelu
and batch_norm cut their per-channel params the same way: a layer
whose params arrive cut runs on its block of the features inside
tensor.column (enter, the local op, gather), so its output is whole
again."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from cxxnet_tpu_torch.layers.base import (
    Layer, Params, Shape, get_active_step, is_mat, rank_rand,
    register_layer, uniform_draw)
from cxxnet_tpu_torch.ops import conv as conv_ops
from cxxnet_tpu_torch.ops import int8 as int8_ops
from cxxnet_tpu_torch.ops import nn as nn_ops
from cxxnet_tpu_torch.ops import pooling as pool_ops
from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel import tensor as tp
from cxxnet_tpu_torch.parallel.mesh import (
    data_axis_size, get_active_mesh, model_axis_size)


def _fused_act(val: str) -> str:
    """The `fused_act` stamp of the fuse_activation pass: '' or relu."""
    if val not in ("", "relu"):
        raise ValueError(f"fused_act must be '' or relu, got {val!r}")
    return val


def _int8_epilogue(acc: torch.Tensor, params: Params, fused_act: str,
                   dtype: torch.dtype) -> torch.Tensor:
    """int32 accumulator -> the layer's output: dequantize, + bias and
    the fused activation in float32, then the input's dtype."""
    out = int8_ops.dequantize(acc, params["ascale"], params["wscale"])
    if "bias" in params:
        bias = params["bias"].float()
        out = out + (bias[None, :, None, None] if out.dim() == 4
                     else bias[None, :])
    if fused_act == "relu":
        out = nn_ops.relu(out)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# fully connected
# ---------------------------------------------------------------------------

class _GatherMatmul(torch.autograd.Function):
    """`x @ w.T` whose weight gradient rides activation gathering instead
    of a gradient all-reduce - `fullc_gather = 1` on a data mesh (the
    JAX package's _fullc_gather_matmul, cxxnet_tpu/layers/common.py:27-70;
    the reference pushes the b x (nin+nout) activations to the server
    and recomputes dw there). The backward all-gathers x and the output
    gradient over the data axis in one collective and computes the FULL
    dw on every rank, so the trainer leaves this weight out of the
    gradient all-reduce; dx stays local."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return x @ w.t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        nin = x.shape[1]
        both = distributed.all_gather(
            torch.cat([x, g.to(x.dtype)], dim=1), ctx.group)
        full = torch.cat(both, dim=0)
        xg, gg = full[:, :nin], full[:, nin:].to(g.dtype)
        return g @ w, gg.t() @ xg, None


@register_layer
class FullConnectLayer(Layer):
    """fullc (src/layer/fullc_layer-inl.hpp:14-146).

    out = in . W^T + bias; W shape (nhidden, num_input_node).
    `fullc_gather = 1` only changes how the data-parallel weight gradient
    is reduced (_GatherMatmul, in training on a data mesh), so it is
    inert at inference and on one device.
    """

    type_name = "fullc"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.fused_act = ""
        self.flatten_input = 0
        self.fullc_gather = 0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "fullc_gather":
            self.fullc_gather = int(val)
        if name == "fused_act":
            self.fused_act = _fused_act(val)
        if name == "flatten_input":
            # stamped by elim_reshape: take a 4-D input node flattened
            # (the forward reshapes to (b, -1) either way)
            self.flatten_input = int(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        (b, c, h, w) = in_shapes[0]
        if not is_mat(in_shapes[0]) and not self.flatten_input:
            raise ValueError("FullcLayer: input needs to be a matrix")
        if self.param.num_hidden <= 0:
            raise ValueError("FullcLayer: must set nhidden correctly")
        self.param.num_input_node = c * h * w
        return [(b, 1, 1, self.param.num_hidden)]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        nin = in_shapes[0][1] * in_shapes[0][2] * in_shapes[0][3]
        shapes = {"wmat": (self.param.num_hidden, nin)}
        if self.param.no_bias == 0:
            shapes["bias"] = (self.param.num_hidden,)
        return shapes

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        shapes = self.param_shapes(in_shapes)
        nhidden, nin = shapes["wmat"]
        params = {"wmat": self.param.rand_init_weight(
            gen, shapes["wmat"], in_num=nin, out_num=nhidden)}
        if "bias" in shapes:
            params["bias"] = torch.full(shapes["bias"],
                                        self.param.init_bias)
        return params

    def param_tags(self) -> Dict[str, str]:
        return {"wmat": "wmat", "bias": "bias"}

    def model_shard_dims(self) -> Dict[str, int]:
        # Megatron column parallelism: the output features
        return {"wmat": 0, "bias": 0}

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b = x.shape[0]
        m = x.reshape(b, -1)
        tmesh = tp.model_mesh()
        if (tmesh is not None and "wmat" in params
                and params["wmat"].shape[0] != self.param.num_hidden):
            def local(mm):
                out = mm @ params["wmat"].t()
                if "bias" in params:
                    out = out + params["bias"][None, :]
                return nn_ops.relu(out) if self.fused_act == "relu" else out
            return [tp.column(m, 1, tmesh, local).reshape(b, 1, 1, -1)]
        if "wmat_q" in params:
            acc = int8_ops.int8_matmul(
                int8_ops.quantize_act(m, params["ascale"]),
                params["wmat_q"])
            out = _int8_epilogue(acc, params, self.fused_act, m.dtype)
            return [out.reshape(b, 1, 1, -1)]
        mesh = get_active_mesh()
        if (self.fullc_gather and data_axis_size(mesh) > 1
                and model_axis_size(mesh) == 1):
            # gather-mode wgrad needs a replicated weight: off under a
            # model axis, as in the JAX package
            out = _GatherMatmul.apply(m, params["wmat"], mesh.group)
        else:
            out = m @ params["wmat"].t()
        if "bias" in params:
            out = out + params["bias"][None, :]
        if self.fused_act == "relu":
            out = nn_ops.relu(out)
        return [out.reshape(b, 1, 1, -1)]


@register_layer
class FixConnectLayer(Layer):
    """fixconn (src/layer/fixconn_layer-inl.hpp:14-100): fully connected
    with a frozen weight read from a sparse text file (`fixconn_weight`:
    nrow ncol nonzero, then `row col value` triples) at shape
    inference. The weight is no param: it lives on the layer (one copy
    per device it has run on) and takes no gradient."""

    type_name = "fixconn"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.fname_weight = "NULL"
        self._wmat: Optional[torch.Tensor] = None
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "fixconn_weight":
            self.fname_weight = val

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        if not is_mat(in_shapes[0]):
            raise ValueError("FixConnLayer: input needs to be a matrix")
        if self.param.num_hidden <= 0:
            raise ValueError("FixConnLayer: must set nhidden correctly")
        if self.fname_weight == "NULL":
            raise ValueError("FixConnLayer: must specify fixconn_weight")
        w = np.zeros((self.param.num_hidden, in_shapes[0][3]),
                     dtype=np.float32)
        with open(self.fname_weight, "r", encoding="utf-8") as f:
            toks = f.read().split()
        nrow, ncol, nonzero = int(toks[0]), int(toks[1]), int(toks[2])
        if (nrow, ncol) != w.shape:
            raise ValueError(
                "FixConnLayer: fixconn_weight shape does not match "
                "architecture")
        vals = toks[3:3 + 3 * nonzero]
        for i in range(nonzero):
            w[int(vals[3 * i]), int(vals[3 * i + 1])] = float(
                vals[3 * i + 2])
        self._wmat = torch.from_numpy(w)
        self._on_device = {}
        return [(in_shapes[0][0], 1, 1, self.param.num_hidden)]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b = x.shape[0]
        w = self._on_device.get(x.device)
        if w is None:
            w = self._on_device[x.device] = self._wmat.to(x.device)
        # the float32 weight promotes the product as jnp's matmul does
        m = x.reshape(b, -1)
        dt = torch.promote_types(m.dtype, w.dtype)
        out = m.to(dt) @ w.to(dt).t()
        return [out.reshape(b, 1, 1, -1)]


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

@register_layer
class ConvolutionLayer(Layer):
    """conv (src/layer/convolution_layer-inl.hpp:13-228).

    Weight stored as OIHW (nchannel, in_ch/ngroup, ky, kx), as in the JAX
    package; grouped conv maps to `groups`. `space_to_depth` (a TPU
    matrix-unit rewrite that computes the same sums) is accepted and
    inert.
    """

    type_name = "conv"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.fused_act = ""

    def set_param(self, name: str, val: str) -> None:
        if name == "space_to_depth":
            if val not in ("auto", "0", "1"):
                raise ValueError(
                    f"space_to_depth must be auto, 0 or 1, got {val!r}")
            return
        if name == "fused_act":
            self.fused_act = _fused_act(val)
            return
        super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        b, c, h, w = in_shapes[0]
        p = self.param
        if c % p.num_group != 0:
            raise ValueError("input channels must divide group size")
        if p.num_channel % p.num_group != 0:
            raise ValueError("output channels must divide group size")
        if p.num_channel <= 0:
            raise ValueError("must set nchannel correctly")
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("must set kernel_size correctly")
        if p.kernel_width > w or p.kernel_height > h:
            raise ValueError("kernel size exceeds input")
        p.num_input_channel = c
        oh = conv_ops.conv_out_dim(h, p.kernel_height, p.stride, p.pad_y)
        ow = conv_ops.conv_out_dim(w, p.kernel_width, p.stride, p.pad_x)
        return [(b, p.num_channel, oh, ow)]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        p = self.param
        ipg = in_shapes[0][1] // p.num_group
        shapes = {"wmat": (p.num_channel, ipg, p.kernel_height,
                           p.kernel_width)}
        if p.no_bias == 0:
            shapes["bias"] = (p.num_channel,)
        return shapes

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        p = self.param
        shapes = self.param_shapes(in_shapes)
        ipg = shapes["wmat"][1]
        # reference init args: in = in/g*ky*kx, out = out/g (InitModel:27-32)
        params = {"wmat": p.rand_init_weight(
            gen, shapes["wmat"],
            in_num=ipg * p.kernel_height * p.kernel_width,
            out_num=p.num_channel // p.num_group)}
        if "bias" in shapes:
            params["bias"] = torch.full(shapes["bias"], p.init_bias)
        return params

    def param_tags(self) -> Dict[str, str]:
        return {"wmat": "wmat", "bias": "bias"}

    def model_shard_dims(self) -> Dict[str, int]:
        # the output channels; shardings_for checks only O % axis size,
        # so a block may straddle group boundaries (_local_conv)
        return {"wmat": 0, "bias": 0}

    def _local_conv(self, x: torch.Tensor, w: torch.Tensor,
                    lo: int) -> torch.Tensor:
        """This rank's output channels [lo, lo + w.shape[0]) of the
        grouped conv: one conv over the input channels of the whole
        groups the block covers, or where it straddles a group
        boundary one conv per group piece, each against its own input
        channels."""
        p = self.param
        g = p.num_group
        if g == 1:
            return conv_ops.conv2d(x, w, p.stride, p.pad_y, p.pad_x, 1)
        opg, ipg = p.num_channel // g, x.shape[1] // g
        hi = lo + w.shape[0]
        if lo % opg == 0 and hi % opg == 0:
            return conv_ops.conv2d(
                x[:, lo // opg * ipg:hi // opg * ipg], w, p.stride,
                p.pad_y, p.pad_x, (hi - lo) // opg)
        pieces = []
        for grp in range(lo // opg, (hi - 1) // opg + 1):
            a, z = max(lo, grp * opg), min(hi, (grp + 1) * opg)
            pieces.append(conv_ops.conv2d(
                x[:, grp * ipg:(grp + 1) * ipg], w[a - lo:z - lo],
                p.stride, p.pad_y, p.pad_x, 1))
        return torch.cat(pieces, dim=1)

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        p = self.param
        tmesh = tp.model_mesh()
        if (tmesh is not None and "wmat" in params
                and params["wmat"].shape[0] != p.num_channel):
            w = params["wmat"]

            def local(x):
                out = self._local_conv(x, w, tmesh.model_rank * w.shape[0])
                if "bias" in params:
                    out = out + params["bias"][None, :, None, None]
                return nn_ops.relu(out) if self.fused_act == "relu" else out
            return [tp.column(inputs[0], 1, tmesh, local)]
        if "wmat_q" in params:
            x = inputs[0]
            acc = int8_ops.int8_conv2d(
                int8_ops.quantize_act(x, params["ascale"]),
                params["wmat_q"], p.stride, p.pad_y, p.pad_x, p.num_group)
            return [_int8_epilogue(acc, params, self.fused_act, x.dtype)]
        out = conv_ops.conv2d(inputs[0], params["wmat"], p.stride, p.pad_y,
                              p.pad_x, p.num_group)
        if "bias" in params:
            # a separate add, as the JAX package rounds it under bf16
            out = out + params["bias"][None, :, None, None]
        if self.fused_act == "relu":
            out = nn_ops.relu(out)
        return [out]


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

class PoolingLayer(Layer):
    """max/sum/avg pooling (src/layer/pooling_layer-inl.hpp:17-114).
    `pool_grad` picks the max-pool backward: `ties` (default, the
    reference's unpool) or `winner` (torch's native backward)."""

    mode = "max"
    pre_relu = False

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.pool_grad = "ties"

    def _winner_ok(self) -> bool:
        """winner mode only exists for the max backward."""
        return self.mode == "max"

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "pool_grad":
            if val not in ("ties", "winner"):
                raise ValueError(
                    f"pool_grad must be 'ties' or 'winner', got {val!r}")
            if val == "winner" and not self._winner_ok():
                raise ValueError(
                    f"pool_grad=winner is a max-pool backward option; "
                    f"'{self.type_name}' has no single-winner rule")
            self.pool_grad = val

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        b, c, h, w = in_shapes[0]
        p = self.param
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("must set kernel_size correctly")
        if p.pad_x >= p.kernel_width or p.pad_y >= p.kernel_height:
            raise ValueError(
                "pooling pad must be smaller than the kernel (all-padding "
                "windows would emit -inf/0)")
        if (p.kernel_width > w + 2 * p.pad_x
                or p.kernel_height > h + 2 * p.pad_y):
            raise ValueError("kernel size exceeds input")
        oh = pool_ops.pool_out_dim(h, p.kernel_height, p.stride, p.pad_y)
        ow = pool_ops.pool_out_dim(w, p.kernel_width, p.stride, p.pad_x)
        return [(b, c, oh, ow)]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        if self.pre_relu:
            x = nn_ops.relu(x)
        p = self.param
        return [pool_ops.pool2d(x, self.mode, p.kernel_height,
                                p.kernel_width, p.stride, p.pad_y, p.pad_x,
                                self.pool_grad)]


@register_layer
class MaxPoolingLayer(PoolingLayer):
    type_name = "max_pooling"
    mode = "max"


@register_layer
class SumPoolingLayer(PoolingLayer):
    type_name = "sum_pooling"
    mode = "sum"


@register_layer
class AvgPoolingLayer(PoolingLayer):
    type_name = "avg_pooling"
    mode = "avg"


@register_layer
class ReluMaxPoolingLayer(PoolingLayer):
    """relu fused before max pooling (layer_impl-inl.hpp:55-56)."""
    type_name = "relu_max_pooling"
    mode = "max"
    pre_relu = True


@register_layer
class InsanityPoolingLayer(PoolingLayer):
    """insanity_max_pooling (src/layer/insanity_pooling_layer-inl.hpp):
    stochastic displaced max pooling in training (ops/pooling.py
    insanity_pool2d, one uniform draw per source pixel), plain max
    pooling at eval. `keep` is the probability that a source pixel is
    read in place. No `pad` (the jitter clamps at the true border) and
    no `pool_grad = winner` (the backward is the slot rule)."""

    type_name = "insanity_max_pooling"
    mode = "max"
    uses_rng = True

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.p_keep = 1.0

    def _winner_ok(self) -> bool:
        return False

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "keep":
            self.p_keep = float(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        if self.param.pad_x or self.param.pad_y:
            raise ValueError(
                "insanity_max_pooling does not support pad (the jitter "
                "clamps at the true image border)")
        return super().infer_shapes(in_shapes)

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        p = self.param
        if train:
            flag = uniform_draw(x.shape, torch.float32, x.device, gen, keep,
                                self.type_name)
            return [pool_ops.insanity_pool2d(x, flag, p.kernel_height,
                                             p.kernel_width, p.stride,
                                             self.p_keep)]
        return [pool_ops.pool2d(x, "max", p.kernel_height, p.kernel_width,
                                p.stride)]


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

class ActivationLayer(Layer):
    """relu/sigmoid/tanh/softplus (activation_layer-inl.hpp:12-41)."""

    fn = staticmethod(nn_ops.relu)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        return [in_shapes[0]]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return [self.fn(inputs[0])]


@register_layer
class ReluLayer(ActivationLayer):
    type_name = "relu"
    fn = staticmethod(nn_ops.relu)


@register_layer
class SigmoidLayer(ActivationLayer):
    type_name = "sigmoid"
    fn = staticmethod(nn_ops.sigmoid)


@register_layer
class TanhLayer(ActivationLayer):
    type_name = "tanh"
    fn = staticmethod(nn_ops.tanh)


@register_layer
class SoftplusLayer(ActivationLayer):
    type_name = "softplus"
    fn = staticmethod(nn_ops.softplus)


@register_layer
class GeluLayer(ActivationLayer):
    """gelu, tanh approximation (the JAX package's extension for the
    transformer family)."""
    type_name = "gelu"
    fn = staticmethod(nn_ops.gelu)


@register_layer
class XeluLayer(ActivationLayer):
    """xelu: x > 0 ? x : x / b, b default 5.0 (xelu_layer-inl.hpp:15-53)."""

    type_name = "xelu"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.b = 5.0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "b":
            self.b = float(val)

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return [nn_ops.xelu(inputs[0], self.b)]


@register_layer
class InsanityLayer(ActivationLayer):
    """insanity / RReLU (insanity_layer-inl.hpp:14-102).

    Training: xelu with a per-element divisor u * (ub - lb) + lb, u
    uniform in [0, 1) in the input's dtype; eval: the fixed divisor
    (lb + ub) / 2. The [lb, ub] range anneals toward its midpoint once
    per training forward, in the closed form of the JAX package
    (`_range`), from the update counter the trainer binds
    (base.active_step) - including the reference's freeze quirk: its
    counter only moves inside (calm_start, calm_end), so with
    calm_start >= 0 nothing ever anneals. The midpoint is
    anneal-invariant, so eval needs no step."""

    type_name = "insanity"
    uses_rng = True

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.lb = 5.0
        self.ub = 10.0
        self.saturation_start = 0
        self.saturation_end = 0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "lb":
            self.lb = float(val)
        if name == "ub":
            self.ub = float(val)
        if name == "calm_start":
            self.saturation_start = int(val)
        if name == "calm_end":
            self.saturation_end = int(val)

    def _range(self):
        """(lb, ub) at the bound training step: Python floats when
        nothing anneals, else float32 numbers (the JAX package's traced
        float32 arithmetic). Event t of the reference (shift by delta *
        counter, then counter++) comes before the mask of the same
        forward, so step t reflects m = min(t + 1, calm_end) events:
        a shift of delta * m (m - 1) / 2."""
        step = get_active_step()
        s0, e = self.saturation_start, self.saturation_end
        span = e - s0
        if step is None or s0 >= 0 or span <= 0 or e <= 0:
            return self.lb, self.ub
        delta = np.float32((self.ub - (self.ub + self.lb) / 2.0) / span)
        if isinstance(step, torch.Tensor):
            # the counter on the device (guarded microsteps): the same
            # float32 operations, in torch
            m = (step + 1).clamp(0, e).to(torch.float32)
            adj = float(delta) * m * (m - 1.0) / 2.0
            return (float(np.float32(self.lb)) + adj,
                    float(np.float32(self.ub)) - adj)
        m = np.float32(min(max(step + 1, 0), e))
        adj = delta * m * (m - np.float32(1.0)) / np.float32(2.0)
        return np.float32(self.lb) + adj, np.float32(self.ub) - adj

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        if not train:
            return [nn_ops.xelu(x, (self.lb + self.ub) / 2.0)]
        lb, ub = self._range()
        u = uniform_draw(x.shape, x.dtype, x.device, gen, keep,
                         self.type_name)
        if isinstance(lb, float):
            divisor = u * (ub - lb) + lb
        else:
            # float32 bounds in the compute dtype (they must not promote
            # a bfloat16 activation)
            lo = torch.as_tensor(lb, device=x.device).to(x.dtype)
            hi = torch.as_tensor(ub, device=x.device).to(x.dtype)
            divisor = u * (hi - lo) + lo
        return [nn_ops.xelu(x, divisor)]


@register_layer
class PReluLayer(Layer):
    """prelu (src/layer/prelu_layer-inl.hpp:48-173).

    A learnable slope per channel (per feature on matrix nodes), tagged
    `bias` as the reference visits it; `random_slope = 1` draws it
    uniform in [0, init_slope) at init. In training `random > 0`
    multiplies it by noise uniform in [1 - random, 1 + random] (one
    draw per element, in the input's dtype); the slope is clipped to
    [0, 1]. out = x > 0 ? x : x * slope."""

    type_name = "prelu"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.init_slope = 0.25
        self.init_random = 0
        self.random = 0.0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "init_slope":
            self.init_slope = float(val)
        if name == "random_slope":
            self.init_random = int(val)
        if name == "random":
            self.random = float(val)
            # draws only when the noise is on
            self.uses_rng = self.random > 0

    @staticmethod
    def _channels(shape: Shape) -> int:
        return shape[3] if shape[1] == 1 else shape[1]

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        return {"slope": (self._channels(in_shapes[0]),)}

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        (c,) = self.param_shapes(in_shapes)["slope"]
        if self.init_random == 0:
            return {"slope": torch.full((c,), self.init_slope)}
        return {"slope": self.init_slope * torch.rand((c,), generator=gen)}

    def param_tags(self) -> Dict[str, str]:
        return {"slope": "bias"}

    def model_shard_dims(self) -> Dict[str, int]:
        return {"slope": 0}

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        slope = params["slope"]
        u = None
        if train and self.random > 0:
            # the whole node's draw (a block takes its channels of it)
            u = uniform_draw(x.shape, x.dtype, x.device, gen, keep,
                             self.type_name)
        cdim = 1 if x.shape[1] != 1 else 3
        tmesh = tp.model_mesh()
        if tmesh is not None and slope.shape[0] != x.shape[cdim]:
            k = slope.shape[0]
            ul = (None if u is None
                  else u.narrow(cdim, tmesh.model_rank * k, k))
            return [tp.column(x, cdim, tmesh,
                              lambda xl: self._prelu(xl, slope, ul, cdim),
                              k=k)]
        return [self._prelu(x, slope, u, cdim)]

    def _prelu(self, x, slope, u, cdim: int):
        mask = (slope[None, :, None, None] if cdim == 1
                else slope[None, None, None, :]).expand(x.shape)
        if u is not None:
            mask = mask * (1 + (u * self.random * 2.0 - self.random))
        # minimum/maximum: a slope exactly at a bound takes half the
        # gradient, as under jnp.clip
        mask = torch.minimum(torch.maximum(mask, mask.new_zeros(())),
                             mask.new_ones(()))
        return nn_ops.mxelu(x, mask)


# ---------------------------------------------------------------------------
# normalization, dropout, structure
# ---------------------------------------------------------------------------

@register_layer
class LRNLayer(Layer):
    """lrn (src/layer/lrn_layer-inl.hpp:12-93): the hand-written kernel
    K1-fwd on the card (ops/lrn.py), the plain version on the CPU."""

    type_name = "lrn"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.local_size = 3
        self.alpha = 0.001
        self.beta = 0.75
        self.knorm = 1.0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "local_size":
            self.local_size = int(val)
        if name == "alpha":
            self.alpha = float(val)
        if name == "beta":
            self.beta = float(val)
        if name == "knorm":
            self.knorm = float(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        return [in_shapes[0]]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return [nn_ops.lrn(inputs[0], self.local_size, self.alpha,
                           self.beta, self.knorm)]


@register_layer
class BatchNormLayer(Layer):
    """batch_norm (src/layer/batch_norm_layer-inl.hpp:14-197).

    Per channel for conv nodes (statistics over b, h, w), per feature
    for matrix nodes (over b). Like the reference, it normalizes with
    the current MINIBATCH statistics at train and eval alike - there is
    no running mean. Statistics are float32 whatever the compute dtype,
    eps 1e-10, one cast back to the input's dtype at the end. On a data
    mesh each rank normalizes its own rows (per-shard statistics, the
    JAX package's default and the reference's per-GPU semantics);
    `global_stats = 1` is sync-BN: the sum and then the sum of squared
    deviations are all-reduced through a differentiable collective, so
    the statistics are the global batch's, computed in the JAX
    package's two-pass order. On one device `global_stats` changes
    nothing."""

    type_name = "batch_norm"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.init_slope = 1.0
        self.init_bias = 0.0
        self.eps = 1e-10
        self.global_stats = 0
        self._conv_node = None

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "init_slope":
            self.init_slope = float(val)
        if name == "init_bias":
            self.init_bias = float(val)
        if name == "eps":
            self.eps = float(val)
        if name == "global_stats":
            self.global_stats = int(val)

    def _is_conv(self, shape) -> bool:
        if self._conv_node is not None:
            return self._conv_node
        return shape[1] != 1

    def _axes(self, shape):
        """(statistics axes, parameter broadcast slices) for a node."""
        if self._is_conv(shape):
            return (0, 2, 3), (None, slice(None), None, None)
        return (0, 1, 2), (None, None, None, slice(None))

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        self._conv_node = in_shapes[0][1] != 1
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        s = in_shapes[0]
        c = s[3] if s[1] == 1 else s[1]
        return {"slope": (c,), "bias": (c,)}

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        (c,) = self.param_shapes(in_shapes)["slope"]
        return {"slope": torch.full((c,), self.init_slope),
                "bias": torch.full((c,), self.init_bias)}

    def param_tags(self) -> Dict[str, str]:
        return {"slope": "wmat", "bias": "bias"}

    def model_shard_dims(self) -> Dict[str, int]:
        return {"slope": 0, "bias": 0}

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        cdim = 1 if self._is_conv(x.shape) else 3
        tmesh = tp.model_mesh()
        if tmesh is not None and params["slope"].shape[0] != x.shape[cdim]:
            # channels are independent of the statistics: each rank
            # normalises its block (sync-BN still sums over the data
            # group only)
            return [tp.column(x, cdim, tmesh,
                              lambda xl: self._normalize(xl, params),
                              k=params["slope"].shape[0])]
        return [self._normalize(x, params)]

    def _normalize(self, x, params):
        axes, sl = self._axes(x.shape)
        xf = x.float()
        mesh = get_active_mesh()
        if self.global_stats and data_axis_size(mesh) > 1:
            from torch.distributed.nn.functional import all_reduce
            count = float(np.prod([x.shape[a] for a in axes])
                          * data_axis_size(mesh))
            mean = all_reduce(xf.sum(dim=axes, keepdim=True),
                              group=mesh.group or
                              torch.distributed.group.WORLD) / count
            var = all_reduce(((xf - mean) ** 2).sum(dim=axes, keepdim=True),
                             group=mesh.group or
                             torch.distributed.group.WORLD) / count
        else:
            mean = xf.mean(dim=axes, keepdim=True)
            var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
        xhat = (xf - mean) * torch.rsqrt(var + self.eps)
        out = xhat * params["slope"].float()[sl] + params["bias"].float()[sl]
        return out.to(x.dtype)


@register_layer
class DropoutLayer(Layer):
    """dropout (src/layer/dropout_layer-inl.hpp:12-66): inverted dropout,
    self-loop; the identity at inference. Training keeps an element where
    u < 1 - threshold, u uniform in [0, 1) from the layer's generator
    (or the injected `keep` mask), and scales the kept ones by
    1 / (1 - threshold) - common.py:868-875 of the JAX package."""

    type_name = "dropout"
    uses_rng = True

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.threshold = 0.0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "threshold":
            self.threshold = float(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        if not 0.0 <= self.threshold < 1.0:
            raise ValueError("DropoutLayer: invalid dropout threshold")
        return [in_shapes[0]]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        if not train or self.threshold == 0.0:
            return [x]
        pkeep = 1.0 - self.threshold
        if keep is None:
            u = rank_rand(x.shape, gen, device=x.device)
            keep = u < pkeep
        elif keep.shape != x.shape:
            raise ValueError(f"dropout: injected mask {tuple(keep.shape)} "
                             f"!= input {tuple(x.shape)}")
        return [x * (keep.to(x.dtype) / pkeep)]


@register_layer
class BiasLayer(Layer):
    """bias (src/layer/bias_layer-inl.hpp): self-loop additive bias on
    matrix nodes."""

    type_name = "bias"

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        if not is_mat(in_shapes[0]):
            raise ValueError("BiasLayer only works on flattened nodes")
        self.param.num_input_node = in_shapes[0][3]
        return [in_shapes[0]]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        return {"bias": (in_shapes[0][3],)}

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        return {"bias": torch.full((in_shapes[0][3],),
                                   self.param.init_bias)}

    def param_tags(self) -> Dict[str, str]:
        return {"bias": "bias"}

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return [inputs[0] + params["bias"][None, None, None, :]]


@register_layer
class FlattenLayer(Layer):
    """flatten (src/layer/flatten_layer-inl.hpp): (b,c,h,w)->(b,1,1,chw)."""

    type_name = "flatten"

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        b, c, h, w = in_shapes[0]
        return [(b, 1, 1, c * h * w)]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        return [x.reshape(x.shape[0], 1, 1, -1)]


@register_layer
class SplitLayer(Layer):
    """split (src/layer/split_layer-inl.hpp): 1 -> N copies; autograd sums
    the output gradients, the reference backward."""

    type_name = "split"
    num_out = 1  # set by Network from the connection arity

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        return [in_shapes[0]] * self.num_out

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return [inputs[0]] * self.num_out


class ConcatBase(Layer):
    """Join 2-4 inputs along `dim` (concat_layer-inl.hpp); the other
    dims must agree. Inputs of different dtypes promote as in
    jnp.concatenate."""

    dim = 3

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        if len(in_shapes) < 2:
            raise ValueError("Concat layer only supports n-1 connection")
        if len(in_shapes) > 4:
            raise ValueError("more than 4 input nodes is unsupported")
        out = list(in_shapes[0])
        total = 0
        for s in in_shapes:
            total += s[self.dim]
            for j in range(4):
                if j != self.dim and s[j] != out[j]:
                    raise ValueError("Concat shape doesn't match")
        out[self.dim] = total
        return [tuple(out)]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        return [torch.cat(inputs, dim=self.dim)]


@register_layer
class ConcatLayer(ConcatBase):
    """concat along the feature dim (concat_layer-inl.hpp, dim=3)."""
    type_name = "concat"
    dim = 3


@register_layer
class ChConcatLayer(ConcatBase):
    """ch_concat along the channel dim (concat_layer-inl.hpp, dim=1)."""
    type_name = "ch_concat"
    dim = 1


@register_layer
class AddLayer(Layer):
    """add: elementwise sum of N same-shape inputs (the residual
    connection of the sequence family); autograd hands the output
    gradient to every input."""

    type_name = "add"

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        if len(in_shapes) < 2:
            raise ValueError("add layer needs at least 2 inputs")
        for s in in_shapes[1:]:
            if tuple(s) != tuple(in_shapes[0]):
                raise ValueError(
                    f"add: input shapes differ: {in_shapes}")
        return [in_shapes[0]]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out]
