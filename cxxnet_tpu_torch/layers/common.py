"""The non-loss layers of the port (counterpart of
cxxnet_tpu/layers/common.py): fullc, conv, max/sum/avg pooling, the
activations, lrn, batch_norm, dropout, bias, flatten, split and add.
Each class names the reference file it mirrors; the backward is
autograd's through the forward.

fullc and conv take the graph passes' stamps (`fused_act = relu`,
fullc's `flatten_input = 1`) and, when the quantize_int8 pass hands
them `wmat_q` (int8) with frozen `ascale` / `wscale` instead of `wmat`,
run the int8 route of ops/int8.py: quantize the input, an int8 x int8
-> int32 contraction (K3 on the card), then in float32 the dequantize,
the bias and the fused activation, and a cast back to the input's
dtype - the JAX package's order."""

from __future__ import annotations

from typing import Dict, List

import torch

from cxxnet_tpu_torch.layers.base import (
    Layer, Params, Shape, is_mat, register_layer)
from cxxnet_tpu_torch.ops import conv as conv_ops
from cxxnet_tpu_torch.ops import int8 as int8_ops
from cxxnet_tpu_torch.ops import nn as nn_ops
from cxxnet_tpu_torch.ops import pooling as pool_ops


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

@register_layer
class FullConnectLayer(Layer):
    """fullc (src/layer/fullc_layer-inl.hpp:14-146).

    out = in . W^T + bias; W shape (nhidden, num_input_node).
    `fullc_gather` only changes how the data-parallel weight gradient is
    reduced, so it is inert at inference.
    """

    type_name = "fullc"

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.fused_act = ""
        self.flatten_input = 0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
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

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        b = x.shape[0]
        m = x.reshape(b, -1)
        if "wmat_q" in params:
            acc = int8_ops.int8_matmul(
                int8_ops.quantize_act(m, params["ascale"]),
                params["wmat_q"])
            out = _int8_epilogue(acc, params, self.fused_act, m.dtype)
            return [out.reshape(b, 1, 1, -1)]
        out = m @ params["wmat"].t()
        if "bias" in params:
            out = out + params["bias"][None, :]
        if self.fused_act == "relu":
            out = nn_ops.relu(out)
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

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        p = self.param
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

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "pool_grad":
            if val not in ("ties", "winner"):
                raise ValueError(
                    f"pool_grad must be 'ties' or 'winner', got {val!r}")
            if val == "winner" and self.mode != "max":
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
    eps 1e-10, one cast back to the input's dtype at the end. The port
    runs on one device, where `global_stats` (the JAX package's
    sync-BN switch across data shards) changes nothing: accepted and
    inert."""

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

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        axes, sl = self._axes(x.shape)
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
        xhat = (xf - mean) * torch.rsqrt(var + self.eps)
        out = xhat * params["slope"].float()[sl] + params["bias"].float()[sl]
        return [out.to(x.dtype)]


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
            u = torch.rand(x.shape, generator=gen, device=x.device)
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
