"""Layer system core: LayerParam, the Layer module, and the type registry.

Counterpart of cxxnet_tpu/layers/base.py. A Layer is an `nn.Module`
that holds its configuration and inferred shapes but not its weights:

    layer.infer_shapes(in_shapes)          shape inference (InitConnection)
    layer.init_params(gen, in_shapes)      weight init      (InitModel)
    layer(params, inputs, train, gen, keep) forward (Forward)

Weights live in the trainer as {param_key: {"wmat", "bias"}} (the JAX
package's pytree, same keys and layouts), so one layer's params serve
every connection that shares it, the float32 master copy and the
compute-dtype copy stay apart, and weights cross between the packages
unchanged (convert.py). Layers hold no gradient state: the backward is
autograd's, through the forward's torch ops (and the autograd Functions
of ops/lrn.py and ops/pooling.py).

`train` selects training semantics (dropout draws its mask); a layer
with `uses_rng` draws from `gen`, the per-layer torch.Generator the
network hands it, unless the caller injects the mask itself (`keep`, a
boolean tensor - the tests inject the JAX package's masks). Inference
(train=False) ignores both.

Shapes are full NCHW tuples (batch, channel, y, x); "matrix" nodes are
(batch, 1, 1, n) like the reference Node convention (layer.h:33-54).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Type

import torch
from torch import nn

from cxxnet_tpu_torch.utils.config import check_ported

Shape = Tuple[int, int, int, int]
Params = Dict[str, torch.Tensor]


def is_mat(shape: Sequence[int]) -> bool:
    """A node is a matrix when channel and y dims are 1 (layer.h:48-54)."""
    return shape[1] == 1 and shape[2] == 1


# Layer keys of the JAX package whose layer or option the port does not
# implement yet: any value but the listed inert ones raises
# NotImplementedError naming the key (the layer types themselves raise at
# creation). fullc_gather is the tensor-parallel fullc's gather; the rest
# belong to xelu (b), insanity (lb, ub, calm_start, calm_end), prelu
# (random, random_slope), insanity_max_pooling (keep), fixconn,
# transformer_stack, moe, pairtest and the torch plugin layer.
_NOT_PORTED: Dict[str, Tuple[str, ...]] = {
    "fullc_gather": ("0",),
    "b": (), "lb": (), "ub": (), "calm_start": (), "calm_end": (),
    "random": (), "random_slope": (), "keep": (), "fixconn_weight": (),
    "microbatch": (), "nlayer": (),
    "moe_aux": (), "moe_capacity": (), "moe_top_k": (), "nexpert": (),
    "pairtest_print": (), "pairtest_tol": (), "torch_module": (),
}


class LayerParam:
    """Common layer hyperparameters (src/layer/param.h:15-111)."""

    def __init__(self) -> None:
        self.init_sigma = 0.01
        self.init_uniform = -1.0
        self.init_sparse = 10
        self.init_bias = 0.0
        self.random_type = 0  # 0 gaussian, 1 uniform/xavier, 2 kaiming
        self.num_hidden = 0
        self.num_channel = 0
        self.num_group = 1
        self.kernel_width = 0
        self.kernel_height = 0
        self.stride = 1
        self.pad_x = 0
        self.pad_y = 0
        self.no_bias = 0
        self.silent = 0
        self.num_input_channel = 0
        self.num_input_node = 0
        self.layer_dtype = ""
        self.layer_quant = ""

    def set_param(self, name: str, val: str) -> None:
        if name == "init_sigma":
            self.init_sigma = float(val)
        if name == "init_uniform":
            self.init_uniform = float(val)
        if name == "init_bias":
            self.init_bias = float(val)
        if name == "init_sparse":
            self.init_sparse = int(val)
        if name == "random_type":
            if val == "gaussian":
                self.random_type = 0
            elif val in ("uniform", "xavier"):
                self.random_type = 1
            elif val == "kaiming":
                self.random_type = 2
            else:
                raise ValueError(f"invalid random_type {val}")
        if name == "nhidden":
            self.num_hidden = int(val)
        if name == "nchannel":
            self.num_channel = int(val)
        if name == "ngroup":
            self.num_group = int(val)
        if name == "kernel_size":
            self.kernel_width = self.kernel_height = int(val)
        if name == "kernel_height":
            self.kernel_height = int(val)
        if name == "kernel_width":
            self.kernel_width = int(val)
        if name == "stride":
            self.stride = int(val)
        if name == "pad":
            self.pad_y = self.pad_x = int(val)
        if name == "pad_y":
            self.pad_y = int(val)
        if name == "pad_x":
            self.pad_x = int(val)
        if name == "no_bias":
            self.no_bias = int(val)
        if name == "silent":
            self.silent = int(val)
        # per-layer pins read by the graph passes (nnet/passes.py):
        # autocast's compute dtype, quantize_int8's "float" exclusion
        if name == "layer_dtype":
            if val not in ("", "float32", "bfloat16"):
                raise ValueError(
                    f"layer_dtype must be float32 or bfloat16, "
                    f"got {val!r}")
            self.layer_dtype = val
        if name == "layer_quant":
            if val not in ("", "int8", "float"):
                raise ValueError(
                    f"layer_quant must be int8 or float, got {val!r}")
            self.layer_quant = val

    def rand_init_weight(self, gen: torch.Generator, shape: Sequence[int],
                         in_num: int, out_num: int) -> torch.Tensor:
        """Weight init parity with RandInitWeight (param.h:113-138), drawn
        on the CPU from `gen` (float32) so a seed gives the same weights
        on every device. torch's generator differs from JAX's threefry:
        the two packages agree in distribution, not in values."""
        shape = tuple(shape)
        if self.random_type == 0:
            return self.init_sigma * torch.randn(shape, generator=gen)
        if self.random_type == 1:
            a = math.sqrt(3.0 / (in_num + out_num))
            if self.init_uniform > 0:
                a = self.init_uniform
            return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * a
        if self.random_type == 2:
            if self.num_hidden > 0:
                sigma = math.sqrt(2.0 / self.num_hidden)
            else:
                sigma = math.sqrt(
                    2.0 / (self.num_channel * self.kernel_width
                           * self.kernel_height))
            return sigma * torch.randn(shape, generator=gen)
        raise ValueError(f"invalid random_type {self.random_type}")


class Layer(nn.Module):
    """Base layer: a stateless transform with optional params."""

    type_name: str = ""
    uses_rng: bool = False  # draws random numbers when training

    def __init__(self, name: str = ""):
        super().__init__()
        self.name = name
        self.param = LayerParam()

    # --- configuration ---------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        check_ported(_NOT_PORTED, name, val)
        self.param.set_param(name, val)

    # --- structure -------------------------------------------------------
    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        raise NotImplementedError

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        """{param name: shape} ({} when the layer has no params)."""
        return {}

    def init_params(self, gen: torch.Generator,
                    in_shapes: List[Shape]) -> Params:
        """Return the layer's params ({} when it has none), float32 on
        the CPU."""
        return {}

    def param_tags(self) -> Dict[str, str]:
        """Scoping tag per param, mirroring ApplyVisitor names (fullc:
        wmat->'wmat', bias->'bias'); get/set_weight resolve tags by it."""
        return {}

    # --- compute ---------------------------------------------------------
    def forward(self, params: Params, inputs: List[torch.Tensor],
                train: bool = False, gen: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        raise NotImplementedError

    def check_one_to_one(self, in_shapes: List[Shape]) -> None:
        if len(in_shapes) != 1:
            raise ValueError(
                f"{self.type_name}: layer only supports 1-1 connection")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

LAYER_REGISTRY: Dict[str, Type[Layer]] = {}

def register_layer(cls: Type[Layer]) -> Type[Layer]:
    assert cls.type_name, "layer class must define type_name"
    LAYER_REGISTRY[cls.type_name] = cls
    return cls


def create_layer(type_name: str, name: str = "") -> Layer:
    """Factory: config layer type string -> Layer instance. A type the
    JAX package knows but this port does not raises NotImplementedError
    (it must never be skipped silently)."""
    if type_name not in LAYER_REGISTRY:
        raise NotImplementedError(
            f'layer type "{type_name}" is not yet ported to '
            f"cxxnet_tpu_torch (ported: {', '.join(known_layer_types())};"
            " see ROADMAP)")
    return LAYER_REGISTRY[type_name](name)


def known_layer_types() -> List[str]:
    return sorted(LAYER_REGISTRY)
