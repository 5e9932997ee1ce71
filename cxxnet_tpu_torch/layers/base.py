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
network hands it, unless the caller injects the draw itself (`keep`:
dropout's boolean mask, or the uniform tensor that insanity, prelu's
noise and insanity_max_pooling draw - the tests inject the JAX
package's draws). Inference (train=False) ignores both.

A layer with `has_aux` (moe) also returns an auxiliary loss term from
`forward_with_aux`, which the network adds into the training loss; a
layer whose behaviour follows training progress (insanity's anneal)
reads the update counter the trainer binds with `active_step`.

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


# Layer keys of the JAX package whose option the port does not
# implement yet: any value but the listed inert ones raises
# NotImplementedError naming the key (none left: fullc_gather is ported
# with the data axis).
_NOT_PORTED: Dict[str, Tuple[str, ...]] = {}


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
    # returns an auxiliary loss term from forward_with_aux (moe); the
    # network adds it into the training loss, which the trainer scales
    # by 1/(batch*update_period); `mask` (the (b,) row validity) must
    # keep padding rows out of the statistics the term uses
    has_aux: bool = False

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

    def model_shard_dims(self) -> Dict[str, int]:
        """{param name: the dim that rides the 'model' mesh axis}
        (parallel/sharding.py); {} - every param replicated."""
        return {}

    def expert_shard_dims(self) -> Dict[str, int]:
        """{param name: the dim that rides the 'expert' mesh axis} (moe's
        stacked expert weights); {} - none."""
        return {}

    def pipe_shard_dims(self) -> Dict[str, int]:
        """{param name: the dim that rides the 'pipe' mesh axis}
        (transformer_stack's stacked layer dim); {} - none."""
        return {}

    def seq_local(self) -> bool:
        """Whether the layer runs on a seq-sharded block of a sequence
        node (the 'seq' mesh axis, nnet/network.py): it computes each
        position from that position alone, or runs its own
        sequence-parallel route (ring / Ulysses attention). False - the
        default - makes the network gather its inputs along the sequence
        first, so the layer sees the whole of it."""
        return False

    # --- compute ---------------------------------------------------------
    def forward(self, params: Params, inputs: List[torch.Tensor],
                train: bool = False, gen: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        raise NotImplementedError

    def forward_with_aux(self, params: Params, inputs: List[torch.Tensor],
                         train: bool = False,
                         gen: Optional[torch.Generator] = None,
                         keep: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(outputs, float32 aux scalar) of a `has_aux` layer."""
        raise NotImplementedError

    def check_one_to_one(self, in_shapes: List[Shape]) -> None:
        if len(in_shapes) != 1:
            raise ValueError(
                f"{self.type_name}: layer only supports 1-1 connection")


def rank_rand(shape, gen: Optional[torch.Generator],
              dtype: torch.dtype = torch.float32,
              device=None) -> torch.Tensor:
    """A uniform [0, 1) draw of a batch-leading `shape` from `gen`. On a
    data mesh (parallel/mesh.py) `shape` is this rank's rows: the draw is
    the whole global batch's and this rank takes its rows of it, so each
    rank draws what a one-process run draws for those rows (every rank's
    generator is seeded alike; without the cut they would all draw one
    mask). In a layer on a seq-sharded block (seq_block_mesh) `shape`'s
    y dim is this rank's sequence block: the draw is the whole
    sequence's and the rank takes its block of it. A draw after the
    sequence is gathered is the same on every seq rank of a data
    index."""
    from cxxnet_tpu_torch.parallel.mesh import data_axis_size, get_active_mesh
    mesh = get_active_mesh()
    n = data_axis_size(mesh)
    sm = seq_block_mesh()
    ns = 1 if sm is None else sm.shape["seq"]
    if n <= 1 and ns <= 1:
        return torch.rand(tuple(shape), generator=gen, dtype=dtype,
                          device=device)
    b, r = shape[0], (mesh.rank if n > 1 else 0)
    if ns <= 1:
        full = torch.rand((b * n,) + tuple(shape[1:]), generator=gen,
                          dtype=dtype, device=device)
        return full[r * b:(r + 1) * b]
    s = shape[2]
    full = torch.rand((b * n, shape[1], s * ns) + tuple(shape[3:]),
                      generator=gen, dtype=dtype, device=device)
    q = sm.seq_rank
    return full[r * b:(r + 1) * b, :, q * s:(q + 1) * s]


def uniform_draw(shape, dtype: torch.dtype, device,
                 gen: Optional[torch.Generator],
                 inject: Optional[torch.Tensor], what: str) -> torch.Tensor:
    """A training layer's uniform [0, 1) draw: the injected tensor when
    the caller gives one (checked against `shape`, cast to `dtype`),
    else drawn from `gen` on `device` (rank_rand: this rank's rows of
    the global batch's draw)."""
    if inject is None:
        return rank_rand(shape, gen, dtype, device)
    if tuple(inject.shape) != tuple(shape):
        raise ValueError(f"{what}: injected draw {tuple(inject.shape)} "
                         f"!= {tuple(shape)}")
    return inject.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# ambient training-step binding
# ---------------------------------------------------------------------------

_ACTIVE_STEP: List[Optional[int]] = [None]


class active_step:
    """Context binding the update counter a training forward runs at
    (epoch * update_period + steps accumulated), so a layer whose
    behaviour follows training progress (insanity's anneal,
    insanity_layer-inl.hpp:52-63) reads it without a step argument
    through every forward - the JAX package's `active_step`. The
    trainer enters it around the training forward."""

    def __init__(self, step: Optional[int]):
        self.step = step

    def __enter__(self):
        _ACTIVE_STEP.append(self.step)
        return self.step

    def __exit__(self, *exc):
        _ACTIVE_STEP.pop()
        return False


def get_active_step() -> Optional[int]:
    return _ACTIVE_STEP[-1]


_SEQ_BLOCK: List[Optional[object]] = [None]


class seq_block:
    """Context binding the mesh whose 'seq' axis cuts the sequence of the
    layer running in it (None: the layer sees whole sequences). The
    network enters it around a layer whose inputs are seq-sharded, so
    pos_embed takes its block of the table, the attention layers run
    ring / Ulysses attention and rank_rand takes its block of a
    draw."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _SEQ_BLOCK.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _SEQ_BLOCK.pop()
        return False


def seq_block_mesh():
    """The mesh of the seq-sharded layer running now (seq_block), or
    None."""
    return _SEQ_BLOCK[-1]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

LAYER_REGISTRY: Dict[str, Type[Layer]] = {}

def register_layer(cls: Type[Layer]) -> Type[Layer]:
    assert cls.type_name, "layer class must define type_name"
    LAYER_REGISTRY[cls.type_name] = cls
    return cls


def create_layer(type_name: str, name: str = "") -> Layer:
    """Factory: config layer type string -> Layer instance
    (GetLayerType, layer.h:322-361). `pairtest-A-B` builds the
    differential-testing wrapper of master A and slave B
    (layer.h:354-358); an unknown type raises ValueError."""
    if type_name.startswith("pairtest-"):
        from cxxnet_tpu_torch.layers.pairtest import PairTestLayer
        parts = type_name.split("-", 2)
        if len(parts) != 3 or not parts[1] or not parts[2]:
            raise ValueError(
                f'unknown layer type: "{type_name}" '
                "(pairtest syntax is pairtest-<master>-<slave>)")
        return PairTestLayer(parts[1], parts[2], name)
    if type_name not in LAYER_REGISTRY:
        raise ValueError(f'unknown layer type: "{type_name}"')
    return LAYER_REGISTRY[type_name](name)


def known_layer_types() -> List[str]:
    return sorted(LAYER_REGISTRY)
