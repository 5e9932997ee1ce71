"""Elementwise activations, softmax and the LRN dispatcher (counterpart
of cxxnet_tpu/ops/nn.py; reference src/layer/op.h:15-101 and
src/layer/lrn_layer-inl.hpp:12-93)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cxxnet_tpu_torch.ops import lrn as lrn_ops
from cxxnet_tpu_torch.ops.routing import Routing


def relu(x):
    """max(x, 0); like jnp.maximum, an input of exactly 0 takes half the
    gradient (torch.clamp_min would pass all of it, torch.relu none).
    Under an active Routing (ops/routing.py) a training step's gate is
    recorded or replayed."""
    if (Routing.active is not None and torch.is_grad_enabled()
            and x.requires_grad):
        return Routing.active.relu(x)
    return torch.maximum(x, x.new_zeros(()))


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softplus(x):
    return F.softplus(x)


def gelu(x):
    """gelu, tanh approximation, written as jax.nn.gelu(approximate=True)
    writes it, so that autograd's gradient takes the JAX package's
    rounding path (F.gelu's fused backward differs by a few ulp)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))
    return x * cdf


def xelu(x, b):
    """Leaky relu variant: x > 0 ? x : x / b (op.h:50-55); `b` a number
    or a tensor broadcast against x."""
    return torch.where(x > 0, x, x / b)


def mxelu(x, b):
    """Multiplicative leaky relu: x > 0 ? x : x * b
    (prelu_layer-inl.hpp:11-15)."""
    return torch.where(x > 0, x, x * b)


def softmax(x):
    """Row softmax over the last dim (mshadow::Softmax equivalent)."""
    return torch.softmax(x, dim=-1)


def lrn(x: torch.Tensor, local_size: int, alpha: float, beta: float,
        knorm: float) -> torch.Tensor:
    """Cross-channel local response normalization on NCHW.

    out = x * (knorm + alpha/n * sum_{window n}(x^2)) ^ (-beta)
    (lrn_layer-inl.hpp:36-56). A CUDA tensor goes to the hand-written
    kernels K1-fwd / K1-bwd (ops/lrn.py, which raises on anything it
    cannot take); a CPU tensor goes to the same autograd rule with the
    plain PyTorch versions. On a data mesh each rank calls this on its
    own rows: the port of the JAX package's sharded entry point
    (`lrn_pallas_sharded`, a shard_map with no collective)."""
    if x.is_cuda:
        return lrn_ops.lrn(x.contiguous(), local_size, alpha, beta, knorm)
    return lrn_ops.lrn_cpu(x, local_size, alpha, beta, knorm)
