"""Elementwise activations, softmax and the LRN dispatcher (counterpart
of cxxnet_tpu/ops/nn.py; reference src/layer/op.h:15-101 and
src/layer/lrn_layer-inl.hpp:12-93)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cxxnet_tpu_torch.ops import lrn as lrn_ops


def relu(x):
    """max(x, 0); like jnp.maximum, an input of exactly 0 takes half the
    gradient (torch.clamp_min would pass all of it, torch.relu none)."""
    return torch.maximum(x, x.new_zeros(()))


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softplus(x):
    return F.softplus(x)


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
    plain PyTorch versions."""
    if x.is_cuda:
        return lrn_ops.lrn(x.contiguous(), local_size, alpha, beta, knorm)
    return lrn_ops.lrn_cpu(x, local_size, alpha, beta, knorm)
