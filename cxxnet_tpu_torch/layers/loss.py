"""Loss layers (counterpart of cxxnet_tpu/layers/loss.py).

In the reference these are self-loop layers that transform activations
in the forward pass and overwrite them with gradients in the backward
pass (loss_layer_base-inl.hpp:31-104). Functionally each provides:

- forward_transform(x): what Predict/Evaluate see (softmax
  probabilities, sigmoid for multi_logistic, the identity for l2_loss);
- per_example_loss(x, label): a scalar per instance whose gradient with
  respect to the raw input x is the reference's hand-written gradient:
    softmax:        d/dx CE           = softmax(x) - onehot(label)
    l2_loss:        d/dx 0.5||x-y||^2 = x - y
    multi_logistic: d/dx BCEwithlogits = sigmoid(x) - y

The network sums grad_scale * masked per-example losses over the loss
layers and the trainer scales by 1/(batch_size*update_period)
(loss_layer_base-inl.hpp:60-63).
"""

from __future__ import annotations

from typing import List

import torch

from cxxnet_tpu_torch.layers.base import Layer, Shape, register_layer
from cxxnet_tpu_torch.ops import nn as nn_ops


class LossLayer(Layer):
    """Base loss layer (self-loop)."""

    is_loss = True

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.target = "label"
        self.grad_scale = 1.0

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "target":
            self.target = val
        if name == "grad_scale":
            self.grad_scale = float(val)

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        return [in_shapes[0]]

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        return [self.forward_transform(flat).reshape(x.shape)]

    def forward_transform(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def per_example_loss(self, x: torch.Tensor,
                         label: torch.Tensor) -> torch.Tensor:
        """x: (n, k) raw pre-transform activations; label: (n,
        label_width). Returns (n,) per-example losses."""
        raise NotImplementedError


@register_layer
class SoftmaxLayer(LossLayer):
    """softmax + cross entropy (loss/softmax_layer-inl.hpp:12-33)."""

    type_name = "softmax"

    def forward_transform(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.softmax(x)

    def per_example_loss(self, x, label):
        if label.shape[1] != 1:
            # reference assert (softmax expects one class-id column)
            raise ValueError(
                f"softmax: label width must be 1, got {label.shape[1]} "
                "(use label_vec to slice the class column)")
        lbl = label[:, 0].long()
        logz = torch.logsumexp(x, dim=-1)
        picked = torch.gather(x, 1, lbl[:, None])[:, 0]
        return logz - picked


@register_layer
class L2LossLayer(LossLayer):
    """l2_loss (loss/l2_loss_layer-inl.hpp): identity forward."""

    type_name = "l2_loss"

    def per_example_loss(self, x, label):
        if label.shape[1] != x.shape[1]:
            # reference assert (l2_loss: label width == pred width)
            raise ValueError(
                f"l2_loss: label width {label.shape[1]} != prediction "
                f"width {x.shape[1]} (set label_width / label_vec)")
        diff = x - label
        return 0.5 * torch.sum(diff * diff, dim=-1)


@register_layer
class MultiLogisticLayer(LossLayer):
    """multi_logistic (loss/multi_logistic_layer-inl.hpp): sigmoid
    forward."""

    type_name = "multi_logistic"

    def forward_transform(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.sigmoid(x)

    def per_example_loss(self, x, label):
        if label.shape[1] != x.shape[1]:
            # reference assert (multi_logistic: one target per output)
            raise ValueError(
                f"multi_logistic: label width {label.shape[1]} != "
                f"prediction width {x.shape[1]} (set label_width / "
                "label_vec)")
        # sum_j [softplus(x) - y*x]  (stable BCE-with-logits)
        return torch.sum(nn_ops.softplus(x) - label * x, dim=-1)
