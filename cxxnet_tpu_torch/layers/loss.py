"""Loss layers (counterpart of cxxnet_tpu/layers/loss.py).

In the reference these are self-loop layers that transform activations
in the forward pass and overwrite them with gradients in the backward
pass (loss_layer_base-inl.hpp:31-104). At inference only the forward
transform runs - what Predict sees: softmax probabilities, sigmoid for
multi_logistic, the identity for l2_loss. `target` and `grad_scale`
are parsed for the training slice.
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

    def forward(self, params, inputs):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        return [self.forward_transform(flat).reshape(x.shape)]

    def forward_transform(self, x: torch.Tensor) -> torch.Tensor:
        return x


@register_layer
class SoftmaxLayer(LossLayer):
    """softmax + cross entropy (loss/softmax_layer-inl.hpp:12-33)."""

    type_name = "softmax"

    def forward_transform(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.softmax(x)


@register_layer
class L2LossLayer(LossLayer):
    """l2_loss (loss/l2_loss_layer-inl.hpp): identity forward."""

    type_name = "l2_loss"


@register_layer
class MultiLogisticLayer(LossLayer):
    """multi_logistic (loss/multi_logistic_layer-inl.hpp): sigmoid
    forward."""

    type_name = "multi_logistic"

    def forward_transform(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.sigmoid(x)
