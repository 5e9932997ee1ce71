"""Layer registry of the port: importing this package registers every
ported layer type (cxxnet_tpu/layers/__init__.py counterpart)."""

from cxxnet_tpu_torch.layers import (  # noqa: F401  (registers)
    attention, common, loss)
from cxxnet_tpu_torch.layers.base import (  # noqa: F401
    LAYER_REGISTRY, Layer, LayerParam, create_layer, known_layer_types,
    register_layer)
