"""Layer registry of the port: importing this package registers every
layer type (cxxnet_tpu/layers/__init__.py counterpart, with the JAX
package's `torch` plugin type registered here too)."""

from cxxnet_tpu_torch.layers import (  # noqa: F401  (registers)
    attention, common, loss, moe, pairtest, torch_module, transformer_stack)
from cxxnet_tpu_torch.layers.base import (  # noqa: F401
    LAYER_REGISTRY, Layer, LayerParam, create_layer, known_layer_types,
    register_layer)
