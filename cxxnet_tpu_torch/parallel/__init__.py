"""Parallelism: the data, model and seq axes on torch.distributed
(counterpart of cxxnet_tpu/parallel/).

The reference's multi-device story (one model replica per GPU,
gradients synced through a parameter server) maps to N processes with
one device each in one process group: each rank feeds its rows of the
global batch and the summed gradient rides an all-reduce; `zero_stage
= 1|2|3` (`update_on_server = 1` is stage 1) cuts the updater state,
then the gradients, then the weights over the data axis (sharding.py).
The model axis splits each replica's weights over its ranks (Megatron
column / row parallelism, tensor.py); the seq axis splits each
sequence over its ranks (ring and Ulysses attention, ring.py). The
pipe and expert axes and the elastic coordinator raise
NotImplementedError naming themselves.
"""

from cxxnet_tpu_torch.parallel.mesh import (
    Mesh, MeshSpec, build_mesh, parse_device_spec, parse_mesh_spec)

__all__ = ["Mesh", "MeshSpec", "build_mesh", "parse_device_spec",
           "parse_mesh_spec"]
