"""Parallelism: the data axis on torch.distributed (counterpart of
cxxnet_tpu/parallel/).

The reference's multi-device story (one model replica per GPU,
gradients synced through a parameter server) maps to N processes with
one device each in one process group: each rank feeds its rows of the
global batch, the summed gradient rides an all-reduce, and
`update_on_server = 1` cuts the updater state over the ranks (ZeRO-1).
Only the data axis is ported; the model, seq, pipe and expert axes and
the elastic coordinator raise NotImplementedError naming themselves.
"""

from cxxnet_tpu_torch.parallel.mesh import (
    Mesh, MeshSpec, build_mesh, parse_device_spec, parse_mesh_spec)

__all__ = ["Mesh", "MeshSpec", "build_mesh", "parse_device_spec",
           "parse_mesh_spec"]
