"""Device-spec parsing and the data mesh (counterpart of
cxxnet_tpu/parallel/mesh.py).

Config surface as in the JAX package: `dev = gpu:0-3`, `dev = cpu:0,2`,
`mesh = data:8`. In PyTorch's idiom a data axis of size N is N
processes with one device each, and the axis is their process group:
`Mesh` carries the axis names and sizes, this process's rank on the
data axis and the group the collectives run over (None = the default
group of torch.distributed). A one-process mesh has no group at all.

Only the data axis is ported. An axis other than `data` with a size
above 1 (`model`, `seq`, `pipe`, `expert`) raises NotImplementedError
naming the axis. The JAX package's pruning rule is carried over as it
is: a single-controller job shrinks the data axis to the largest size
that divides the batch; a multi-controller job refuses an indivisible
batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DATA_AXIS = "data"
_OTHER_AXES = ("model", "seq", "pipe", "expert")

_ACTIVE_MESH: List[Optional["Mesh"]] = [None]


@dataclass
class Mesh:
    """The data mesh of one process: axis names and sizes, this
    process's index on the data axis, and the process group of that
    axis (None = torch.distributed's default group)."""
    axes: Tuple[Tuple[str, int], ...]
    rank: int = 0
    group: object = None

    @property
    def shape(self) -> dict:
        return dict(self.axes)


class active_mesh:
    """Context manager binding 'the mesh this forward runs over', so ops
    deep in the layer stack (sync-BN, fullc_gather, the LRN and
    attention routes) see the data axis without it being threaded
    through every Layer.forward signature. The trainer enters it around
    the training forward."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()
        return False


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH[-1]


def data_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(DATA_AXIS, 1)


def batch_shardable(mesh: Optional[Mesh], batch: int) -> bool:
    """The JAX package's eligibility rule for the per-shard op routes
    (LRN, attention, per-shard batch_norm): a real data axis whose size
    divides the GLOBAL batch. Each rank holds its local rows, so a
    caller passes their count times the axis size."""
    n = data_axis_size(mesh)
    return n > 1 and batch % n == 0


@dataclass
class MeshSpec:
    device_indices: Optional[List[int]] = None  # None = single device
    axes: List[Tuple[str, int]] = field(default_factory=list)


def parse_device_spec(val: str) -> Optional[List[int]]:
    """`cpu` / `gpu` -> None (single default device);
    `gpu:0-3` -> [0,1,2,3]; `gpu:0,2` -> [0,2]."""
    if ":" not in val:
        return None
    spec = val.split(":", 1)[1]
    if "-" in spec:
        a, b = spec.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(t) for t in spec.split(",")]


def parse_mesh_spec(val: str) -> List[Tuple[str, int]]:
    """`data:8` or `data:8,model:4` -> [(axis, size), ...]."""
    axes = []
    for part in val.split(","):
        name, size = part.split(":")
        axes.append((name.strip(), int(size)))
    return axes


def check_axes(axes) -> None:
    """Refuse every axis but `data` at a size above 1."""
    for name, size in axes:
        if name != DATA_AXIS and size > 1:
            if name in _OTHER_AXES:
                raise NotImplementedError(
                    f"mesh = ...,{name}:{size}: the '{name}' axis is not "
                    "ported to cxxnet_tpu_torch yet (only the data axis "
                    "is; see ROADMAP)")
            raise ValueError(f"unknown mesh axis {name!r}")


def data_axis(spec: MeshSpec, batch_size: int, world: int = 1) -> int:
    """The data axis's size for a job of `world` processes: `mesh =
    data:N`, else the device list's length, else (a multi-process job
    with neither) the whole job - the JAX package's multi-controller
    default. A single-process job prunes it to the largest size that
    divides batch_size (the JAX package's rule, mesh.py:142-152); a
    multi-process job refuses an indivisible batch."""
    check_axes(spec.axes)
    if spec.axes:
        size = dict(spec.axes).get(DATA_AXIS, 1)
    elif spec.device_indices is not None:
        size = len(spec.device_indices)
    else:
        size = world
    if world > 1:
        if batch_size % size != 0:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the "
                f"data axis ({size}) in multi-controller mode")
        return size
    while batch_size % size != 0:
        size -= 1
    return size


def build_mesh(spec: MeshSpec, batch_size: int, world: int = 1,
               rank: int = 0, group=None) -> Mesh:
    """The data mesh of a job of `world` processes, this one `rank`
    (data_axis sizes it). The axis must equal the process group: one
    rank per device."""
    size = data_axis(spec, batch_size, world)
    if size != world:
        if world == 1:
            raise ValueError(
                f"a data axis of {size} needs {size} processes, one per "
                "device: run the job with param_server = dist under "
                f"tools/launch_dist -n {size} (this process is alone)")
        raise ValueError(
            f"the data axis ({size}) must equal the job's process "
            f"count ({world}): one rank per device")
    if world == 1:
        return Mesh(((DATA_AXIS, 1),))
    return Mesh(((DATA_AXIS, size),), rank, group)
