"""Device-spec parsing and the data x model mesh (counterpart of
cxxnet_tpu/parallel/mesh.py).

Config surface as in the JAX package: `dev = gpu:0-3`, `dev = cpu:0,2`,
`mesh = data:8`, `mesh = model:2`, `mesh = data:2,model:2`. In
PyTorch's idiom a mesh of N devices is N processes with one device
each. The ranks are laid out row-major in the spec's axis order, as
`np.asarray(devices).reshape(sizes)` lays out the JAX package's mesh:
under `data:N,model:M` rank = d * M + m. Each axis has its process
groups - one data group per model column (the ranks that hold the same
model shard and sum their gradients), one model group per data row
(the ranks of one replica that split its weights) - which every rank
creates, in the same order. `Mesh` carries the axis sizes, this
process's index on each axis and its two groups (None = the default
group of torch.distributed, used where one axis spans the whole job).
A one-process mesh has no group at all.

The data and model axes are ported; `seq`, `pipe` and `expert` above
size 1 raise NotImplementedError naming the axis. The JAX package's
pruning rule is carried over as it is: a single-controller job shrinks
the data axis to the largest size that divides the batch; a
multi-controller job refuses an indivisible batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"
_OTHER_AXES = ("seq", "pipe", "expert")

_ACTIVE_MESH: List[Optional["Mesh"]] = [None]


@dataclass
class Mesh:
    """The mesh of one process: axis names and sizes, this process's
    index on the data axis (`rank`) and on the model axis
    (`model_rank`), and the process group of each (None =
    torch.distributed's default group)."""
    axes: Tuple[Tuple[str, int], ...]
    rank: int = 0
    group: object = None
    model_rank: int = 0
    model_group: object = None

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


def model_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(MODEL_AXIS, 1)


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
    """Refuse every axis but `data` and `model` at a size above 1."""
    for name, size in axes:
        if name not in (DATA_AXIS, MODEL_AXIS) and size > 1:
            if name in _OTHER_AXES:
                raise NotImplementedError(
                    f"mesh = ...,{name}:{size}: the '{name}' axis is not "
                    "ported to cxxnet_tpu_torch yet (the data and model "
                    "axes are; see ROADMAP)")
            raise ValueError(f"unknown mesh axis {name!r}")


def data_axis(spec: MeshSpec, batch_size: int, world: int = 1) -> int:
    """The data axis's size for a job of `world` processes: `mesh =
    data:N`, else the device list's length, else (a multi-process job
    with neither) the whole job - the JAX package's multi-controller
    default. A single-process job prunes it to the largest size that
    divides batch_size (the JAX package's rule, mesh.py:142-152); a
    multi-process job refuses an indivisible batch. A mesh spec
    without a data axis has none to prune (size 1)."""
    check_axes(spec.axes)
    if spec.axes:
        size = dict(spec.axes).get(DATA_AXIS, 1)
        if DATA_AXIS not in dict(spec.axes):
            return 1
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


def rank_of(d: int, m: int, dsize: int, msize: int,
            model_first: bool = False) -> int:
    """The job rank at data index d, model index m: row-major in the
    spec's axis order (d * msize + m; m * dsize + d when the spec names
    the model axis first)."""
    return m * dsize + d if model_first else d * msize + m


def _axis_groups(dsize: int, msize: int, rank: int, model_first: bool):
    """(data index, model index, data group, model group) of `rank`.
    Every rank creates every group in the same order
    (torch.distributed.new_group is collective); an axis that spans the
    whole job uses the default group (None)."""
    import torch.distributed as dist
    at = {rank_of(d, m, dsize, msize, model_first): (d, m)
          for d in range(dsize) for m in range(msize)}
    di, mi = at[rank]
    data_group = model_group = None
    if msize > 1 and dsize > 1:
        for m in range(msize):
            g = dist.new_group([rank_of(d, m, dsize, msize, model_first)
                                for d in range(dsize)])
            if m == mi:
                data_group = g
        for d in range(dsize):
            g = dist.new_group([rank_of(d, m, dsize, msize, model_first)
                                for m in range(msize)])
            if d == di:
                model_group = g
    return di, mi, data_group, model_group


def build_mesh(spec: MeshSpec, batch_size: int, world: int = 1,
               rank: int = 0, group=None) -> Mesh:
    """The mesh of a job of `world` processes, this one `rank`
    (data_axis sizes the data axis, `mesh` the model axis). The mesh
    must equal the process group: one rank per device."""
    dsize = data_axis(spec, batch_size, world)
    msize = dict(spec.axes).get(MODEL_AXIS, 1)
    size = dsize * msize
    if size != world:
        if world == 1:
            raise ValueError(
                f"a mesh of {size} devices needs {size} processes, one "
                "per device: run the job with param_server = dist under "
                f"tools/launch_dist -n {size} (this process is alone)")
        raise ValueError(
            f"the mesh ({dsize} x {msize} = {size}) must equal the job's "
            f"process count ({world}): one rank per device")
    if world == 1:
        return Mesh(((DATA_AXIS, 1),))
    axes = ((DATA_AXIS, dsize),) + (((MODEL_AXIS, msize),)
                                    if msize > 1 else ())
    if msize == 1:
        return Mesh(axes, rank, group)
    names = [a for a, _ in spec.axes]
    model_first = (DATA_AXIS in names
                   and names.index(MODEL_AXIS) < names.index(DATA_AXIS))
    di, mi, data_group, model_group = _axis_groups(dsize, msize, rank,
                                                   model_first)
    return Mesh(axes, di, data_group, mi, model_group)
