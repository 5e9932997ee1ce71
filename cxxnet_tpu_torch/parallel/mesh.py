"""Device-spec parsing and the data x model x seq mesh (counterpart of
cxxnet_tpu/parallel/mesh.py).

Config surface as in the JAX package: `dev = gpu:0-3`, `dev = cpu:0,2`,
`mesh = data:8`, `mesh = model:2`, `mesh = data:2,model:2`, `mesh =
seq:2`, `mesh = data:2,seq:2`. In PyTorch's idiom a mesh of N devices
is N processes with one device each. The ranks are laid out row-major
in the spec's axis order, as `np.asarray(devices).reshape(sizes)` lays
out the JAX package's mesh: under `data:N,model:M` rank = d * M + m,
under `data:D,seq:S` rank = d * S + s. Each axis has one process group
per line of the mesh along it - the data group of a rank holds the
ranks that differ from it in the data index only (they hold the same
model shard and sequence block and sum their batch statistics), the
model group the ranks of one replica and sequence block that split its
weights, the seq group the ranks of one replica and model shard that
split the sequence (ring and Ulysses attention, parallel/ring.py) - and
the gradient group holds every rank of one model shard (data x seq:
the ranks whose gradients add up to the replica's). Every rank creates
every group, in one order. `Mesh` carries the axis sizes, this
process's index on each axis and its groups (None = the default group
of torch.distributed, used where a group spans the whole job). A
one-process mesh has no group at all.

The data, model and seq axes are ported; `pipe` and `expert` above
size 1 raise NotImplementedError naming the axis. The JAX package's
pruning rule is carried over as it is: a single-controller job shrinks
the data axis to the largest size that divides the batch; a
multi-controller job refuses an indivisible batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
_PORTED_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
_OTHER_AXES = ("pipe", "expert")

_ACTIVE_MESH: List[Optional["Mesh"]] = [None]


@dataclass
class Mesh:
    """The mesh of one process: axis names and sizes, this process's
    index on the data axis (`rank`), the model axis (`model_rank`) and
    the seq axis (`seq_rank`), the process group of each (None =
    torch.distributed's default group), the job ranks of its seq group
    in seq order (`seq_peers`, the ring's neighbours) and the gradient
    group (data x seq)."""
    axes: Tuple[Tuple[str, int], ...]
    rank: int = 0
    group: object = None
    model_rank: int = 0
    model_group: object = None
    seq_rank: int = 0
    seq_group: object = None
    seq_peers: Tuple[int, ...] = ()
    grad_group: object = None

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


def seq_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(SEQ_AXIS, 1)


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
    """Refuse every axis but `data`, `model` and `seq` at a size above
    1."""
    for name, size in axes:
        if name not in _PORTED_AXES and size > 1:
            if name in _OTHER_AXES:
                raise NotImplementedError(
                    f"mesh = ...,{name}:{size}: the '{name}' axis is not "
                    "ported to cxxnet_tpu_torch yet (the data, model and "
                    "seq axes are; see ROADMAP)")
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


def rank_at(coords: Dict[str, int], order: Sequence[Tuple[str, int]]
            ) -> int:
    """The job rank at mesh coordinates `coords` ({axis: index}; an
    axis left out is at 0): row-major in `order`, the spec's axes with
    their sizes."""
    r = 0
    for name, size in order:
        r = r * size + coords.get(name, 0)
    return r


def coords_of(rank: int, order: Sequence[Tuple[str, int]]
              ) -> Dict[str, int]:
    """The inverse of rank_at."""
    out = {}
    for name, size in reversed(list(order)):
        out[name] = rank % size
        rank //= size
    return out


def _line_groups(order, world: int, rank: int, axes: Sequence[str]):
    """(group, members) of `rank`'s line over the axes `axes`: the ranks
    that differ from it in those axes' indices only, in row-major order
    of them. Every rank creates one group per line in one order
    (torch.distributed.new_group is collective); a line that spans the
    whole job is the default group (None), a line of one rank has no
    group."""
    import itertools

    import torch.distributed as dist
    sizes = dict(order)
    inner = [(a, sizes[a]) for a in axes]
    outer = [(a, n) for a, n in order if a not in axes]
    span = math.prod(n for _, n in inner)
    mine = coords_of(rank, order)
    members = [rank_at({**mine, **dict(zip(axes, idx))}, order)
               for idx in itertools.product(*(range(n) for _, n in inner))]
    if span == world or span == 1:
        return None, members
    group = None
    for idx in itertools.product(*(range(n) for _, n in outer)):
        at = dict(zip((a for a, _ in outer), idx))
        g = dist.new_group(sorted(
            rank_at({**at, **dict(zip(axes, j))}, order)
            for j in itertools.product(*(range(n) for _, n in inner))))
        if all(mine[a] == i for a, i in at.items()):
            group = g
    return group, members


def build_mesh(spec: MeshSpec, batch_size: int, world: int = 1,
               rank: int = 0, group=None) -> Mesh:
    """The mesh of a job of `world` processes, this one `rank`
    (data_axis sizes the data axis, `mesh` the model and seq axes). The
    mesh must equal the process group: one rank per device."""
    dsize = data_axis(spec, batch_size, world)
    msize = dict(spec.axes).get(MODEL_AXIS, 1)
    nseq = dict(spec.axes).get(SEQ_AXIS, 1)
    size = dsize * msize * nseq
    if size != world:
        if world == 1:
            raise ValueError(
                f"a mesh of {size} devices needs {size} processes, one "
                "per device: run the job with param_server = dist under "
                f"tools/launch_dist -n {size} (this process is alone)")
        dims = " x ".join(str(n) for n in
                          (dsize, msize) + ((nseq,) if nseq > 1 else ()))
        raise ValueError(
            f"the mesh ({dims} = {size}) must equal the job's "
            f"process count ({world}): one rank per device")
    if world == 1:
        return Mesh(((DATA_AXIS, 1),))
    sizes = {DATA_AXIS: dsize, MODEL_AXIS: msize, SEQ_AXIS: nseq}
    axes = ((DATA_AXIS, dsize),) + tuple(
        (a, sizes[a]) for a in (MODEL_AXIS, SEQ_AXIS) if sizes[a] > 1)
    if len(axes) == 1:
        return Mesh(axes, rank, group, grad_group=group)
    names = [a for a, _ in spec.axes if a in sizes]
    order = [(a, sizes[a]) for a in names] + [
        (a, sizes[a]) for a in _PORTED_AXES if a not in names]
    at = coords_of(rank, order)
    data_group, _ = _line_groups(order, world, rank, [DATA_AXIS])
    model_group, _ = _line_groups(order, world, rank, [MODEL_AXIS])
    seq_group, peers = _line_groups(order, world, rank, [SEQ_AXIS])
    grad_group, _ = _line_groups(order, world, rank, [DATA_AXIS, SEQ_AXIS])
    return Mesh(axes, at[DATA_AXIS], data_group, at[MODEL_AXIS],
                model_group, at[SEQ_AXIS], seq_group, tuple(peers),
                grad_group)
