"""Device-spec parsing and the data x model x seq x expert x pipe mesh
(counterpart of cxxnet_tpu/parallel/mesh.py).

Config surface as in the JAX package: `dev = gpu:0-3`, `dev = cpu:0,2`,
`mesh = data:8`, `mesh = model:2`, `mesh = data:2,model:2`, `mesh =
seq:2`, `mesh = data:2,seq:2`, `mesh = data:2,pipe:4`, `mesh =
data:2,seq:2,expert:2`. In PyTorch's idiom a mesh of N devices is N
processes with one device each. The ranks are laid out row-major in
the spec's axis order, as `np.asarray(devices).reshape(sizes)` lays out
the JAX package's mesh: under `data:N,model:M` rank = d * M + m, under
`data:D,pipe:P` rank = d * P + p. Each axis has one process group per
line of the mesh along it - the data group of a rank holds the ranks
that differ from it in the data index only (they hold the same shards
and sequence block and sum their batch statistics), the model group the
ranks of one replica and sequence block that split its weights, the seq
group the ranks that split the sequence (ring and Ulysses attention,
parallel/ring.py), the expert group the ranks that split the experts of
a moe layer, the pipe group the stages of a pipelined
transformer_stack, in stage order (`pipe_peers`) - and the gradient
group holds the ranks of one model / expert / pipe index (data x seq:
the ranks whose gradients add up to the replica's). Every rank creates
every group, in one order. `Mesh` carries the axis sizes, this
process's index on each axis and its groups (None = the default group
of torch.distributed, used where a group spans the whole job). A
one-process mesh has no group at all. A mesh without a data axis
replicates the batch: every rank feeds all of its rows.

The JAX package's pruning rule is carried over as it is: a
single-controller job shrinks the data axis to the largest size that
divides the batch; a multi-controller job refuses an indivisible batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS, PIPE_AXIS)

_ACTIVE_MESH: List[Optional["Mesh"]] = [None]


@dataclass
class Mesh:
    """The mesh of one process: axis names and sizes, this process's
    index on the data axis (`rank`), the model, seq, expert and pipe
    axes (`model_rank`, ...), the process group of each (None =
    torch.distributed's default group), the job ranks of its seq group
    in seq order (`seq_peers`, the ring's neighbours) and of its pipe
    group in stage order (`pipe_peers`), and the gradient group (data x
    seq)."""
    axes: Tuple[Tuple[str, int], ...]
    rank: int = 0
    group: object = None
    model_rank: int = 0
    model_group: object = None
    seq_rank: int = 0
    seq_group: object = None
    seq_peers: Tuple[int, ...] = ()
    grad_group: object = None
    expert_rank: int = 0
    expert_group: object = None
    pipe_rank: int = 0
    pipe_group: object = None
    pipe_peers: Tuple[int, ...] = ()

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    def index(self, axis: str) -> int:
        """This process's index on `axis`."""
        return self.rank if axis == DATA_AXIS else getattr(
            self, f"{axis}_rank")

    def group_of(self, axis: str):
        """The process group of this process's line along `axis`."""
        return self.group if axis == DATA_AXIS else getattr(
            self, f"{axis}_group")


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


def pipe_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(PIPE_AXIS, 1)


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


def check_device_list(spec: str) -> Optional[List[int]]:
    """The device list a `dev` spec names (None without one), refusing
    a card this machine lacks with the JAX mesh's text (CPU lists name
    no card and always pass)."""
    ids = parse_device_spec(spec) if spec else None
    if not ids or len(ids) < 2:
        return None
    if not spec.strip().lower().startswith("cpu"):
        import torch
        have = torch.cuda.device_count()
        if max(ids) >= have:
            raise ValueError(
                f"device spec requests index {max(ids)} but only "
                f"{have} devices are available")
    return ids


def parse_mesh_spec(val: str) -> List[Tuple[str, int]]:
    """`data:8` or `data:8,model:4` -> [(axis, size), ...]."""
    axes = []
    for part in val.split(","):
        name, size = part.split(":")
        axes.append((name.strip(), int(size)))
    return axes


def check_axes(axes) -> None:
    """Refuse an axis that is not one of the mesh's five."""
    for name, size in axes:
        if name not in AXES and size > 1:
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
    (data_axis sizes the data axis, `mesh` the others). The mesh must
    equal the process group: one rank per device."""
    dsize = data_axis(spec, batch_size, world)
    given = dict(spec.axes)
    sizes = {a: (dsize if a == DATA_AXIS else given.get(a, 1))
             for a in AXES}
    size = math.prod(sizes.values())
    if size != world:
        if world == 1:
            raise ValueError(
                f"a mesh of {size} devices needs {size} processes, one "
                "per device: run the job with param_server = dist under "
                f"tools/launch_dist -n {size} (this process is alone)")
        dims = " x ".join(str(sizes[a]) for a in AXES
                          if a in (DATA_AXIS, MODEL_AXIS) or sizes[a] > 1)
        raise ValueError(
            f"the mesh ({dims} = {size}) must equal the job's "
            f"process count ({world}): one rank per device")
    if world == 1:
        return Mesh(((DATA_AXIS, 1),))
    axes = ((DATA_AXIS, dsize),) + tuple(
        (a, sizes[a]) for a in AXES[1:] if sizes[a] > 1)
    if len(axes) == 1:
        return Mesh(axes, rank, group, grad_group=group)
    names = [a for a, _ in spec.axes if a in sizes]
    order = [(a, sizes[a]) for a in names] + [
        (a, sizes[a]) for a in AXES if a not in names]
    at = coords_of(rank, order)
    lines = {a: _line_groups(order, world, rank, [a]) for a in AXES}
    grad_group, _ = _line_groups(order, world, rank, [DATA_AXIS, SEQ_AXIS])
    return Mesh(axes, at[DATA_AXIS], lines[DATA_AXIS][0], at[MODEL_AXIS],
                lines[MODEL_AXIS][0], at[SEQ_AXIS], lines[SEQ_AXIS][0],
                tuple(lines[SEQ_AXIS][1]), grad_group, at[EXPERT_AXIS],
                lines[EXPERT_AXIS][0], at[PIPE_AXIS], lines[PIPE_AXIS][0],
                tuple(lines[PIPE_AXIS][1]))
