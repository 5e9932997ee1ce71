"""Per-parameter placement on the mesh (counterpart of
cxxnet_tpu/parallel/sharding.py).

Placements are PartitionSpec-like tuples, one axis name or None per
dim (() = replicated), computed by the JAX package's rules:

- the model, expert and pipe axes: each layer declares which dim of
  each param rides each of them (`Layer.model_shard_dims()`: fullc /
  conv / seq_fullc / attention's qkv rows on dim 0, attention's `wproj`
  on dim 1, prelu's and batch_norm's per-channel params on dim 0;
  `expert_shard_dims()`: moe's w1 / w2 / b1 / b2 on dim 0, its gate
  replicated; `pipe_shard_dims()`: every stacked param of a
  transformer_stack on dim 0). Model is asked first, then expert, then
  pipe, and the first axis to claim a dim keeps it. A param falls back
  to replication on an axis that is absent, has size 1, or does not
  divide the dim (`shardings_for`). A rank stores its contiguous block
  of each cut dim (`ParamCut`); the layers run on their blocks and
  close with the collectives of parallel/tensor.py (model, expert) or
  the stage hops of layers/transformer_stack.py (pipe).
- the ZeRO cut over the data axis: one tree (`zero_partition_dims`)
  drives all three stages, so updater state (stage 1), gradients and
  the update_period accumulator (stage 2) and the weights between steps
  (stage 3) always agree. Each weight is cut on the first dim its
  model placement left alone that the data axis divides; a weight with
  no such dim keeps its parameter placement, and every rank updates
  all of it (`ZeroCut`). Stage >= 2 reduce-scatters the cut gradients
  onto the cut (never an all-reduce and a slice); stage 3 all-gathers
  the weights just before the forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh)

# the axes a layer places params on, in the order they claim a dim
SHARD_AXES = (MODEL_AXIS, EXPERT_AXIS, PIPE_AXIS)

Shapes = Dict[str, Dict[str, Tuple[int, ...]]]
Key = Tuple[str, str]


def _spec(spec) -> tuple:
    """A placement with trailing Nones dropped, () when replicated."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def param_pspecs(shapes: Shapes, net=None) -> Dict[str, Dict[str, tuple]]:
    """The declared placement of every param: each of the model, expert
    and pipe axes on the dim its layer's `model_shard_dims`,
    `expert_shard_dims`, `pipe_shard_dims` names, unless an axis asked
    before it claimed that dim; else () - replicated. Without a net (or
    on a layer declaring nothing) every param is replicated."""
    dims_of: Dict[str, Tuple[Tuple[str, Dict[str, int]], ...]] = {}
    if net is not None:
        from cxxnet_tpu_torch.nnet.network import param_key
        for idx, info in enumerate(net.cfg.layers):
            if not info.is_shared:
                lay = net.layer_objs[idx]
                dims_of[param_key(net.cfg, idx)] = (
                    (MODEL_AXIS, lay.model_shard_dims()),
                    (EXPERT_AXIS, lay.expert_shard_dims()),
                    (PIPE_AXIS, lay.pipe_shard_dims()))
    out: Dict[str, Dict[str, tuple]] = {}
    for lk, d in shapes.items():
        out[lk] = {}
        for pn, shape in d.items():
            spec = [None] * len(shape)
            for axis, dims in dims_of.get(lk, ()):
                i = dims.get(pn)
                if i is not None and spec[i] is None:
                    spec[i] = axis
            out[lk][pn] = _spec(spec)
    return out


def shardings_for(mesh: Mesh, shapes: Shapes,
                  net=None) -> Dict[str, Dict[str, tuple]]:
    """The placement each param really takes on `mesh`: the declared
    axis dropped back to replication where it is absent from the mesh,
    has size 1, or does not divide the dim (the JAX package's rule)."""
    sizes = mesh.shape
    out: Dict[str, Dict[str, tuple]] = {}
    for lk, d in param_pspecs(shapes, net).items():
        out[lk] = {}
        for pn, spec in d.items():
            kept = []
            for i, ax in enumerate(spec):
                n = sizes.get(ax, 1) if ax is not None else 1
                ok = (ax is not None and n > 1
                      and shapes[lk][pn][i] % n == 0)
                kept.append(ax if ok else None)
            out[lk][pn] = _spec(kept)
    return out


def zero1_eligible_dim(spec, shape, dsize) -> Optional[int]:
    """Index of the first still-unsharded dim divisible by the data-axis
    size - the dim every ZeRO stage cuts over 'data' - or None when the
    weight keeps its parameter placement. The JAX package's rule."""
    full = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(full, shape)):
        if ax is None and dim % dsize == 0:
            return i
    return None


def zero_partition_dims(mesh: Mesh, shapes: Shapes,
                        pspecs=None) -> Dict[str, Dict[str, Optional[int]]]:
    """zero1_eligible_dim per parameter over its placement `pspecs`
    (shardings_for's; replicated when not given): the dim each ZeRO
    stage cuts over 'data' (None = ineligible, or no data axis to cut
    over)."""
    dsize = mesh.shape.get(DATA_AXIS, 1)
    if pspecs is None:
        pspecs = param_pspecs(shapes)
    out: Dict[str, Dict[str, Optional[int]]] = {}
    for lk, d in shapes.items():
        out[lk] = {}
        for pn, shape in d.items():
            out[lk][pn] = (None if dsize <= 1 else zero1_eligible_dim(
                pspecs[lk][pn], shape, dsize))
    return out


def zero_shardings(mesh: Mesh, shapes: Shapes, pspecs=None,
                   dims=None) -> Dict[str, Dict[str, tuple]]:
    """The placement of the ZeRO-cut tensors (stage 1's updater state,
    stage 2's gradients and accumulator, stage 3's weights between
    steps - one tree, the JAX package's zero1/2/3_shardings): the
    parameter placement with the eligible dim additionally on 'data'."""
    if pspecs is None:
        pspecs = param_pspecs(shapes)
    if dims is None:
        dims = zero_partition_dims(mesh, shapes, pspecs)
    out: Dict[str, Dict[str, tuple]] = {}
    for lk, d in pspecs.items():
        out[lk] = {}
        for pn, spec in d.items():
            i = dims[lk][pn]
            if i is None:
                out[lk][pn] = spec
                continue
            full = list(spec) + [None] * (len(shapes[lk][pn]) - len(spec))
            full[i] = DATA_AXIS
            out[lk][pn] = _spec(full)
    return out


def zero_region_specs(mesh: Mesh, shapes: Shapes, pspecs=None,
                      dims=None):
    """(scatter_specs, gather_specs) as the JAX package's: per weight,
    the placement naming only the 'data' dim of its zero cut (the
    reduce-scattered gradient; stage 3's weight between steps), and ()
    everywhere - the whole weight the all-gather restores."""
    if dims is None:
        dims = zero_partition_dims(mesh, shapes, pspecs)
    scatter: Dict[str, Dict[str, tuple]] = {}
    gather: Dict[str, Dict[str, tuple]] = {}
    for lk, d in dims.items():
        scatter[lk], gather[lk] = {}, {}
        for pn, i in d.items():
            gather[lk][pn] = ()
            spec = [None] * len(shapes[lk][pn])
            if i is not None:
                spec[i] = DATA_AXIS
            scatter[lk][pn] = _spec(spec)
    return scatter, gather


class ParamCut:
    """This rank's shard of every param placed on the model, expert or
    pipe axis: for each cut dim its axis and this rank's contiguous
    block of it (the rank's index on that axis). `local(t, lk, pn)`
    cuts a full tensor to its blocks (a copy); `gather(local)`
    all-gathers the blocks over each axis's group back into full
    tensors."""

    def __init__(self, mesh: Mesh, specs: Dict[str, Dict[str, tuple]],
                 shapes: Shapes):
        self.mesh = mesh
        self.sizes = {a: mesh.shape.get(a, 1) for a in SHARD_AXES}
        # (lk, pn) -> ((dim, axis), ...) of every cut param
        self.dims: Dict[Key, Tuple[Tuple[int, str], ...]] = {}
        for lk, d in specs.items():
            for pn, spec in d.items():
                cut = tuple((i, ax) for i, ax in enumerate(spec)
                            if ax in SHARD_AXES)
                if cut:
                    self.dims[(lk, pn)] = cut
        self.full_shapes = shapes

    def is_cut(self, lk: str, pn: str, axis: Optional[str] = None) -> bool:
        """Whether (lk, pn) is cut (over `axis`, when given)."""
        return any(axis in (None, ax) for _, ax in self.dims.get((lk, pn), ()))

    def local_shape(self, lk: str, pn: str) -> Tuple[int, ...]:
        shape = list(self.full_shapes[lk][pn])
        for i, ax in self.dims.get((lk, pn), ()):
            shape[i] //= self.sizes[ax]
        return tuple(shape)

    def local_shapes(self) -> Shapes:
        return {lk: {pn: self.local_shape(lk, pn) for pn in d}
                for lk, d in self.full_shapes.items()}

    def local(self, t: torch.Tensor, lk: str, pn: str) -> torch.Tensor:
        cut = self.dims.get((lk, pn))
        if cut is None:
            return t
        for i, ax in cut:
            k = t.shape[i] // self.sizes[ax]
            t = t.narrow(i, self.mesh.index(ax) * k, k)
        return t.contiguous()

    def local_tree(self, tree):
        return {lk: {pn: self.local(t, lk, pn) for pn, t in d.items()}
                for lk, d in tree.items()}

    def gather(self, tree):
        """Full tensors from this rank's blocks (one all-gather over each
        axis's group for every param cut over it); the rest as they
        are."""
        out = {lk: dict(d) for lk, d in tree.items()}
        for axis in SHARD_AXES:
            keys = [(lk, pn) for lk in sorted(out) for pn in sorted(out[lk])
                    if self.is_cut(lk, pn, axis)]
            if not keys:
                continue
            flat = torch.cat([out[lk][pn].reshape(-1) for lk, pn in keys])
            parts = distributed.all_gather(flat, self.mesh.group_of(axis))
            off = 0
            for lk, pn in keys:
                t = out[lk][pn]
                n = t.numel()
                i = next(i for i, ax in self.dims[(lk, pn)] if ax == axis)
                out[lk][pn] = torch.cat(
                    [p[off:off + n].view(t.shape) for p in parts], dim=i)
                off += n
        return out


class ZeroCut:
    """This rank's ZeRO cut over the data axis: for each cut weight its
    dim and slice (this rank's contiguous block of shape[dim] / N rows
    of that dim, on the rank's model-local tensor). `owned(t, lk, pn)`
    views this rank's slice; `gather(slices, into)` all-gathers the
    slices of every cut weight in one collective into full tensors;
    `reduce_scatter(grads)` sums every cut gradient over the data group
    and hands each rank only its slice, in one collective."""

    def __init__(self, mesh: Mesh, dims: Dict[str, Dict[str, Optional[int]]],
                 shapes: Shapes):
        self.mesh = mesh
        self.n = mesh.shape.get(DATA_AXIS, 1)
        self.rank = mesh.rank
        self.dims = dims
        self.shapes = shapes
        # (lk, pn, dim, slice length) of every cut weight, fixed order
        self.cut: List[Tuple[str, str, int, int]] = [
            (lk, pn, i, shapes[lk][pn][i] // self.n)
            for lk in sorted(dims) for pn in sorted(dims[lk])
            if (i := dims[lk][pn]) is not None]
        self._index = {(lk, pn): (i, k) for lk, pn, i, k in self.cut}

    def is_cut(self, lk: str, pn: str) -> bool:
        return (lk, pn) in self._index

    def cut_shape(self, lk: str, pn: str) -> Tuple[int, ...]:
        shape = list(self.shapes[lk][pn])
        hit = self._index.get((lk, pn))
        if hit is not None:
            shape[hit[0]] = hit[1]
        return tuple(shape)

    def owned(self, t: torch.Tensor, lk: str, pn: str) -> torch.Tensor:
        """This rank's slice of a full tensor of weight (lk, pn) (a
        view), or the tensor itself when the weight is not cut."""
        hit = self._index.get((lk, pn))
        if hit is None:
            return t
        i, k = hit
        return t.narrow(i, self.rank * k, k)

    def gather(self, slices: Dict[Key, torch.Tensor],
               into: Dict[Key, torch.Tensor]) -> None:
        """All-gather each cut weight's slices (this rank's in
        `slices`) into the full tensors `into`, in one collective."""
        keys = [(lk, pn) for lk, pn, _, _ in self.cut if (lk, pn) in into]
        if not keys:
            return
        flat = torch.cat([slices[key].reshape(-1) for key in keys])
        parts = distributed.all_gather(flat, self.mesh.group)
        for r, part in enumerate(parts):
            off = 0
            for key in keys:
                i, k = self._index[key]
                dst = into[key].narrow(i, r * k, k)
                n = dst.numel()
                dst.copy_(part[off:off + n].view(dst.shape))
                off += n

    def gather_full(self, slices: Dict[Key, torch.Tensor]
                    ) -> Dict[Key, torch.Tensor]:
        """New full tensors from the slices of every cut weight named in
        `slices` (stage 3's just-in-time all-gather)."""
        into = {}
        for key, t in slices.items():
            shape = list(t.shape)
            i, k = self._index[key]
            shape[i] = k * self.n
            into[key] = torch.empty(shape, dtype=t.dtype, device=t.device)
        self.gather(slices, into)
        return into

    def reduce_scatter(self, grads: Dict[Key, torch.Tensor]
                       ) -> Dict[Key, torch.Tensor]:
        """The summed gradient of every cut weight, this rank's slice
        only: each rank lays out its local gradients as N chunks (chunk
        r = every weight's slice r), one reduce-scatter over the data
        group sums them and leaves chunk `rank` here. `grads` names the
        cut weights to reduce."""
        cut = [c for c in self.cut if (c[0], c[1]) in grads]
        if not cut:
            return {}
        chunks = []
        for r in range(self.n):
            for lk, pn, i, k in cut:
                chunks.append(grads[(lk, pn)].narrow(i, r * k, k)
                              .reshape(-1))
        mine = distributed.reduce_scatter(torch.cat(chunks), self.mesh.group)
        out, off = {}, 0
        for lk, pn, i, k in cut:
            shape = self.cut_shape(lk, pn)
            n = 1
            for s in shape:
                n *= s
            out[(lk, pn)] = mine[off:off + n].view(shape)
            off += n
        return out
