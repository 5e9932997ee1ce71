"""Per-parameter placement on the data mesh (counterpart of the data-axis
part of cxxnet_tpu/parallel/sharding.py).

On a pure data mesh every parameter is replicated: each rank holds the
full weight, and the summed gradient reaches every rank through one
all-reduce. ZeRO-1 (`zero_stage = 1`, `shard_optimizer = 1`,
`update_on_server = 1` - the reference's server-side updater) cuts the
UPDATER STATE instead: each weight is cut on the dim the JAX package's
rule picks (the first dim the data axis divides), each rank keeps the
state of its own slice, updates only that slice, and an all-gather
returns the fresh weight to every rank. A weight with no such dim stays
replicated and every rank updates all of it. ZeRO stages 2-3 (cut
gradients, cut weights) are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

Shapes = Dict[str, Dict[str, Tuple[int, ...]]]


def param_pspecs(shapes: Shapes) -> Dict[str, Dict[str, tuple]]:
    """The placement of every param as a PartitionSpec-like tuple (one
    axis name or None per dim): () - replicated - on a data mesh, where
    no layer shards a weight."""
    return {lk: {pn: () for pn in d} for lk, d in shapes.items()}


def zero1_eligible_dim(spec, shape, dsize) -> Optional[int]:
    """Index of the first still-unsharded dim divisible by the data-axis
    size - the dim ZeRO-1 cuts over 'data' - or None when the weight
    keeps its parameter placement. The JAX package's rule."""
    full = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(full, shape)):
        if ax is None and dim % dsize == 0:
            return i
    return None


def zero_partition_dims(mesh: Mesh, shapes: Shapes,
                        pspecs=None) -> Dict[str, Dict[str, Optional[int]]]:
    """zero1_eligible_dim per parameter (None = ineligible, or no data
    axis to cut over)."""
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


class Zero1:
    """This rank's ZeRO-1 cut: for each cut weight its dim and slice
    (this rank's contiguous block of shape[dim] / N rows of that dim).
    `owned(t, lk, pn)` views this rank's slice of a full tensor;
    `gather(tensors)` all-gathers the slices of every cut weight in one
    collective and writes them into full tensors."""

    def __init__(self, mesh: Mesh, dims: Dict[str, Dict[str, Optional[int]]],
                 shapes: Shapes):
        self.mesh = mesh
        self.n = mesh.shape.get(DATA_AXIS, 1)
        self.rank = mesh.rank
        self.dims = dims
        # (lk, pn, dim, slice length) of every cut weight, fixed order
        self.cut: List[Tuple[str, str, int, int]] = [
            (lk, pn, i, shapes[lk][pn][i] // self.n)
            for lk in sorted(dims) for pn in sorted(dims[lk])
            if (i := dims[lk][pn]) is not None]
        self._index = {(lk, pn): (i, k) for lk, pn, i, k in self.cut}

    def is_cut(self, lk: str, pn: str) -> bool:
        return (lk, pn) in self._index

    def owned(self, t: torch.Tensor, lk: str, pn: str) -> torch.Tensor:
        """This rank's slice of a full tensor of weight (lk, pn) (a
        view), or the tensor itself when the weight is not cut."""
        hit = self._index.get((lk, pn))
        if hit is None:
            return t
        i, k = hit
        return t.narrow(i, self.rank * k, k)

    def gather(self, slices: Dict[Tuple[str, str], torch.Tensor],
               into: Dict[Tuple[str, str], torch.Tensor]) -> None:
        """All-gather each cut weight's slices (this rank's in
        `slices`) into the full tensors `into`, in one collective."""
        if not self.cut:
            return
        flat = torch.cat([slices[(lk, pn)].reshape(-1)
                          for lk, pn, _, _ in self.cut])
        parts = distributed.all_gather(flat, self.mesh.group)
        for r, part in enumerate(parts):
            off = 0
            for lk, pn, i, k in self.cut:
                full = into[(lk, pn)]
                dst = full.narrow(i, r * k, k)
                n = dst.numel()
                dst.copy_(part[off:off + n].view(dst.shape))
                off += n
