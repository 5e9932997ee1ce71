"""The model and expert axes' collectives: tensor and expert
parallelism by hand (the JAX package lets GSPMD insert these from the
parameter placements of parallel/sharding.py).

Between layers every activation is whole and the same on the model
(expert) ranks of one data replica. A layer whose weight is cut over
'model' runs on its block and closes with one of three differentiable
collectives over the model group - Megatron's pair and the
row-parallel reduce (`column` wraps the pair around a column-parallel
layer's local op); moe's local experts close with `enter` and `reduce`
over the expert group (`axis = "expert"`):

- `enter(x)`: identity forward; all-reduce of the gradient backward.
  Where a replicated activation enters a cut weight, each rank's
  gradient covers only its block's share, and the sum is the whole.
- `gather(y, dim)`: all-gather of the blocks along the feature dim
  forward; this rank's block of the gradient backward (the layers
  after it run replicated, so the gradient is the same on every rank).
- `reduce(y)`: all-reduce forward (each rank's partial product of a
  row-parallel contraction); identity backward.

`shared_sum(x, mesh)` is the data axis's: the sum over the data group
of a statistic each rank takes of its own rows (moe's load-balance
counts), which every rank then uses alike, each rank's loss holding
its 1/n share of the term it feeds; its backward multiplies the
gradient by n - the sum over the ranks of their (equal) gradients, so
each rank's parameters get the whole term's gradient through its own
rows.

`calls` counts enter / gather / reduce forwards (the graph audit reads
it).
bfloat16 values cross as their bits (a gather) or in float32 (a sum).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, data_axis_size, get_active_mesh, model_axis_size)

calls = {"enter": 0, "gather": 0, "reduce": 0}


def model_mesh() -> Optional[Mesh]:
    """The active mesh when it has a model axis above 1, else None."""
    mesh = get_active_mesh()
    return mesh if model_axis_size(mesh) > 1 else None


def _sum_(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce in place (bfloat16 summed in float32)."""
    if t.dtype == torch.bfloat16:
        f = t.float()
        distributed.all_reduce_(f, group)
        return t.copy_(f)
    return distributed.all_reduce_(t, group)


def _gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    if t.dtype == torch.bfloat16:
        return [p.view(torch.bfloat16) for p in distributed.all_gather(
            t.contiguous().view(torch.float16), group)]
    return distributed.all_gather(t, group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.rank, ctx.k = dim, rank, x.shape[dim]
        return torch.cat(_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(),
                None, None, None)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SharedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return _sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


def enter(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS
          ) -> torch.Tensor:
    calls["enter"] += 1
    return _Enter.apply(x, mesh.group_of(axis))


def gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    calls["gather"] += 1
    return _Gather.apply(x, dim, mesh.model_group, mesh.model_rank)


def reduce(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS
           ) -> torch.Tensor:
    calls["reduce"] += 1
    return _Reduce.apply(x, mesh.group_of(axis))


def shared_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _SharedSum.apply(x, mesh.group, data_axis_size(mesh))


def column(x: torch.Tensor, dim: int, mesh: Mesh,
           fn: Callable[[torch.Tensor], torch.Tensor],
           k: Optional[int] = None) -> torch.Tensor:
    """A column-parallel layer's model region: `x` (whole, the same on
    the model ranks) enters, `fn` maps it to this rank's block of the
    output along `dim`, and the blocks are gathered whole. With `k`
    (a per-channel layer), `fn` gets this rank's k-wide block of `x`
    along `dim` instead of all of it."""
    x = enter(x, mesh)
    if k is not None:
        x = x.narrow(dim, mesh.model_rank * k, k)
    return gather(fn(x), dim, mesh)


def block(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of a dim of n (n divisible by the
    model axis)."""
    k = n // model_axis_size(mesh)
    return slice(mesh.model_rank * k, (mesh.model_rank + 1) * k)


def reset() -> None:
    for k in calls:
        calls[k] = 0
