"""Pooling on NCHW tensors (counterpart of cxxnet_tpu/ops/pooling.py).

Output-size parity: the reference uses a ceil-flavored formula
(pooling_layer-inl.hpp:103-106):

    out = min(in - k + stride - 1, in - 1) // stride + 1

so the last window may be truncated at the boundary. As in the JAX
package the input is padded explicitly - `pad` low, and whatever high
padding makes the window count come out to `out` - with a value neutral
for the reducer (-inf for max, 0 for sum/avg, in the input's dtype), and
then pooled with no implicit padding. torch's own `padding=` cannot be
used: it rejects pad > k/2, where the reference allows any pad < k.
Average pooling divides by the FULL window size ky*kx even for
truncated windows (mshadow pool<sum> scaled by 1/(ky*kx)).

Max-pool backward (`grad_mode`): the reference's unpool gives a
window's gradient to EVERY source position equal to the window max -
on ties, everywhere after relu, all of them get it. That is the default,
`ties`, computed as the JAX package does (`ops/pooling.py:116-186`): the
forward is separable (row max r, then column max of r) and the backward
two 1-D unpools, out -> r along H, then r -> x along W, each visiting
only the ceil(k/stride) windows that can cover a position (window o
covers p iff o = p//s - d with p%s + d*s < k). Plain torch ops, in a
`torch.autograd.Function`. `winner` is torch's native max_pool2d
backward (one winner per window, the cuDNN rule). Without autograd
(serving) both take the one 2-D max_pool2d forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cxxnet_tpu_torch.ops.routing import Routing

_NEG_INF = float("-inf")


def pool_out_dim(in_dim: int, ksize: int, stride: int, pad: int = 0) -> int:
    """The reference pooling output-size formula (pad is an extension over
    the reference, which has no pooling padding; pad=0 is exact parity)."""
    in_dim = in_dim + 2 * pad
    return min(in_dim - ksize + stride - 1, in_dim - 1) // stride + 1


def _pool_padding(in_dim: int, ksize: int, stride: int, pad: int) -> int:
    """High padding needed so the pool emits pool_out_dim outputs."""
    out = pool_out_dim(in_dim, ksize, stride, pad)
    return max(0, (out - 1) * stride + ksize - (in_dim + pad))


def pool2d(x: torch.Tensor, mode: str, ksize_y: int, ksize_x: int,
           stride: int, pad_y: int = 0, pad_x: int = 0,
           grad_mode: str = "ties") -> torch.Tensor:
    """Pool an NCHW tensor. mode in {'max', 'sum', 'avg'}; grad_mode
    ('ties' or 'winner') picks the max-pool backward rule."""
    if mode not in ("max", "sum", "avg"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    if grad_mode not in ("ties", "winner"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    if grad_mode == "winner" and mode != "max":
        raise ValueError("grad_mode='winner' only exists for max pooling")
    hi_y = _pool_padding(x.shape[2], ksize_y, stride, pad_y)
    hi_x = _pool_padding(x.shape[3], ksize_x, stride, pad_x)
    k = (ksize_y, ksize_x)
    if mode == "max":
        if (grad_mode == "ties" and torch.is_grad_enabled()
                and x.requires_grad):
            return _MaxPoolTies.apply(x, ksize_y, ksize_x, stride, pad_y,
                                      pad_x, hi_y, hi_x)
        if pad_y or pad_x or hi_y or hi_x:
            x = F.pad(x, (pad_x, hi_x, pad_y, hi_y), value=_NEG_INF)
        return F.max_pool2d(x, k, stride)
    if pad_y or pad_x or hi_y or hi_x:
        x = F.pad(x, (pad_x, hi_x, pad_y, hi_y), value=0.0)
    out = F.avg_pool2d(x, k, stride, divisor_override=1)  # window sums
    if mode == "avg":
        out = out * (1.0 / (ksize_y * ksize_x))
    return out


def _cover_lookup(a: torch.Tensor, s: int, d: int, length: int, axis: int,
                  fill: float) -> torch.Tensor:
    """Tensor whose index p along `axis` holds a[p//s - d] (`fill` where
    that index is outside a): a repeat(s) shifted by d*s, cropped or
    padded to `length` (F.pad crops on a negative width)."""
    r = a.repeat_interleave(s, dim=axis) if s > 1 else a
    lo, hi = d * s, length - r.shape[axis] - d * s
    pads = (lo, hi) if axis == 3 else (0, 0, lo, hi)
    return F.pad(r, pads, value=fill)


def _unpool_1d(vals: torch.Tensor, pooled: torch.Tensor, g: torch.Tensor,
               k: int, s: int, axis: int, route=None) -> torch.Tensor:
    """One-axis ties unpool: gin[p] = sum over windows o covering p of
    g[o] * (vals[p] == pooled[o]); `vals` is neutrally padded along
    `axis`. ceil(k/s) passes, one per candidate window offset d.
    `route` = (Routing, key) records or replays the covered positions'
    tie decisions (ops/routing.py)."""
    length = vals.shape[axis]
    shape = [1, 1, 1, 1]
    shape[axis] = length
    phase = (torch.arange(length, device=vals.device) % s).reshape(shape)
    gin = torch.zeros(vals.shape, dtype=g.dtype, device=g.device)
    for d in range(-(-k // s)):
        m = _cover_lookup(pooled, s, d, length, axis, _NEG_INF)
        gd = _cover_lookup(g, s, d, length, axis, 0.0)
        covers = phase + d * s < k
        hit = covers & (vals == m)
        if route is not None:
            hit = route[0].decide(route[1] + (d,), hit)
        gin = gin + torch.where(hit, gd, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))
    return gin


class _MaxPoolTies(torch.autograd.Function):
    """Max pooling with the reference's tie-duplicating backward; the
    padding widths come precomputed from pool2d."""

    @staticmethod
    def forward(ctx, x, ky, kx, stride, pad_y, pad_x, hi_y, hi_x):
        # separable forward: the same values as the 2-D max (max is
        # associative), and the row max r is what the backward needs
        xp = F.pad(x, (pad_x, hi_x, 0, 0), value=_NEG_INF)
        r = F.max_pool2d(xp, (1, kx), (1, stride))
        rp = F.pad(r, (0, 0, pad_y, hi_y), value=_NEG_INF)
        out = F.max_pool2d(rp, (ky, 1), (stride, 1))
        ctx.save_for_backward(x, r, out)
        ctx.geom = (ky, kx, stride, pad_y, pad_x, hi_y, hi_x)
        routing = Routing.active
        ctx.route = ((routing, routing.next_key("max-pool")) if routing
                     else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, r, out = ctx.saved_tensors
        ky, kx, stride, pad_y, pad_x, hi_y, hi_x = ctx.geom
        # the range names this backward in a profiler trace
        with torch.profiler.record_function("max_pool_ties_backward"):
            # step 1: g through the column max, out -> r (padded rows
            # exist only inside the unpool)
            rp = F.pad(r, (0, 0, pad_y, hi_y), value=_NEG_INF)
            route = ctx.route
            gr = _unpool_1d(rp, out, g, ky, stride, axis=2,
                            route=route and (route[0], route[1] + (2,)))
            gr = gr[:, :, pad_y:pad_y + x.shape[2]]
            # step 2: gr through the row max, r -> x
            xp = F.pad(x, (pad_x, hi_x, 0, 0), value=_NEG_INF)
            gin = _unpool_1d(xp, r, gr, kx, stride, axis=3,
                             route=route and (route[0], route[1] + (3,)))
            gin = gin[:, :, :, pad_x:pad_x + x.shape[3]]
        return (gin.to(x.dtype),) + (None,) * 7


def insanity_pool2d(x: torch.Tensor, flag: torch.Tensor, ksize_y: int,
                    ksize_x: int, stride: int, p_keep: float) -> torch.Tensor:
    """Stochastic displaced max pooling (insanity_max_pooling; JAX
    package `ops/pooling.py:189-231`, reference
    insanity_pooling_layer-inl.hpp:13-101).

    `flag` holds one uniform draw in [0, 1) per source pixel (float32,
    x's shape). With probability p_keep a pixel is read in place,
    otherwise from the neighbour one pixel up / down / left / right
    (each (1 - p_keep) / 4, clamped at the border); max pooling then
    runs over the displaced reads. The backward credits the window SLOT
    whose displaced read won (ties duplicated), not the displaced source
    pixel: the displacement is straight-through (jittered.detach() +
    (x - x.detach()), whose value is exactly the jittered view, which
    the unpool's exact tie comparisons need), so the ties unpool lands
    the gradient at slot positions."""
    b, c, h, w = x.shape
    delta = (1.0 - p_keep) / 4.0
    zero = torch.zeros((), dtype=torch.long, device=x.device)
    one = torch.ones((), dtype=torch.long, device=x.device)
    yd = torch.where((flag >= p_keep) & (flag < p_keep + delta), -one,
                     torch.where((flag >= p_keep + delta)
                                 & (flag < p_keep + 2 * delta), one, zero))
    xd = torch.where((flag >= p_keep + 2 * delta)
                     & (flag < p_keep + 3 * delta), -one,
                     torch.where(flag >= p_keep + 3 * delta, one, zero))
    ys = torch.arange(h, device=x.device).reshape(1, 1, h, 1)
    xs = torch.arange(w, device=x.device).reshape(1, 1, 1, w)
    y_src = (ys + yd).clamp(0, h - 1)
    x_src = (xs + xd).clamp(0, w - 1)
    idx = (y_src * w + x_src).reshape(b, c, h * w)
    jittered = torch.gather(x.detach().reshape(b, c, h * w), 2,
                            idx).reshape(b, c, h, w)
    jittered = jittered + (x - x.detach())
    return pool2d(jittered, "max", ksize_y, ksize_x, stride)
