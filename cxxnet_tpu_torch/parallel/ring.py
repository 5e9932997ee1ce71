"""Sequence parallelism: ring attention and Ulysses all-to-all over the
'seq' mesh axis (counterpart of cxxnet_tpu/parallel/ring.py).

Each rank of a seq group holds one contiguous block of the sequence:
its [B, H_local, S/n, D] blocks of q, k and v (batch rows of its data
index, heads of its model shard where the model axis divides them -
the JAX package's `_bhsd_spec` - and sequence block `seq_rank`). Both
schemes take this rank's blocks and return this rank's output block;
their backward passes are autograd's, through the Functions below.

ring_attention    n - 1 hops send the resident K/V block to the next
                  rank of the ring and receive the previous rank's
                  (parallel/distributed.py ring_hop, one
                  batch_isend_irecv; the last block is not sent on);
                  each step's partial merges into the output by its
                  log-sum-exp, in float32. Under `causal` a block from a
                  later rank lies wholly in the future and is skipped
                  (the hop still happens); the diagonal block is causal,
                  an earlier one is not masked. On the card a partial is
                  K2-fwd (ops/flash_attention.py attn_fwd: the block's
                  normalised output and its lse); on the CPU it is the
                  plain online-softmax partial of ops/attention.py with
                  the block offsets the JAX package passes. The backward
                  is the ring flash backward: delta = rowsum(do * o) and
                  the merged lse are this rank's; at each step K2-dq
                  adds the visiting block's share into dq, and K2-dkv
                  gives the visiting block's dk / dv, which add into
                  float32 buffers that travel with the block; after the
                  ring one more hop takes them home. Only the block
                  pairs the forward computed are computed. K2 reads p
                  back from the row's global lse, which is what a
                  per-block backward needs, so no kernel is new. At
                  head_dim past 256 the kernels' wide route keeps the
                  same lse and delta layouts, so the merge and the
                  per-block backward are unchanged.
ulysses_attention one all-to-all reshards [B, H, S/n, D] to [B, H/n, S,
                  D] (q, k and v together), flash_attention (K2-fwd, and
                  K2-dq / K2-dkv in the backward, on the card) runs over
                  the whole sequence for H/n heads, and the inverse
                  all-to-all brings the output back; each exchange's
                  backward is the inverse exchange. The heads of a
                  shard must divide by n.

The JAX package runs XLA's online-softmax partials in its ring body and
its blockwise core in Ulysses; the port runs K2 there (the same
function). Under gloo a CUDA tensor crosses through pinned host memory
(counted in distributed.host_staged); where each rank has its own card
the exchanges go over NCCL. `calls` counts the schemes, the forward's
partials and hops, and the backward's partials.
"""

from __future__ import annotations

from typing import Optional

import torch

from cxxnet_tpu_torch.ops import attention as attn_ops
from cxxnet_tpu_torch.ops import flash_attention as fa
from cxxnet_tpu_torch.parallel import distributed
from cxxnet_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, seq_axis_size

SEQ_SCHEMES = ("ring", "ulysses", "none")

calls = {"ring": 0, "ulysses": 0, "partials": 0, "hops": 0,
         "backward_partials": 0, "gather": 0}

__all__ = ["SEQ_AXIS", "SEQ_SCHEMES", "seq_axis_size", "ring_eligible",
           "ring_attention", "ulysses_attention", "seq_parallel_attention",
           "seq_gather"]


def ring_eligible(mesh: Optional[Mesh], seq_len: int) -> bool:
    """A real 'seq' axis whose size divides the (whole) sequence
    length."""
    n = seq_axis_size(mesh)
    return n > 1 and seq_len % n == 0


def _ring(mesh: Mesh):
    """(n, this rank's seq index, the next rank's and the previous
    rank's job ranks, the seq group)."""
    peers, r = mesh.seq_peers, mesh.seq_rank
    n = len(peers)
    return n, r, peers[(r + 1) % n], peers[(r - 1) % n], mesh.seq_group


def _computed(blk: int, r: int, causal: bool) -> bool:
    """Whether the pair (this rank's queries, block `blk`'s keys) has
    any unmasked entry: under causal a later rank's block has none."""
    return not (causal and blk > r)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        n, r, nxt, prv, group = _ring(mesh)
        s = q.shape[2]
        k_cur, v_cur = k, v
        o = lse = part = None
        for t in range(n):
            blk = (r - t) % n
            hop = (distributed.ring_hop([k_cur, v_cur], group, nxt, prv)
                   if t < n - 1 else None)
            if t < n - 1:
                calls["hops"] += 1
            if _computed(blk, r, causal):
                calls["partials"] += 1
                if q.is_cuda:
                    o_b, lse_b = fa.attn_fwd(q, k_cur, v_cur,
                                             causal and blk == r, scale)
                    if o is None:
                        o, lse = o_b.float(), lse_b
                    else:
                        new = torch.logaddexp(lse, lse_b)
                        o = (o * torch.exp(lse - new)[..., None]
                             + o_b.float() * torch.exp(lse_b - new)[..., None])
                        lse = new
                else:
                    p = attn_ops.attention_partial(
                        q, k_cur, v_cur, scale=scale, causal=causal,
                        q_offset=r * s, kv_offset=blk * s)
                    part = p if part is None else attn_ops.merge_partials(
                        part, p)
            if hop is not None:
                k_cur, v_cur = hop.wait()
        if q.is_cuda:
            o = o.to(q.dtype)
        else:
            acc, m, l = part
            o = attn_ops.finalize_partial(acc, l, q.dtype)
            lse = m + torch.log(torch.where(l > 0, l, 1.0))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.causal, ctx.scale = mesh, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        n, r, nxt, prv, group = _ring(ctx.mesh)
        do = do.contiguous()
        delta = fa.flash_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for t in range(n):
            blk = (r - t) % n
            if _computed(blk, r, causal):
                calls["backward_partials"] += 1
                c = causal and blk == r
                if q.is_cuda:
                    dq_b = fa.attn_dq(q, k_cur, v_cur, do, lse, delta, c,
                                      scale)
                    dk_b, dv_b = fa.attn_dkv(q, k_cur, v_cur, do, lse,
                                             delta, c, scale)
                else:
                    dq_b = fa.flash_dq_reference(q, k_cur, v_cur, do, lse,
                                                 delta, c, scale)
                    dk_b, dv_b = fa.flash_dkv_reference(
                        q, k_cur, v_cur, do, lse, delta, c, scale)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            if t < n - 1:
                # the buffers travel with their block (float32 first:
                # the packed views stay aligned)
                dk, dv, k_cur, v_cur = distributed.ring_hop(
                    [dk, dv, k_cur, v_cur], group, nxt, prv).wait()
        # rank r now holds block r + 1's buffers: one hop takes them home
        dk, dv = distributed.ring_hop([dk, dv], group, nxt, prv).wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, *, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the mesh's 'seq' axis: this rank's [B, H, S/n,
    D] blocks in, this rank's output block out; the whole of the ranks'
    blocks is ops.attention.naive_attention of the whole sequence."""
    calls["ring"] += 1
    return _RingAttention.apply(q, k, v, mesh, bool(causal),
                                None if scale is None else float(scale))


def _to_heads(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(C, B, H, S/n, D) -> (C, B, H/n, S, D): rank j keeps heads block
    j of every rank's sequence block."""
    c, b, h, s, d = t.shape
    t = t.reshape(c, b, n, h // n, s, d).permute(2, 0, 1, 3, 4, 5)
    t = distributed.all_to_all(t.contiguous(), group)
    return t.permute(1, 2, 3, 0, 4, 5).reshape(c, b, h // n, n * s, d)


def _to_seq(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of _to_heads: (C, B, H/n, S, D) -> (C, B, H, S/n, D)."""
    c, b, hn, sf, d = t.shape
    s = sf // n
    t = t.reshape(c, b, hn, n, s, d).permute(3, 0, 1, 2, 4, 5)
    t = distributed.all_to_all(t.contiguous(), group)
    return t.permute(1, 2, 0, 3, 4, 5).reshape(c, b, n * hn, s, d)


class _ToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n):
        ctx.group, ctx.n = group, n
        return _to_heads(t, group, n)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g.contiguous(), ctx.group, ctx.n), None, None


class _ToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n):
        ctx.group, ctx.n = group, n
        return _to_seq(t, group, n)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g.contiguous(), ctx.group, ctx.n), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, *, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: this rank's [B, H, S/n, D]
    blocks in (H the heads of its model shard), its output block out.
    The heads must divide by the seq axis."""
    n = seq_axis_size(mesh)
    if q.shape[1] % n != 0:
        raise ValueError(
            f"ulysses needs heads per shard ({q.shape[1]}) divisible by "
            f"the seq axis ({n}); use ring_attention instead")
    calls["ulysses"] += 1
    qg, kg, vg = _ToHeads.apply(torch.stack([q, k, v]), mesh.seq_group,
                                n).unbind(0)
    o = fa.flash_attention(qg, kg, vg, causal, scale)
    return _ToSeq.apply(o[None], mesh.seq_group, n)[0]


def seq_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh: Optional[Mesh],
                           scheme: str, *, causal: bool = False,
                           scale: Optional[float] = None
                           ) -> Optional[torch.Tensor]:
    """The attention layers' sequence-parallel dispatch: ring or Ulysses
    over the seq axis of `mesh` (the mesh a seq-sharded layer runs
    under, layers/base.py seq_block_mesh), or None for the caller's own
    route: scheme 'none', no mesh, or no seq axis above 1 - the layer
    then runs on the whole sequence."""
    if scheme == "none" or seq_axis_size(mesh) <= 1:
        return None
    if scheme == "ulysses":
        return ulysses_attention(q, k, v, mesh, causal=causal, scale=scale)
    return ring_attention(q, k, v, mesh, causal=causal, scale=scale)


class _SeqGather(torch.autograd.Function):
    """All-gather of the seq ranks' blocks along dim 2 forward; the
    reduce-scatter of the gradient backward. After the gather every seq
    rank computes the same values, and the trainer scales the loss by
    1 / n, so each rank's gradient of the whole node is 1 / n of the
    whole: their sum, cut to this rank's block, is the block's
    gradient. (The gradient sum over data x seq then counts every
    parameter once, before the gather and after it.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = (distributed.all_gather(
            x.contiguous().view(torch.float16), mesh.seq_group)
            if x.dtype == torch.bfloat16
            else distributed.all_gather(x, mesh.seq_group))
        if x.dtype == torch.bfloat16:
            parts = [p.view(torch.bfloat16) for p in parts]
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        n = seq_axis_size(ctx.mesh)
        b, c, s, x = g.shape
        chunks = g.float().reshape(b, c, n, s // n, x).permute(2, 0, 1, 3, 4)
        mine = distributed.reduce_scatter(chunks.contiguous(),
                                          ctx.mesh.seq_group)
        return mine.view(b, c, s // n, x).to(g.dtype), None


def seq_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole sequence of a seq-sharded node (b, c, s/n, x) ->
    (b, c, s, x), in seq order (nnet/network.py)."""
    calls["gather"] += 1
    return _SeqGather.apply(x, mesh)
