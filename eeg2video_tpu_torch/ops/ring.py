"""Ring attention: context-parallel ("sp") attention over a mesh axis,
forward and backward.

Counterpart of ``eeg2video_tpu/ops/ring.py``. The spatial-token axis of q
splits over the sp ranks; where the keys split too (ring mode), each rank's
K/V block moves one ring position a hop through ``torch.distributed``
point-to-point sends, so that after sp hops every rank's query rows have
seen every key. Keys whose count does not split (the 77-token
cross-attention context) stay whole on every rank: replicated-KV mode, one
launch, no hops.

Forward: each hop is one ``flash_attention_fwd(..., return_lse=True)``
launch, and the hops combine exactly by their log-sum-exp,

    lse = logsumexp_i(lse_i),   out = sum_i exp(lse_i - lse) * out_i,

in f32 (``ring_step``). The exchange for hop t + 1 is posted before hop t's
kernel and awaited after it, as XLA overlaps its collective-permute with the
previous hop.

Backward (JAX ring.py:25-31, :105-247): each hop is one
``flash_attention_bwd`` launch against the GLOBAL (out, lse) of the forward
(``ring_bwd_step``). That normalizer makes each block's dq / dk / dv / dbias
partial exact. dq accumulates on its rank in f32; the K/V block, its bias
shard and their f32 dk / dv / dbias accumulators rotate together and arrive
home after sp hops. The block is posted a hop ahead, and the accumulators
are posted after a hop's adds and awaited just before the next hop's, so
that both exchanges run under a kernel. In replicated-KV mode the one
launch gives dk / dv / dbias partial over sp (each rank differentiates its
own query rows).

A (N, 1, Lkv) additive bias is KV-aligned: in ring mode its shard travels
with its K/V block, in replicated-KV mode it stays whole. Operands are
channels-minor (N, L, H*D), as the to_q/k/v projections produce them.

``ring_attention_packed`` takes global operands that are replicated over sp
and returns the whole output on every rank, so its backward returns whole,
replicated gradients: this rank's rows of the incoming gradient (never
summed over sp: every sp rank holds the same one), dq gathered over sp; in
ring mode the home blocks' dk / dv / dbias gathered over sp, in
replicated-KV mode summed over sp; with a head axis, everything gathered over
it by heads and dbias summed over it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..parallel.mesh import gather_cat
from .attention import flash_attention_bwd, flash_attention_fwd


def _shift(tensors, group, sp):
    """Post the exchange that moves each rank's blocks one ring position: the
    blocks of sp-rank j go to j - 1, so that after t hops sp-rank i holds
    block (i + t) % sp. One batch of non-blocking sends and receives (a
    blocking send then receive would deadlock every rank at once). Returns
    the receive buffers and the requests to wait on."""
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me - 1) % sp)
    src = dist.get_global_rank(group, (me + 1) % sp)
    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, bufs):
        ops += [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, buf, src, group)]
    return bufs, dist.batch_isend_irecv(ops)


def _arrive(pending):
    bufs, reqs = pending
    for req in reqs:
        req.wait()
    return bufs


def _weighted(out, w, heads):
    """(N, L, H*D) times per-(N, H, L) weights."""
    n, l, hd = out.shape
    return (out.view(n, l, heads, hd // heads) * w.transpose(1, 2)[..., None]).view(n, l, hd)


def ring_step(out, lse, q, kb, vb, bias_b, heads, scale):
    """One hop: attention of q against the K/V block (kb, vb) with its bias
    shard, one ``flash_attention_fwd`` launch, folded into the running f32
    (out, lse) by the log-sum-exp combine (``None`` before the first hop).
    Returns the new (out, lse): out (N, Lq, H*D) f32, lse (N, H, Lq) f32."""
    o_i, l_i = flash_attention_fwd(q, kb, vb, heads, bias0=bias_b, scale=scale,
                                   return_lse=True)
    o_i = o_i.float()
    if out is None:
        return o_i, l_i
    m = torch.maximum(lse, l_i)
    a = torch.exp(lse - m)
    b = torch.exp(l_i - m)
    denom = a + b
    out = _weighted(out, a / denom, heads) + _weighted(o_i, b / denom, heads)
    return out, m + torch.log(denom)


def ring_bwd_step(q, kb, vb, bias_b, dout, out, lse, heads, scale, need_dbias=None):
    """One backward hop: this rank's query rows against the K/V block (kb,
    vb) with its bias shard, one ``flash_attention_bwd`` launch against the
    global ``(out, lse)`` of the forward. Returns the block's exact partial
    (dq, dk, dv, dbias) in the operands' dtypes (dbias None without a bias,
    or where ``need_dbias`` is False)."""
    if need_dbias is None:
        need_dbias = bias_b is not None
    dq, dk, dv, _, _, db = flash_attention_bwd(q, kb, vb, heads, dout, out, lse, bias0=bias_b,
                                               scale=scale, need_dbias=need_dbias)
    return dq, dk, dv, db


def _ring_fwd(q, k, v, bias, heads, scale, group, sp):
    """The forward hops over this rank's local shards: (out f32, lse f32)."""
    kb, vb, bb = k, v, bias
    out = lse = None
    for t in range(sp):
        pending = None
        if t + 1 < sp:  # the last hop's blocks are not needed again
            pending = _shift([x for x in (kb, vb, bb) if x is not None], group, sp)
        out, lse = ring_step(out, lse, q, kb, vb, bb, heads, scale)
        if pending is not None:
            bufs = _arrive(pending)
            kb, vb = bufs[:2]
            bb = bufs[2] if bb is not None else None
    return out, lse


def _ring_bwd(q, k, v, bias, dout, out, lse, heads, scale, group, sp, need_dbias):
    """The backward hops over this rank's local shards (JAX
    ``_ring_local_bwd`` :117-132, ``_ring_local_biased_bwd`` :198-216): dq of
    this rank's rows, and dk / dv / dbias of this rank's home block (after sp
    hops the rotating accumulators are back), in the operands' dtypes. sp = 1
    is one launch and no exchange."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb, bb = k, v, bias
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in (k, v, *((bias,) if need_dbias else ()))]
    moving = None  # the accumulators in flight to this rank
    for t in range(sp):
        pending = None
        if t + 1 < sp:  # the block for the next hop travels while this one runs
            pending = _shift([x for x in (kb, vb, bb) if x is not None], group, sp)
        dq_p, *parts = ring_bwd_step(q, kb, vb, bb, dout, out, lse, heads, scale, need_dbias)
        dq += dq_p.float()
        if moving is not None:  # this hop's block's accumulators, sent during its kernel
            acc = _arrive(moving)
        for a, p in zip(acc, parts):
            a += p.float()
        if sp > 1:  # they follow their block, through the next hop's kernel; home after sp
            moving = _shift(acc, group, sp)
        if pending is not None:
            bufs = _arrive(pending)
            kb, vb = bufs[:2]
            bb = bufs[2] if bb is not None else None
    if moving is not None:
        acc = _arrive(moving)
    dk, dv = acc[0].to(k.dtype), acc[1].to(v.dtype)
    db = acc[2].to(bias.dtype) if need_dbias else None
    return dq.to(q.dtype), dk, dv, db


def _contiguous(*tensors):
    return [None if t is None else t.contiguous() for t in tensors]


class _RingInner(torch.autograd.Function):
    """The hops over local shards, with the ring's backward behind."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, scale, group, sp):
        q, k, v, bias = _contiguous(q, k, v, bias)
        out, lse = _ring_fwd(q, k, v, bias, heads, scale, group, sp)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (heads, scale, group, sp)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        heads, scale, group, sp = ctx.args
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, db = _ring_bwd(q, k, v, bias, dout.to(q.dtype).contiguous(), out, lse,
                                   heads, scale, group, sp, need_dbias)
        return dq, dk, dv, db, None, None, None, None


def ring_attention_inner(q, k, v, heads, scale, group, sp, bias=None):
    """The hops over this rank's LOCAL shards (JAX's shard-level entry point):
    q (N, Lq/sp, H*D), k/v (N, Lkv/sp, H*D) and bias (N, 1, Lkv/sp) or None,
    the rank's own block first. Every rank of ``group`` (sp ranks) calls it;
    sp = 1 is one launch and no exchange. Returns this rank's output rows in
    q's dtype; differentiable, its gradients those of the local shards (dk /
    dv / dbias of the home block)."""
    return _RingInner.apply(q, k, v, bias, heads, float(scale), group, int(sp))


class _RingPacked(torch.autograd.Function):
    """``ring_attention_packed`` on global operands: this rank's rows (and
    heads) forward, the gathers after; whole, replicated gradients backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, scale, mesh, head_axis):
        d = q.shape[-1] // heads
        sp = mesh.size("sp")
        tp = mesh.size(head_axis) if head_axis else 1
        heads_l = heads // tp
        if tp > 1:
            c0 = mesh.rank(head_axis) * heads_l * d
            q, k, v = (t[..., c0:c0 + heads_l * d] for t in (q, k, v))
        r = mesh.rank("sp")
        lq = q.shape[1] // sp
        ql = q[:, r * lq:(r + 1) * lq]
        ring_kv = k.shape[1] % sp == 0
        if ring_kv:  # ring mode: the KV-aligned bias shard travels with its block
            lk = k.shape[1] // sp
            kl, vl = k[:, r * lk:(r + 1) * lk], v[:, r * lk:(r + 1) * lk]
            bl = None if bias is None else bias[..., r * lk:(r + 1) * lk]
            group, hops = mesh.group("sp"), sp
        else:  # replicated-KV mode
            kl, vl, bl, group, hops = k, v, bias, None, 1
        ql, kl, vl, bl = _contiguous(ql, kl, vl, bl)
        out, lse = _ring_fwd(ql, kl, vl, bl, heads_l, scale, group, hops)
        out = out.to(q.dtype)
        ctx.save_for_backward(ql, kl, vl, bl, out, lse)
        ctx.args = (heads_l, scale, mesh, head_axis, tp, ring_kv, group, hops, lq, d)
        out = gather_cat(out, mesh.group("sp"), sp, 1)
        if tp > 1:
            out = gather_cat(out, mesh.group(head_axis), tp, 2)
        return out

    @staticmethod
    def backward(ctx, dout):
        ql, kl, vl, bl, out, lse = ctx.saved_tensors
        heads_l, scale, mesh, head_axis, tp, ring_kv, group, hops, lq, d = ctx.args
        need_dbias = bl is not None and ctx.needs_input_grad[3]
        r = mesh.rank("sp")
        if tp > 1:
            c0 = mesh.rank(head_axis) * heads_l * d
            dout = dout[..., c0:c0 + heads_l * d]
        dout = dout[:, r * lq:(r + 1) * lq].to(ql.dtype).contiguous()
        dq, dk, dv, db = _ring_bwd(ql, kl, vl, bl, dout, out, lse, heads_l, scale, group, hops,
                                   need_dbias)
        sp, spg = mesh.size("sp"), mesh.group("sp")
        dq = gather_cat(dq, spg, sp, 1)
        parts = [dk, dv] + ([db] if need_dbias else [])
        if ring_kv:  # the home blocks, in sp-rank order along the keys
            parts = [gather_cat(t, spg, sp, t.dim() - 1 if t is db else 1) for t in parts]
        elif spg is not None:  # partial over sp: every rank differentiated its own rows
            flat = torch.cat([t.float().reshape(-1) for t in parts])
            dist.all_reduce(flat, group=spg)
            parts = [p.to(t.dtype).view_as(t)
                     for p, t in zip(flat.split([t.numel() for t in parts]), parts)]
        dk, dv = parts[:2]
        db = parts[2] if need_dbias else None
        if tp > 1:  # whole heads from every tp rank; the bias is shared by all heads
            tpg = mesh.group(head_axis)
            dq, dk, dv = (gather_cat(t, tpg, tp, 2) for t in (dq, dk, dv))
            if need_dbias:
                db = db.contiguous()
                dist.all_reduce(db, group=tpg)
        return dq, dk, dv, db, None, None, None, None


def ring_attention_packed(q, k, v, heads, mesh, scale=None, bias=None, head_axis="tp"):
    """Context-parallel attention of GLOBAL, replicated (N, L, H*D)
    operands, the batch already this rank's dp slice; returns the whole
    (N, Lq, H*D) output on every rank, as ``_sp_attention`` pins it in JAX.

    This rank takes its ``Lq / sp`` query rows (contiguous, in sp-rank
    order); its ``Lkv / sp`` key rows when they divide (ring mode), else the
    whole keys (replicated-KV mode, no hops); and, when ``head_axis`` names
    an axis of size tp > 1, its ``heads // tp`` heads (Megatron tp composing
    with the ring: attention is per head). The output is gathered over sp
    (and over tp). Every rank of the mesh calls it, and, where an operand
    asks for a gradient, joins the backward's collectives in the same order.
    ``bias``: (N, 1, Lkv) or None."""
    d = q.shape[-1] // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    sp = mesh.size("sp")
    if q.shape[1] % sp:
        raise ValueError(f"query token axis {q.shape[1]} not divisible by sp={sp}")
    tp = mesh.size(head_axis) if head_axis else 1
    if heads % tp:
        raise ValueError(f"heads={heads} not divisible by {head_axis}={tp} for head sharding")
    return _RingPacked.apply(q, k, v, bias, heads, float(scale), mesh, head_axis)
