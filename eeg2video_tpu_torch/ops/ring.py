"""Ring attention's forward: context-parallel ("sp") attention over a mesh axis.

Counterpart of ``eeg2video_tpu/ops/ring.py`` (the forward; its
``custom_vjp`` backwards are not ported yet, and an operand that asks for a
gradient is refused by name). The spatial-token axis of q splits over the sp
ranks; where the keys split too (ring mode), each rank's K/V block moves one
ring position a hop through ``torch.distributed`` point-to-point sends, so
that after sp hops every rank's query rows have seen every key. Each hop is
one ``flash_attention_fwd(..., return_lse=True)`` launch, and the hops
combine exactly by their log-sum-exp,

    lse = logsumexp_i(lse_i),   out = sum_i exp(lse_i - lse) * out_i,

in f32 (``ring_step``). The exchange for hop t + 1 is posted before hop t's
kernel and awaited after it, as XLA overlaps its collective-permute with the
previous hop. Keys whose count does not split (the 77-token cross-attention
context) stay whole on every rank: replicated-KV mode, one launch, no hops.

A (N, 1, Lkv) additive bias is KV-aligned: in ring mode its shard travels
with its K/V block, in replicated-KV mode it stays whole. Operands are
channels-minor (N, L, H*D), as the to_q/k/v projections produce them.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..parallel.mesh import all_gather
from .attention import flash_attention_fwd


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


def _refuse_grad(*tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("ring attention: an operand asks for a gradient, and the ring's "
                           "backward is not ported yet (ROADMAP.md §1 item 7); call it under "
                           "torch.no_grad() or torch.inference_mode()")


def ring_attention_inner(q, k, v, heads, scale, group, sp, bias=None):
    """The hops over this rank's LOCAL shards (JAX's shard-level entry point):
    q (N, Lq/sp, H*D), k/v (N, Lkv/sp, H*D) and bias (N, 1, Lkv/sp) or None,
    the rank's own block first. Every rank of ``group`` (sp ranks) calls it;
    sp = 1 is one launch and no exchange. Returns this rank's output rows in
    q's dtype."""
    _refuse_grad(q, k, v, bias)
    kb, vb, bb = (None if t is None else t.contiguous() for t in (k, v, bias))
    q = q.contiguous()
    out = lse = None
    for t in range(sp):
        pending = None
        if t + 1 < sp:  # the last hop's blocks are not needed again
            pending = _shift([x for x in (kb, vb, bb) if x is not None], group, sp)
        out, lse = ring_step(out, lse, q, kb, vb, bb, heads, scale)
        if pending is not None:
            bufs, reqs = pending
            for req in reqs:
                req.wait()
            kb, vb = bufs[:2]
            bb = bufs[2] if bb is not None else None
    return out.to(q.dtype)


def ring_attention_packed(q, k, v, heads, mesh, scale=None, bias=None, head_axis="tp"):
    """Context-parallel attention of GLOBAL, replicated (N, L, H*D)
    operands, the batch already this rank's dp slice; returns the whole
    (N, Lq, H*D) output on every rank, as ``_sp_attention`` pins it in JAX.

    This rank takes its ``Lq / sp`` query rows (contiguous, in sp-rank
    order); its ``Lkv / sp`` key rows when they divide (ring mode), else the
    whole keys (replicated-KV mode, no hops); and, when ``head_axis`` names
    an axis of size tp > 1, its ``heads // tp`` heads (Megatron tp composing
    with the ring: attention is per head). The output is gathered over sp
    (and over tp). Every rank of the mesh calls it. ``bias``: (N, 1, Lkv) or
    None."""
    _refuse_grad(q, k, v, bias)
    d = q.shape[-1] // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    sp = mesh.size("sp")
    if q.shape[1] % sp:
        raise ValueError(f"query token axis {q.shape[1]} not divisible by sp={sp}")
    tp = mesh.size(head_axis) if head_axis else 1
    if heads % tp:
        raise ValueError(f"heads={heads} not divisible by {head_axis}={tp} for head sharding")
    heads_l = heads // tp
    if tp > 1:
        c0 = mesh.rank(head_axis) * heads_l * d
        q, k, v = (t[..., c0:c0 + heads_l * d] for t in (q, k, v))
    r = mesh.rank("sp")
    lq = q.shape[1] // sp
    ql = q[:, r * lq:(r + 1) * lq]
    if k.shape[1] % sp == 0:  # ring mode: the KV-aligned bias shard travels with its block
        lk = k.shape[1] // sp
        kv = (k[:, r * lk:(r + 1) * lk], v[:, r * lk:(r + 1) * lk],
              None if bias is None else bias[..., r * lk:(r + 1) * lk])
        out = ring_attention_inner(ql, *kv[:2], heads_l, scale, mesh.group("sp"), sp,
                                   bias=kv[2])
    else:  # replicated-KV mode
        out = ring_attention_inner(ql, k, v, heads_l, scale, None, 1, bias=bias)
    n = out.shape[0]
    if sp > 1:
        out = all_gather(out, mesh.group("sp"), sp)  # (sp N, Lq/sp, .)
        out = out.view(sp, n, lq, -1).transpose(0, 1).reshape(n, sp * lq, -1)
    if tp > 1:
        out = all_gather(out, mesh.group(head_axis), tp)  # (tp N, Lq, heads_l D)
        out = out.view(tp, n, sp * lq, -1).permute(1, 2, 0, 3).reshape(n, sp * lq, -1)
    return out
