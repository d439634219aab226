"""GPipe pipeline parallelism over a process group: one stage a rank.

Counterpart of ``eeg2video_tpu/parallel/pipeline.py`` (``_gpipe_local`` and
``gpipe_apply``, :37-107). JAX runs the schedule as one ``lax.scan`` inside a
``shard_map``; here each rank of ``group`` runs the same loop of
``n_micro + pp - 1`` ticks in its own process:

- stage 0 takes microbatch t at tick t, and zeros once the feed has ended;
  the other stages take what the previous stage handed them;
- every rank applies its stage, then hands the result to the next rank by a
  neighbour shift (``_Shift``: forward sends to rank + 1 and receives from
  rank - 1, backward is the inverse shift), both directions in one
  ``dist.batch_isend_irecv`` so that a chain of sends cannot deadlock. JAX's
  wrap from the last stage to stage 0 is dead (stage 0 injects instead) and
  is left out; the last tick hands nothing on;
- the last stage collects microbatch t - (pp - 1) at tick t, and its outputs
  reach every rank by JAX's masked all-reduce.

Gradients. The graph is the same on every rank (JAX's ``where`` masks: the
values a rank discards still join its graph, with zero cotangents), so every
rank runs every shift's backward, in the same order. The input is replicated
and only stage 0 reads it: its cotangent is summed over the group, which
gives every rank the sequential gradient (``copy_to``). The output's
cotangent is summed over the group where the ranks consume different parts of
it (``out_split``: a head whose columns are split over the group, JAX's
train/semantic.py:163), and is the last stage's own where every rank consumes
all of it the same way (a replicated head), which counts it once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import copy_to


def _shift(t, group, idx: int, pp: int, step: int):
    """Send ``t`` to stage ``idx + step`` and return what stage ``idx - step``
    sent (zeros where there is no such stage)."""
    t = t.contiguous()
    out = torch.zeros_like(t)
    ops = []
    if 0 <= idx + step < pp:
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, idx + step), group))
    if 0 <= idx - step < pp:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, idx - step), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage idx's activation to stage idx + 1 (JAX's ``ppermute`` without
    the wrap); backward, the cotangent back to stage idx - 1."""

    @staticmethod
    def forward(ctx, y, group, idx, pp):
        ctx.args = (group, idx, pp)
        return _shift(y, group, idx, pp, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, *ctx.args, -1), None, None, None


class _FromLast(torch.autograd.Function):
    """The masked all-reduce of the last stage's outputs (every other rank
    brings zeros); backward, the sum of the ranks' cotangents (``split``) or
    this rank's own."""

    @staticmethod
    def forward(ctx, x, group, split):
        ctx.group, ctx.split = group, split
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


def gpipe_apply(fn, stage_params, x, group, n_micro: int, out_split: bool = False):
    """Run ``x`` through the pipelined stages of ``fn``, one a rank of
    ``group`` (None: a single stage, no collective).

    fn: ``(stage_params, (mb, ...)) -> (mb, ...)``, one homogeneous block
    whose output has its input's shape; ``stage_params`` is this rank's
    stage. x: the (batch, ...) global input, the same on every rank, split
    into ``n_micro`` microbatches. Returns the (batch, ...) outputs, the same
    on every rank. ``out_split``: the ranks consume different parts of the
    output (see the module docstring). Every rank of the group calls it."""
    pp = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    xm = copy_to(x, group).reshape(n_micro, b // n_micro, *x.shape[1:])
    first = torch.tensor(idx == 0, device=x.device)
    zero = torch.zeros_like(xm[0])
    recv, outs = zero, []
    ticks = n_micro + pp - 1
    for t in range(ticks):
        feed = xm[t] if t < n_micro else zero
        y = fn(stage_params, torch.where(first, feed, recv))
        if t >= pp - 1:  # the last stage's microbatch t - (pp - 1)
            outs.append(y)
        if pp > 1 and t < ticks - 1:
            recv = _Shift.apply(y, group, idx, pp)
    out = torch.cat(outs)
    if pp > 1:
        last = torch.tensor(idx == pp - 1, device=x.device)
        out = _FromLast.apply(torch.where(last, out, torch.zeros_like(out)), group, out_split)
    return out
