"""Layers with flax's train-mode rules, shared by the Seq2Seq transformer and
the EEG encoders.

- ``Dropout``: keep each element with probability 1 - p and scale the kept
  ones by 1 / (1 - p) (flax.linen.Dropout), the draws from ``generator``;
  ``broadcast_dims`` shares one draw along those axes (flax's
  ``broadcast_dims``: with (2, 3) on NCHW, whole feature maps, as
  nn.Dropout2d drops them).
- ``BatchNorm2d``: flax.linen.BatchNorm with momentum 0.9 in train mode.

Under data parallelism (``set_data_parallel``) both follow the global batch,
as JAX's do when GSPMD shards the batch over a mesh: the BatchNorm's train
statistics are reduced over the dp group, and each Dropout draws the global
batch's mask and keeps this rank's rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class Dropout(nn.Dropout):
    """Dropout as flax draws it: keep each element with probability 1 - p and
    scale the kept ones by 1 / (1 - p), the draws from ``self.generator``
    (the default generator when it is None); an identity in eval mode."""

    generator = None
    # (n, r): x holds rows [r*b, (r+1)*b) of a global batch of n*b rows, whose
    # mask is drawn (set_data_parallel)
    batch_split = (1, 0)

    def __init__(self, p: float = 0.5, broadcast_dims=()):
        super().__init__(p)
        self.broadcast_dims = tuple(broadcast_dims)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
        n, r = self.batch_split
        if n > 1 and 0 not in self.broadcast_dims:
            b = shape[0]
            shape[0] *= n
            keep = torch.rand(shape, generator=self.generator, device=x.device)[r * b:(r + 1) * b]
        else:
            keep = torch.rand(shape, generator=self.generator, device=x.device)
        return torch.where(keep >= self.p, x / (1.0 - self.p), 0.0)


class _GatherStats(torch.autograd.Function):
    """(n, *s) of every rank's (*s) in group-rank order forward; backward
    each rank's gradient of its own entry summed over the group (every
    rank's loss reads every entry)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=group)
        return out.view(n, *x.shape)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode is flax's (momentum 0.9): normalize by
    the batch's mean and biased variance, then ``running = 0.9 running + 0.1
    batch`` with that biased variance (nn.BatchNorm2d's own update uses the
    unbiased one). Eval mode uses the running statistics.

    With a dp ``group`` (``set_data_parallel``; every rank holds as many rows)
    the statistics are the global batch's, as JAX's mean over a sharded axis
    is: each rank's ``torch.var_mean`` is gathered, in rank order, and
    combined as equal shares, mean = mean of the means, variance = mean of
    (variance + (mean_r - mean)^2); the normalization is written out (x -
    mean) * rsqrt(variance + eps) * weight + bias. That rounds otherwise than
    one ``var_mean`` over the whole batch and ``F.batch_norm``: within float32
    noise of it. The gather differentiates (its backward sums each rank's
    share over the group, the two sums SyncBatchNorm's backward reduces), and
    the running statistics, made from the same gathered values in the same
    order, are equal on every rank. ``torch.nn.SyncBatchNorm`` is not used:
    its running variance is the unbiased one."""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self._track(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        every = _GatherStats.apply(torch.stack([mean, var]), self.group)
        mean = every[:, 0].mean(0)
        var = (every[:, 1] + (every[:, 0] - mean) ** 2).mean(0)
        with torch.no_grad():
            self._track(mean, var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]

    def _track(self, mean, var):
        self.running_mean.mul_(0.9).add_(0.1 * mean)
        self.running_var.mul_(0.9).add_(0.1 * var)
        self.num_batches_tracked += 1


def set_dropout_generator(module: nn.Module, generator):
    """Make every ``Dropout`` of ``module`` draw from ``generator`` (a
    torch.Generator on the module's device; None: the default one)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_data_parallel(module: nn.Module, group):
    """Make ``module``'s train mode that of the global batch split evenly
    over ``group`` (a dp process group; None: one rank, the default): every
    ``BatchNorm2d`` reduces its statistics over it, every ``Dropout`` draws
    the global batch's mask and keeps this rank's rows."""
    n, r = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
        elif isinstance(m, Dropout):
            m.batch_split = (n, r)
