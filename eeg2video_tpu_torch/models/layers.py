"""Layers with flax's train-mode rules, shared by the Seq2Seq transformer and
the EEG encoders.

- ``Dropout``: keep each element with probability 1 - p and scale the kept
  ones by 1 / (1 - p) (flax.linen.Dropout), the draws from ``generator``;
  ``broadcast_dims`` shares one draw along those axes (flax's
  ``broadcast_dims``: with (2, 3) on NCHW, whole feature maps, as
  nn.Dropout2d drops them).
- ``BatchNorm2d``: flax.linen.BatchNorm with momentum 0.9 in train mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dropout(nn.Dropout):
    """Dropout as flax draws it: keep each element with probability 1 - p and
    scale the kept ones by 1 / (1 - p), the draws from ``self.generator``
    (the default generator when it is None); an identity in eval mode."""

    generator = None

    def __init__(self, p: float = 0.5, broadcast_dims=()):
        super().__init__(p)
        self.broadcast_dims = tuple(broadcast_dims)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
        keep = torch.rand(shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode is flax's (momentum 0.9): normalize by
    the batch's mean and biased variance, then ``running = 0.9 running + 0.1
    batch`` with that biased variance (nn.BatchNorm2d's own update uses the
    unbiased one). Eval mode uses the running statistics."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def set_dropout_generator(module: nn.Module, generator):
    """Make every ``Dropout`` of ``module`` draw from ``generator`` (a
    torch.Generator on the module's device; None: the default one)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
