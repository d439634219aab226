"""Random weights from a seeded generator.

``random_init_`` is for smoke runs without a checkpoint: zero weights would
hide kernel faults (every kernel output would be its bias), so each matrix
gets N(0, 1/fan_in) entries, norm scales 1 + N(0, 0.05^2) and biases
N(0, 0.02^2). ``lecun_init_`` is the start of a training run: flax's default
initializers, which the JAX trainers start from."""

from __future__ import annotations

import torch


@torch.no_grad()
def random_init_(module, generator):
    """Fill every parameter of ``module`` in place, on its own device, from
    ``generator`` (a torch.Generator on that device)."""
    for name, p in module.named_parameters():
        r = torch.randn(p.shape, generator=generator, device=p.device,
                        dtype=torch.float32)
        if p.dim() >= 2:
            r /= p[0].numel() ** 0.5
        elif name.endswith("weight"):
            r = 1.0 + 0.05 * r
        else:
            r *= 0.02
        p.copy_(r)
    return module


@torch.no_grad()
def lecun_init_(module, generator):
    """flax's defaults in place, from ``generator`` (on the parameters'
    device): every matrix and convolution kernel lecun-normal (a normal
    truncated at 2 std, scaled to variance 1/fan_in), every other weight (the
    norms' scales) 1, every bias 0. Buffers are left as they are."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(p, std=std, a=-2.0 * std, b=2.0 * std,
                                        generator=generator)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return module
