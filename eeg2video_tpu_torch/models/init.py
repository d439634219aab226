"""Random weights from a seeded generator, for smoke runs without a
checkpoint. Zero weights would hide kernel faults (every kernel output would
be its bias), so each matrix gets N(0, 1/fan_in) entries, norm scales
1 + N(0, 0.05^2) and biases N(0, 0.02^2)."""

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
