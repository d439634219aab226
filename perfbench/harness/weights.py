"""Seeded inputs and weights, made on the device in a few large calls.

``make_state`` fills one flat float32 buffer from a ``torch.Generator`` on the
device with a single normal draw, then shapes each leaf out of it: a matrix
or convolution kernel N(0, 1/fan_in), a 1-D weight (a norm's scale)
1 + N(0, 0.05^2), any other leaf (a bias) N(0, 0.02^2). Zero weights would
hide faults, and these keep a random UNet's activations of order one. The
same (shapes, seed, device) give the same tensors, bit for bit, to the
program and to the reference.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed of its own for each thing a run makes from ``seed``."""
    digest = hashlib.blake2b(f"{int(seed)}:{what}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed: int, what: str, device):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


@torch.no_grad()
def make_state(shapes, seed: int, what: str, device, dtype=torch.float32):
    """{name: tensor of ``dtype``} for ``shapes`` ({name: shape}, ordered)."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=generator(seed, what, device))
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            leaf /= math.sqrt(math.prod(shape[1:]))
        elif name.endswith("weight"):
            leaf.mul_(0.05).add_(1.0)
        else:
            leaf.mul_(0.02)
        out[name] = leaf if dtype == torch.float32 else leaf.to(dtype)
    if dtype != torch.float32:
        del flat
    return out
