"""How the plain reference rounds the operands of its products.

The reference computes in float32 with TF32 off (``exact_f32``). Its control,
the same reference in the precision just below the one a configuration
states, rounds the two operands of every matrix product and convolution
through ``Numerics``: ``fp8`` (e4m3 with one scale per tensor) below bf16
models, ``int4`` weights (one scale per output row) below the int8 semantic
predictor. Norms, softmax, the scheduler and every sum stay in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn value


def _fp8(t):
    """Round to e4m3 with one scale per tensor; the gradient passes straight
    through the rounding."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach() if t.requires_grad else q


class Numerics:
    """``kind`` "f32" keeps every operand; "fp8" rounds activations and
    weights of each product to e4m3 with a per-tensor scale."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def __call__(self, t):
        return t if self.kind == "f32" else _fp8(t)

    def linear(self, x, w, b=None):
        return F.linear(self(x), self(w), b)

    def conv(self, x, w, b=None, stride=1, padding=1):
        """(N, H, W, Cin) with a (Cout, Cin, kh, kw) weight -> (N, H', W', Cout)."""
        if w.shape[-2:] == (1, 1) and stride == 1:
            return self.linear(x, w.flatten(1), b)
        y = F.conv2d(self(x).permute(0, 3, 1, 2), self(w), b, stride, padding)
        return y.permute(0, 2, 3, 1).contiguous()

    def matmul(self, a, b):
        return self(a) @ self(b)


@contextlib.contextmanager
def exact_f32():
    """Matrix products and convolutions in true float32 (no TF32) inside the
    block; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
