"""GEGLU feed-forward: ``ff_ln`` (CUDA kernel 2), ``geglu_out`` (CUDA kernel
3), their plain PyTorch versions, and the ``feed_forward`` router.

Counterpart of ``eeg2video_tpu/ops/geglu.py``. Weights are in nn.Linear
layout: ``wp`` (2I, C) and ``wo`` (C, I). Rounding follows the Pallas
kernels: LN in f32, xn cast to the weight dtype before the first GEMM, h2
f32 up to the gate, the gated product cast to the weight dtype before the
second GEMM, bias and residual added in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

FF_MAX_C = 640  # C <= 640 runs the whole block in ff_ln (geglu.py:407)


def _gelu_gate(h2, inner):
    h, g = h2[..., :inner], h2[..., inner:]
    return h * F.gelu(g)  # exact erf gelu


def _layer_norm_f32(x, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def ff_ln_plain(x, gamma, beta, wp, bp, wo, bo, eps=1e-5):
    """x + (h * gelu(g)) wo^T + bo, [h | g] = LN(x) wp^T + bp."""
    inner = wo.shape[1]
    xn = (_layer_norm_f32(x, eps) * gamma.float() + beta.float()).to(wp.dtype)
    h2 = xn.float() @ wp.float().t() + bp.float()
    gated = _gelu_gate(h2, inner).to(wo.dtype)
    out = x.float() + gated.float() @ wo.float().t() + bo.float()
    return out.to(x.dtype)


def geglu_out_plain(h2, w, b):
    """(h * gelu(g)) w^T + b from h2 = [h | g]."""
    gated = _gelu_gate(h2.float(), w.shape[1]).to(w.dtype)
    return (gated.float() @ w.float().t() + b.float()).to(h2.dtype)


def _f32(t):
    return t.float().contiguous()


def ff_ln(x, gamma, beta, wp, bp, wo, bo, eps=1e-5):
    """Whole pre-LN GEGLU FF block with residual. x (..., C). A CUDA tensor
    launches the kernel (bf16 x/wp/wo; C % 64 == 0, C <= 640); a CPU tensor
    takes ``ff_ln_plain``."""
    if not x.is_cuda:
        return ff_ln_plain(x, gamma, beta, wp, bp, wo, bo, eps)
    kernel = "ff_ln"
    c = x.shape[-1]
    inner = wo.shape[1]
    req = _build.require
    req(c % 64 == 0 and c <= FF_MAX_C and inner % 64 == 0, kernel,
        f"C={c} must be a multiple of 64 and <= {FF_MAX_C}, I={inner} of 64")
    req(wp.shape == (2 * inner, c) and wo.shape == (c, inner), kernel,
        "wp must be (2I, C) and wo (C, I)")
    for t in (x, wp, wo):
        req(t.is_cuda and t.dtype == torch.bfloat16, kernel,
            "x, wp and wo must be bf16 CUDA tensors")
    xc = x.reshape(-1, c).contiguous()
    wp, wo = wp.contiguous(), wo.contiguous()
    vecs = [_f32(v) for v in (gamma, beta, bp, bo)]
    out = torch.empty_like(xc)
    rc = _build.library().e2v_ff_ln(
        xc.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), wp.data_ptr(),
        vecs[2].data_ptr(), wo.data_ptr(), vecs[3].data_ptr(), out.data_ptr(),
        xc.shape[0], c, inner, float(eps), _build.stream_of(x))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out.reshape(x.shape)


def geglu_out(h2, w, b):
    """(h * gelu(g)) w^T + b with the gate fused into the GEMM. h2 (..., 2I),
    w (C, I), b (C). A CUDA tensor launches the kernel (bf16 h2/w,
    I % 32 == 0); a CPU tensor takes ``geglu_out_plain``."""
    if not h2.is_cuda:
        return geglu_out_plain(h2, w, b)
    kernel = "geglu_out"
    c, inner = w.shape
    req = _build.require
    req(h2.shape[-1] == 2 * inner and inner % 32 == 0, kernel,
        f"h2 must be (..., 2I) with I={inner} a multiple of 32")
    for t in (h2, w):
        req(t.is_cuda and t.dtype == torch.bfloat16, kernel,
            "h2 and w must be bf16 CUDA tensors")
    h2c = h2.reshape(-1, 2 * inner).contiguous()
    w = w.contiguous()
    bf = _f32(b)
    out = torch.empty((h2c.shape[0], c), dtype=h2.dtype, device=h2.device)
    rc = _build.library().e2v_geglu_out(
        h2c.data_ptr(), w.data_ptr(), bf.data_ptr(), out.data_ptr(),
        h2c.shape[0], inner, c, _build.stream_of(h2))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out.reshape(*h2.shape[:-1], c)


def feed_forward(x, gamma, beta, wp, bp, wo, bo, eps=1e-5):
    """x + FF(LN(x)), routed as the JAX package routes it (geglu.py:407-419):
    C <= 640 through ``ff_ln``; wider C with LN and the projection as torch
    ops (rounded as at geglu.py:411-417) and the gate + out GEMM through
    ``geglu_out``."""
    if x.shape[-1] <= FF_MAX_C:
        return ff_ln(x, gamma, beta, wp, bp, wo, bo, eps)
    xn = _layer_norm_f32(x, eps).to(x.dtype) * gamma + beta
    h2 = F.linear(xn, wp) + bp  # f32-accumulated GEMM, rounded to x.dtype
    return x + geglu_out(h2, wo, bo)
