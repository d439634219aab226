"""GEGLU feed-forward: ``ff_ln`` and ``geglu_out`` (CUDA kernels), their
backwards ``ff_ln_bwd`` and ``geglu_out_bwd`` (CUDA kernels), the plain
PyTorch version of each, and the differentiable ``feed_forward`` router.

Counterpart of ``eeg2video_tpu/ops/geglu.py``. Weights are in nn.Linear
layout: ``wp`` (2I, C) and ``wo`` (C, I). Rounding follows the Pallas
kernels: LN in f32, xn cast to the weight dtype before the first GEMM, h2
f32 up to the gate, the gated product cast to the weight dtype before the
second GEMM, bias and residual added in f32; in the backwards dgated and the
gate's derivative in f32, dh2 cast to the weight dtype before its GEMM.

The backward kernels give the input gradient only. Parameter gradients are
plain PyTorch (autograd through the plain forward), formed only for the
parameters that ask for one: none under the fine-tune's freeze rule.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

FF_MAX_C = 640  # C <= 640 runs the whole block in ff_ln (geglu.py:407)
# csrc/geglu_out.cu: a row block of GEGLU_ROWS rows is a cluster of blocks
# along C that share its gate and h2; I is walked in GEGLU_CHUNK-column chunks
GEGLU_ROWS, GEGLU_CHUNK = 64, 64


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


def _gelu_and_grad(g):
    """(gelu(g), gelu'(g)) of the exact erf gelu: g Phi(g), Phi(g) + g phi(g)."""
    big_phi = 0.5 * (1.0 + torch.erf(g * math.sqrt(0.5)))
    return g * big_phi, big_phi + g * torch.exp(-0.5 * g * g) / math.sqrt(2.0 * math.pi)


def _gate_bwd(h2, dgated, inner, dtype):
    """dh2 = [dgated gelu(gate) | dgated h gelu'(gate)], f32 in, ``dtype`` out."""
    h, gate = h2[..., :inner], h2[..., inner:]
    gelu, dgelu = _gelu_and_grad(gate)
    return torch.cat([dgated * gelu, dgated * h * dgelu], dim=-1).to(dtype)


def ff_ln_bwd_plain(x, g, gamma, beta, wp, bp, wo, eps=1e-5):
    """dx of ``ff_ln`` as a written-out formula (the kernel's steps in f32,
    rounded where it rounds): everything recomputed from (x, g)."""
    inner = wo.shape[1]
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    xn = (xhat * gamma.float() + beta.float()).to(wp.dtype)
    h2 = xn.float() @ wp.float().t() + bp.float()
    dh2 = _gate_bwd(h2, g.float() @ wo.float(), inner, wp.dtype)
    dxn = (dh2.float() @ wp.float()) * gamma.float()
    m1 = dxn.mean(dim=-1, keepdim=True)
    m2 = (dxn * xhat).mean(dim=-1, keepdim=True)
    return (g.float() + rstd * (dxn - m1 - xhat * m2)).to(x.dtype)


def geglu_out_bwd_plain(h2, g, w):
    """dh2 of ``geglu_out`` as a written-out formula, f32 inside."""
    return _gate_bwd(h2.float(), g.float() @ w.float(), w.shape[1], h2.dtype)


def _f32(t):
    return t.float().contiguous()


def _aligned16(t):
    """``t`` (contiguous) at a 16-byte aligned address: a copy where a view's
    offset puts it elsewhere (the kernel reads it in 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _param_grads(plain, inputs, params, needs, g):
    """Gradients of ``plain(*inputs, *params)`` for the parameters whose
    ``needs`` flag is set (None for the others): autograd through the plain
    forward, the counterpart of the JAX package's separate XLA ops."""
    if not any(needs):
        return [None] * len(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(n) for p, n in zip(params, needs)]
        out = plain(*[t.detach() for t in inputs], *leaves)
        wanted = [p for p, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
    return [next(grads) if n else None for n in needs]


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
    xc = _aligned16(x.reshape(-1, c).contiguous())
    wp, wo = _aligned16(wp.contiguous()), _aligned16(wo.contiguous())
    vecs = [_aligned16(_f32(v)) for v in (gamma, beta, bp, bo)]
    out = torch.empty_like(xc)
    rc = _build.library().e2v_ff_ln(
        xc.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), wp.data_ptr(),
        vecs[2].data_ptr(), wo.data_ptr(), vecs[3].data_ptr(), out.data_ptr(),
        xc.shape[0], c, inner, float(eps), _build.stream_of(x))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out.reshape(x.shape)


def ff_ln_bwd(x, g, gamma, beta, wp, bp, wo, eps=1e-5):
    """dx of ``ff_ln`` from its input x and the output's gradient g. A CUDA
    tensor launches the kernel (same shape rules as ``ff_ln``); a CPU tensor
    takes ``ff_ln_bwd_plain``."""
    if not x.is_cuda:
        return ff_ln_bwd_plain(x, g, gamma, beta, wp, bp, wo, eps)
    kernel = "ff_ln_bwd"
    c = x.shape[-1]
    inner = wo.shape[1]
    req = _build.require
    req(c % 64 == 0 and c <= FF_MAX_C and inner % 64 == 0, kernel,
        f"C={c} must be a multiple of 64 and <= {FF_MAX_C}, I={inner} of 64")
    req(wp.shape == (2 * inner, c) and wo.shape == (c, inner) and g.shape == x.shape,
        kernel, "wp must be (2I, C), wo (C, I) and g shaped as x")
    for t in (x, g, wp, wo):
        req(t.is_cuda and t.dtype == torch.bfloat16, kernel,
            "x, g, wp and wo must be bf16 CUDA tensors")
    xc = _aligned16(x.reshape(-1, c).contiguous())
    gc = _aligned16(g.reshape(-1, c).contiguous())
    wp, wo = _aligned16(wp.contiguous()), _aligned16(wo.contiguous())
    vecs = [_aligned16(_f32(v)) for v in (gamma, beta, bp)]
    dx = torch.empty_like(xc)
    rc = _build.library().e2v_ff_ln_bwd(
        xc.data_ptr(), gc.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        wp.data_ptr(), vecs[2].data_ptr(), wo.data_ptr(), dx.data_ptr(),
        xc.shape[0], c, inner, float(eps), _build.stream_of(x))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return dx.reshape(x.shape)


def geglu_out_l2_read_bytes(t, inner, c):
    """Bytes the kernel's blocks copy from L2 in one call, from the tiling:
    the blocks of a row block read each row of w (I bf16) and each bias value
    (f32) once between them, each its own output columns (the tensor map fills
    rows past C with zeros), and each of the row block's rows of h2 below T
    (2I bf16) once between them, sending the gated rows to one another in
    shared memory."""
    return -(-t // GEGLU_ROWS) * c * (inner * 2 + 4) + t * 2 * inner * 2


def geglu_out(h2, w, b):
    """(h * gelu(g)) w^T + b with the gate fused into the GEMM. h2 (..., 2I),
    w (C, I), b (C). A CUDA tensor launches the kernel (bf16 h2/w,
    I % 64 == 0, C % 8 == 0); a CPU tensor takes ``geglu_out_plain``."""
    if not h2.is_cuda:
        return geglu_out_plain(h2, w, b)
    kernel = "geglu_out"
    c, inner = w.shape
    req = _build.require
    req(h2.shape[-1] == 2 * inner and inner % GEGLU_CHUNK == 0 and inner > 0, kernel,
        f"h2 must be (..., 2I) with I={inner} a multiple of {GEGLU_CHUNK}")
    req(c % 8 == 0 and c > 0, kernel, f"C={c} must be a multiple of 8")
    for t in (h2, w):
        req(t.is_cuda and t.dtype == torch.bfloat16, kernel,
            "h2 and w must be bf16 CUDA tensors")
    h2c = _aligned16(h2.reshape(-1, 2 * inner).contiguous())
    w = _aligned16(w.contiguous())
    bf = _f32(b)
    out = torch.empty((h2c.shape[0], c), dtype=h2.dtype, device=h2.device)
    rc = _build.library().e2v_geglu_out(
        h2c.data_ptr(), w.data_ptr(), bf.data_ptr(), out.data_ptr(),
        h2c.shape[0], inner, c, _build.stream_of(h2))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out.reshape(*h2.shape[:-1], c)


def geglu_out_bwd(h2, g, w):
    """dh2 of ``geglu_out`` from its input h2 and the output's gradient g
    (..., C). A CUDA tensor launches the kernel (bf16, C % 32 == 0,
    I % 8 == 0); a CPU tensor takes ``geglu_out_bwd_plain``."""
    if not h2.is_cuda:
        return geglu_out_bwd_plain(h2, g, w)
    kernel = "geglu_out_bwd"
    c, inner = w.shape
    req = _build.require
    req(h2.shape[-1] == 2 * inner and inner % 8 == 0 and c % 32 == 0, kernel,
        f"h2 must be (..., 2I) with I={inner} a multiple of 8 and C={c} of 32")
    req(g.shape == (*h2.shape[:-1], c), kernel, "g must be (..., C)")
    for t in (h2, g, w):
        req(t.is_cuda and t.dtype == torch.bfloat16, kernel,
            "h2, g and w must be bf16 CUDA tensors")
    h2c, gc = h2.reshape(-1, 2 * inner).contiguous(), g.reshape(-1, c).contiguous()
    w = w.contiguous()
    dh2 = torch.empty_like(h2c)
    rc = _build.library().e2v_geglu_out_bwd(
        h2c.data_ptr(), gc.data_ptr(), w.data_ptr(), dh2.data_ptr(), h2c.shape[0], inner, c,
        _build.stream_of(h2))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return dh2.reshape(h2.shape)


class _FFLn(torch.autograd.Function):
    """``ff_ln`` with ``ff_ln_bwd`` behind for dx."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wp, bp, wo, bo, eps):
        ctx.save_for_backward(x, gamma, beta, wp, bp, wo, bo)
        ctx.eps = eps
        return ff_ln(x, gamma, beta, wp, bp, wo, bo, eps)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = ff_ln_bwd(x, g, *params[:-1], ctx.eps)
        grads = _param_grads(lambda x_, *p: ff_ln_plain(x_, *p, ctx.eps), [x], params,
                             ctx.needs_input_grad[1:7], g)
        return (dx, *grads, None)


class _GegluOut(torch.autograd.Function):
    """``geglu_out`` with ``geglu_out_bwd`` behind for dh2."""

    @staticmethod
    def forward(ctx, h2, w, b):
        ctx.save_for_backward(h2, w, b)
        return geglu_out(h2, w, b)

    @staticmethod
    def backward(ctx, g):
        h2, w, b = ctx.saved_tensors
        dh2 = geglu_out_bwd(h2, g, w) if ctx.needs_input_grad[0] else None
        grads = _param_grads(geglu_out_plain, [h2], [w, b], ctx.needs_input_grad[1:3], g)
        return (dh2, *grads)


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ff_ln_function(x, gamma, beta, wp, bp, wo, bo, eps=1e-5):
    """Differentiable ``ff_ln``."""
    return _FFLn.apply(x, gamma, beta, wp, bp, wo, bo, eps)


def geglu_out_function(h2, w, b):
    """Differentiable ``geglu_out``."""
    return _GegluOut.apply(h2, w, b)


def feed_forward(x, gamma, beta, wp, bp, wo, bo, eps=1e-5):
    """x + FF(LN(x)), routed as the JAX package routes it (geglu.py:407-419):
    C <= 640 through ``ff_ln``; wider C with LN and the projection as torch
    ops (rounded as at geglu.py:411-417) and the gate + out GEMM through
    ``geglu_out``. Where an operand asks for a gradient the kernels run
    behind their ``autograd.Function``s, with the backward kernels."""
    grad = _wants_grad(x, gamma, beta, wp, bp, wo, bo)
    if x.shape[-1] <= FF_MAX_C:
        return (ff_ln_function if grad else ff_ln)(x, gamma, beta, wp, bp, wo, bo, eps)
    xn = _layer_norm_f32(x, eps).to(x.dtype) * gamma + beta
    h2 = F.linear(xn, wp) + bp  # f32-accumulated GEMM, rounded to x.dtype
    return x + (geglu_out_function if grad else geglu_out)(h2, wo, bo)
