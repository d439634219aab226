"""Frame-axis attention: ``temporal_attention_fwd`` and
``temporal_attention_bwd`` (CUDA kernels), their plain PyTorch versions, and
the differentiable ``temporal_attention`` over both.

Counterpart of ``eeg2video_tpu/ops/temporal.py``. q, k, v are packed
(B, F, L, H*D), as the to_q/k/v projections of ``attn_temp`` produce them:
at each token and head, F x F attention over the frames. Nothing is
rearranged to (B*L, F, C).

bf16 operands launch the bf16 instantiation of ``csrc/temporal_attention.cu``,
f32 ones its f32 instantiation (counted as ``temporal_attention_*_f32``): the
JAX dispatch tests no dtype (temporal.py:310).

Rounding: the kernels and the plain versions accumulate in f32 and round only
their outputs; the TPU kernel rounds q*k*scale and the probabilities to the
input dtype before its GEMMs, which the comparison tolerances allow for.
"""

from __future__ import annotations

import math

import torch

from . import _build

KERNEL_FWD = "temporal_attention_fwd"
KERNEL_BWD = "temporal_attention_bwd"
MAX_FRAMES = 8  # csrc/temporal_attention.cu instantiates F = 1..8


def _split(t, heads):
    b, f, l, hd = t.shape
    return t.reshape(b, f, l, heads, hd // heads).float()


def _probs(q, k, heads, scale):
    logits = torch.einsum("bflhd,bglhd->blhfg", _split(q, heads), _split(k, heads))
    return torch.softmax(logits * scale, dim=-1)


def temporal_attention_plain(q, k, v, heads, scale=None):
    """The same function in plain PyTorch, f32 inside, q's dtype out."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    out = torch.einsum("blhfg,bglhd->bflhd", _probs(q, k, heads, scale), _split(v, heads))
    return out.reshape(q.shape).to(q.dtype)


def temporal_attention_bwd_plain(q, k, v, dout, heads, scale=None):
    """The backward's written-out formula in plain PyTorch, f32 inside: p
    recomputed, dp = dout . v, dl = p (dp - sum_g p dp) scale, then dq, dk,
    dv. Returns (dq, dk, dv) in the operands' dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    p = _probs(q, k, heads, scale)
    qs, ks, vs, dos = (_split(t, heads) for t in (q, k, v, dout))
    dp = torch.einsum("bflhd,bglhd->blhfg", dos, vs)
    dl = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    dq = torch.einsum("blhfg,bglhd->bflhd", dl, ks)
    dk = torch.einsum("blhfg,bflhd->bglhd", dl, qs)
    dv = torch.einsum("blhfg,bflhd->bglhd", p, dos)
    return tuple(t.reshape(q.shape).to(q.dtype) for t in (dq, dk, dv))


def _checked(kernel, tensors, heads):
    """Contiguous (B, F, L, H*D) operands of one dtype, bf16 or f32, and the
    kernel's head rules; the kernel's counter name (``_f32`` for f32)."""
    b, f, l, hd = tensors[0].shape
    d = hd // heads
    req = _build.require
    req(heads * d == hd and 32 % heads == 0 and d % (32 // heads) == 0, kernel,
        f"heads={heads} must divide 32 and head_dim={d} be a multiple of 32/heads")
    req(1 <= f <= MAX_FRAMES, kernel, f"frames={f} must be in [1, {MAX_FRAMES}]")
    out = []
    dtype = tensors[0].dtype
    for t in tensors:
        req(t.is_cuda and t.dtype == dtype and dtype in (torch.bfloat16, torch.float32)
            and t.shape == (b, f, l, hd), kernel,
            "operands must be CUDA tensors of one dtype (bf16 or f32) and one "
            "(B, F, L, H*D) shape")
        out.append(t.contiguous())
    return out, (b, f, l, d), kernel + ("_f32" if dtype == torch.float32 else "")


def temporal_attention_fwd(q, k, v, heads, scale=None):
    """out[b, f, l, h] = sum_g softmax_g(scale q_f . k_g) v_g over the frames.
    A CUDA tensor launches the kernel (bf16 or f32); a CPU tensor takes
    ``temporal_attention_plain``."""
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, heads, scale)
    (q, k, v), (b, f, l, d), kernel = _checked(KERNEL_FWD, (q, k, v), heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rc = getattr(_build.library(), f"e2v_{kernel}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.stride(0), q.stride(1),
        b, f, l, heads, d, float(scale), _build.stream_of(q))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out


def temporal_attention_bwd(q, k, v, dout, heads, scale=None):
    """(dq, dk, dv) of ``temporal_attention_fwd`` from its operands and the
    output's gradient (the probabilities are recomputed). A CUDA tensor
    launches the kernel; a CPU tensor takes ``temporal_attention_bwd_plain``."""
    if not q.is_cuda:
        return temporal_attention_bwd_plain(q, k, v, dout, heads, scale)
    (q, k, v, dout), (b, f, l, d), kernel = _checked(KERNEL_BWD, (q, k, v, dout), heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    rc = getattr(_build.library(), f"e2v_{kernel}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), q.stride(0), q.stride(1), b, f, l, heads, d,
        float(scale), _build.stream_of(q))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return dq, dk, dv


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return temporal_attention_fwd(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*temporal_attention_bwd(q, k, v, dout, ctx.heads, ctx.scale), None, None)


def temporal_attention(q, k, v, heads, scale=None):
    """Differentiable frame-axis attention through the two kernels."""
    return _TemporalAttention.apply(q, k, v, heads, scale)
