"""Frame-axis attention: ``temporal_attention_fwd`` and
``temporal_attention_bwd`` (CUDA kernels), their plain PyTorch versions, and
the differentiable ``temporal_attention`` over both.

Counterpart of ``eeg2video_tpu/ops/temporal.py``. q, k, v are packed
(B, F, L, H*D), as the to_q/k/v projections of ``attn_temp`` produce them:
at each token and head, F x F attention over the frames. Nothing is
rearranged to (B*L, F, C).

bf16 operands launch the bf16 instantiation of the kernels
(``csrc/temporal_attention.cuh``, entries in ``temporal_attention.cu`` and
``temporal_attention_bwd.cu``), f32 ones their f32 instantiation (counted as
``temporal_attention_*_f32``): the JAX dispatch tests no dtype
(temporal.py:310), nor the head count, head dim or frame count
(temporal.py:310-319), and neither do the kernels: csrc/temporal_plan.cuh
picks their route from the shape.

Rounding: the kernels and the plain versions accumulate in f32 and round only
their outputs; the TPU kernel rounds q*k*scale and the probabilities to the
input dtype before its GEMMs, which the comparison tolerances allow for.
"""

from __future__ import annotations

import math

import torch

from . import _build, residuals

KERNEL_FWD = "temporal_attention_fwd"
KERNEL_BWD = "temporal_attention_bwd"
# A token's row is cut into units of about UNIT_BYTES holding whole heads on
# the kernels' staged route (csrc/temporal_plan.cuh, which also picks the
# route and refuses a call whose (token, head) does not fit shared memory).
UNIT_BYTES = 640


def units_of(heads, head_dim, itemsize):
    """(units a token's row is cut into, values of a unit, values a lane moves
    a step, steps a lane takes through a unit) on the staged route, as
    ``units_of`` in csrc/temporal_plan.cuh: a unit holds whole heads and a
    multiple of 32 values, at least UNIT_BYTES where the heads allow. Names
    the instantiation a shape takes (``temporal_fwd_kernel<F,VEC,ITERS,ELEM>``)."""
    hd = heads * head_dim
    units = 1
    while (heads % (2 * units) == 0 and (hd // 32) % (2 * units) == 0
           and hd * itemsize // (2 * units) >= UNIT_BYTES):
        units *= 2
    width = hd // units
    per_lane = width // 32
    vec = 2 if itemsize == 2 and per_lane % 2 == 0 else 1
    return units, width, vec, per_lane // vec


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


def _launch(kernel, tensors, n_out, heads, scale):
    """Check contiguous (B, F, L, H*D) CUDA operands of one dtype, bf16 or f32,
    and launch the entry point (``_f32`` for f32 operands, named and counted
    so). A call whose (token, head) does not fit a block's shared memory is
    refused by name (the entry returns ``_build.DOES_NOT_FIT`` before any
    launch)."""
    b, f, l, hd = tensors[0].shape
    dtype = tensors[0].dtype
    name = kernel + ("_f32" if dtype == torch.float32 else "")
    req = _build.require
    req(heads >= 1 and hd % heads == 0, name, f"heads={heads} must divide H*D={hd}")
    for t in tensors:
        req(t.is_cuda and t.dtype == dtype and dtype in (torch.bfloat16, torch.float32)
            and t.shape == (b, f, l, hd), name,
            "operands must be CUDA tensors of one dtype (bf16 or f32) and one "
            "(B, F, L, H*D) shape")
    req(f >= 1, name, "frames must be at least 1")
    # the staged route copies 16-byte pieces: contiguous rows at an aligned address
    ts = [_build.aligned16(t.contiguous()) for t in tensors]
    d = hd // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    outs = [torch.empty_like(ts[0]) for _ in range(n_out)]
    rc = getattr(_build.library(), f"e2v_{name}")(
        *(t.data_ptr() for t in ts), *(o.data_ptr() for o in outs), ts[0].stride(0),
        ts[0].stride(1), b, f, l, heads, d, float(scale), _build.stream_of(ts[0]))
    _build.check(rc, name)
    _build.launches[name] += 1
    return outs


def temporal_attention_fwd(q, k, v, heads, scale=None):
    """out[b, f, l, h] = sum_g softmax_g(scale q_f . k_g) v_g over the frames.
    A CUDA tensor launches the kernel (bf16 or f32; any heads dividing H*D,
    any F); a CPU tensor takes ``temporal_attention_plain``. A call whose
    3 F D values of one head do not fit a block's shared memory is refused by
    name."""
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, heads, scale)
    return _launch(KERNEL_FWD, (q, k, v), 1, heads, scale)[0]


def temporal_attention_bwd(q, k, v, dout, heads, scale=None):
    """(dq, dk, dv) of ``temporal_attention_fwd`` from its operands and the
    output's gradient (the probabilities are recomputed). A CUDA tensor
    launches the kernel; a CPU tensor takes ``temporal_attention_bwd_plain``.
    A call whose 4 F D values of one head, with two F x F rows of floats,
    do not fit a block's shared memory is refused by name."""
    if not q.is_cuda:
        return temporal_attention_bwd_plain(q, k, v, dout, heads, scale)
    return tuple(_launch(KERNEL_BWD, (q, k, v, dout), 3, heads, scale))


class _TemporalAttention(torch.autograd.Function):
    """The forward kernel, whose output is a ``flash_out`` residual of a
    recomputed block (JAX names it so, ops/temporal.py:329), and the backward
    kernel behind it."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return residuals.forward(residuals.FLASH_OUT, KERNEL_FWD,
                                 lambda: temporal_attention_fwd(q, k, v, heads, scale))

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*temporal_attention_bwd(q, k, v, dout, ctx.heads, ctx.scale), None, None)


def temporal_attention(q, k, v, heads, scale=None):
    """Differentiable frame-axis attention through the two kernels."""
    return _TemporalAttention.apply(q, k, v, heads, scale)
