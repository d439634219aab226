"""Packed multi-head attention: ``flash_attention_fwd`` (CUDA kernel 1) and
its plain PyTorch version.

Counterpart of ``eeg2video_tpu/ops/attention.py``: ``fused_attention_packed``
(one KV segment) and ``fused_attention_dual`` (sparse-causal [K0 | K_prev])
are one function here, because both compute one softmax over one or two KV
segments. Operands stay packed (., L, H*D) channels-minor, as the to_q/k/v
projections produce them; head h is columns h*D .. (h+1)*D.

Layouts: ``q`` is (N, Lq, H*D), or (b, m, Lq, H*D) for the two-segment
sparse-causal call (m query frames per batch element). ``k0``/``v0`` are
(b, Lkv0, H*D), shared by the m frames of batch element n // m. ``k1``/``v1``
are optional and per query group: (N, Lkv1, H*D) or (b, m, Lkv1, H*D).
``bias0`` is an optional (b, 1, Lkv0) additive bias on segment 0 only,
shared across heads and query rows. Any outer strides are accepted as long
as each row is H*D contiguous values, so frame slices of a (B, F, L, H*D)
projection go to the kernel without copies.
"""

from __future__ import annotations

import math

import torch

from . import _build

KERNEL = "flash_attention_fwd"


def _as4(t, m):
    """(N, L, C) -> (N//m, m, L, C) view; 4-D passes through."""
    if t.dim() == 4:
        return t
    return t.unflatten(0, (t.shape[0] // m, m))


def flash_attention_plain(q, k0, v0, heads, *, k1=None, v1=None, bias0=None,
                          scale=None):
    """The same function in plain PyTorch: materializes the KV concat and
    the (Lq, Lkv) probabilities, computes in f32, returns q's dtype."""
    m = q.shape[1] if q.dim() == 4 else 1
    q4 = _as4(q, m)
    b, _, lq, hd = q4.shape
    d = hd // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lkv0 = k0.shape[1]
    k = k0.float()[:, None].expand(b, m, lkv0, hd)
    v = v0.float()[:, None].expand(b, m, lkv0, hd)
    if k1 is not None:
        k = torch.cat([k, _as4(k1, m).float()], dim=2)
        v = torch.cat([v, _as4(v1, m).float()], dim=2)
    lkv = k.shape[2]

    def split(t, n):
        return t.reshape(b, m, n, heads, d).transpose(2, 3)  # (b, m, H, n, D)

    logits = split(q4.float(), lq) @ split(k, lkv).transpose(-1, -2) * scale
    if bias0 is not None:
        bias = bias0.float().reshape(b, 1, 1, 1, lkv0)
        logits[..., :lkv0] += bias
    out = torch.softmax(logits, dim=-1) @ split(v, lkv)  # (b, m, H, Lq, D)
    out = out.transpose(2, 3).reshape(b, m, lq, hd).to(q.dtype)
    return out if q.dim() == 4 else out.reshape(q.shape)


def flash_attention_fwd(q, k0, v0, heads, *, k1=None, v1=None, bias0=None,
                        scale=None, out=None):
    """softmax(scale q [K0 | K1]^T + [bias0 | 0]) [V0 | V1] per head.

    A CUDA tensor launches the kernel (bf16 operands); a CPU tensor takes
    ``flash_attention_plain``. ``out`` is an optional preallocated output
    (a view with q's shape and row layout) that receives the result."""
    if not q.is_cuda:
        res = flash_attention_plain(q, k0, v0, heads, k1=k1, v1=v1,
                                    bias0=bias0, scale=scale)
        return res if out is None else out.copy_(res)
    m = q.shape[1] if q.dim() == 4 else 1
    hd = q.shape[-1]
    d = hd // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q4 = _as4(q, m)
    b, _, lq, _ = q4.shape
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    o4 = _as4(out, m)
    k04, v04 = k0[:, None], v0[:, None]
    tensors = [q4, k04, v04, o4]
    if k1 is not None:
        k14, v14 = _as4(k1, m), _as4(v1, m)
        tensors += [k14, v14]
    req = _build.require
    req(heads * d == hd and d % 8 == 0 and d <= 160, KERNEL,
        f"head_dim {d} must be a multiple of 8 and <= 160")
    for t in tensors:
        req(t.is_cuda and t.dtype == torch.bfloat16, KERNEL,
            "operands must be bf16 CUDA tensors")
        req(t.shape[-1] == hd and t.stride(-1) == 1 and t.stride(-2) == hd,
            KERNEL, "rows must be H*D contiguous values")
        req(t.shape[0] == b and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
            and t.data_ptr() % 16 == 0, KERNEL,
            "outer strides must keep 16-byte row alignment")
    req(o4.shape == q4.shape, KERNEL, "out must have q's shape")
    if k1 is not None:
        req(k14.shape[:2] == (b, m) and v14.shape == k14.shape, KERNEL,
            "k1/v1 must be (b, m, Lkv1, H*D)")
    req(k0.shape[0] == b and v0.shape == k0.shape, KERNEL,
        "k0/v0 must be (b, Lkv0, H*D)")
    bias = None
    if bias0 is not None:
        bias = bias0.float().reshape(b, k0.shape[1]).contiguous()
    lib = _build.library()
    if k1 is None:
        seg1 = (None, 0, 0, None, 0, 0)
    else:
        seg1 = (k14.data_ptr(), k14.stride(0), k14.stride(1),
                v14.data_ptr(), v14.stride(0), v14.stride(1))
    rc = lib.e2v_flash_attention_fwd(
        q4.data_ptr(), q4.stride(0), q4.stride(1),
        k04.data_ptr(), k04.stride(0), v04.data_ptr(), v04.stride(0),
        *seg1, _build.ptr(bias), o4.data_ptr(), o4.stride(0), o4.stride(1),
        b * m, m, lq, k0.shape[1], 0 if k1 is None else k1.shape[-2],
        heads, d, float(scale), _build.stream_of(q))
    _build.check(rc, KERNEL)
    _build.launches[KERNEL] += 1
    return out
