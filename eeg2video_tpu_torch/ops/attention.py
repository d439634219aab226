"""Multi-head attention. Packed operands: ``flash_attention_fwd`` and
``flash_attention_bwd`` (CUDA kernels), their plain PyTorch versions, and the
differentiable ``flash_attention`` over both. Head-major (B, H, L, D)
operands: ``fused_attention_fwd`` / ``fused_attention_bwd``, their plain
versions and the differentiable ``fused_attention`` (at the end of the file).

Counterpart of ``eeg2video_tpu/ops/attention.py``: ``fused_attention_packed``
(one KV segment) and ``fused_attention_dual`` (sparse-causal [K0 | K_prev])
are one function here, because both compute one softmax over one or two KV
segments. Operands stay packed (., L, H*D) channels-minor, as the to_q/k/v
projections produce them; head h is columns h*D .. (h+1)*D.

Each wrapper launches the bf16 kernels on bf16 operands and their f32
counterparts (``csrc/flash_f32*.cu``, counted under the ``_f32`` names) on
f32 ones: the JAX package's attention dispatch has no dtype test
(attention.py:1709, :840), so it runs its Pallas kernels at f32 too.

Layouts: ``q`` is (N, Lq, H*D), or (b, m, Lq, H*D) when m query groups share
one K0/V0 (the sparse-causal calls: m frames per batch element). ``k0``/``v0``
are (b, Lkv0, H*D), shared by the m groups of batch element n // m.
``k1``/``v1`` are optional and per query group: (N, Lkv1, H*D) or
(b, m, Lkv1, H*D). ``bias0`` is an optional (b, 1, Lkv0) additive bias on
segment 0 only, shared across heads and query rows. Any outer strides are
accepted as long as each row is H*D contiguous values, so frame slices of a
(B, F, L, H*D) projection go to the kernels without copies.

The backward takes what the forward saved (q, k, v, out and the row
log-sum-exp ``lse`` (N, H, Lq), f32, natural log) and returns dq, dk0, dv0
(summed over the m groups that shared K0/V0) and dk1, dv1. A bias is used in
the score recompute; with ``need_dbias`` its own gradient comes back too:
dbias0 = the sum over the m groups, the heads and the query rows of
p * (dout v^T - delta) on segment 0's columns (ds before the scale factor),
in bias0's shape and dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

KERNEL = "flash_attention_fwd"
KERNEL_BWD = "flash_attention_bwd"
KERNEL_BWD_DBIAS = "flash_attention_bwd_dbias"  # the launches of it that write dbias0
KERNEL_BHLD = "fused_attention_fwd"
KERNEL_BHLD_BWD = "fused_attention_bwd"
# The kernels take head dims up to 160 (the model's are 40, 80 and 160); the
# JAX kernels have no such limit, and a wider head is refused by name
MAX_HEAD_DIM = 160


def _as4(t, m):
    """(N, L, C) -> (N//m, m, L, C) view; 4-D passes through."""
    if t.dim() == 4:
        return t
    return t.unflatten(0, (t.shape[0] // m, m))


def _groups(q):
    return q.shape[1] if q.dim() == 4 else 1


def _heads_split(t, heads):
    """(b, m, n, H*D) -> (b, m, H, n, D)"""
    b, m, n, hd = t.shape
    return t.reshape(b, m, n, heads, hd // heads).transpose(2, 3)


def _plain_logits(q4, k0, k1, heads, bias0, scale):
    """f32 logits (b, m, H, Lq, Lkv0 + Lkv1) and the concatenated keys."""
    b, m, _, hd = q4.shape
    lkv0 = k0.shape[1]
    k = k0.float()[:, None].expand(b, m, lkv0, hd)
    if k1 is not None:
        k = torch.cat([k, _as4(k1, m).float()], dim=2)
    logits = _heads_split(q4.float(), heads) @ _heads_split(k, heads).transpose(-1, -2) * scale
    if bias0 is not None:
        logits[..., :lkv0] += bias0.float().reshape(b, 1, 1, 1, lkv0)
    return logits, k


def flash_attention_plain(q, k0, v0, heads, *, k1=None, v1=None, bias0=None,
                          scale=None, return_lse=False):
    """The same function in plain PyTorch: materializes the KV concat and
    the (Lq, Lkv) probabilities, computes in f32, returns q's dtype (and,
    with ``return_lse``, the f32 (N, H, Lq) log-sum-exp of the logits)."""
    m = _groups(q)
    q4 = _as4(q, m)
    b, _, lq, hd = q4.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd // heads)
    logits, _ = _plain_logits(q4, k0, k1, heads, bias0, scale)
    v = v0.float()[:, None].expand(b, m, v0.shape[1], hd)
    if v1 is not None:
        v = torch.cat([v, _as4(v1, m).float()], dim=2)
    out = torch.softmax(logits, dim=-1) @ _heads_split(v, heads)  # (b, m, H, Lq, D)
    out = out.transpose(2, 3).reshape(b, m, lq, hd).to(q.dtype)
    out = out if q.dim() == 4 else out.reshape(q.shape)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(b * m, heads, lq)
    return out


def flash_attention_bwd_plain(q, k0, v0, heads, dout, out, lse, *, k1=None,
                              v1=None, bias0=None, scale=None, need_dbias=False):
    """The backward's written-out formula in plain PyTorch, f32, from the
    same residuals the kernel takes: p = exp(logits - lse), delta =
    rowsum(dout * out), dv = p^T dout, ds = p (dout v^T - delta) scale,
    dq = ds k, dk = ds^T q; dk0/dv0 summed over the m groups; dbias0 = ds /
    scale summed over the m groups, heads and query rows on segment 0's
    columns. Returns (dq, dk0, dv0, dk1, dv1, dbias0) in the operands' dtype
    and shapes (dk1, dv1 None without segment 1, dbias0 None unless
    ``need_dbias``)."""
    m = _groups(q)
    q4 = _as4(q, m)
    b, _, lq, hd = q4.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd // heads)
    lkv0 = k0.shape[1]
    logits, k = _plain_logits(q4, k0, k1, heads, bias0, scale)
    v = v0.float()[:, None].expand(b, m, lkv0, hd)
    if v1 is not None:
        v = torch.cat([v, _as4(v1, m).float()], dim=2)
    p = torch.exp(logits - lse.float().reshape(b, m, heads, lq, 1))
    qh, kh, vh = (_heads_split(t, heads) for t in (q4.float(), k, v))
    doh = _heads_split(_as4(dout, m).float(), heads)
    delta = (doh * _heads_split(_as4(out, m).float(), heads)).sum(dim=-1, keepdim=True)
    ds_nat = p * (doh @ vh.transpose(-1, -2) - delta)
    ds = ds_nat * scale
    dbias0 = None
    if need_dbias:
        dbias0 = ds_nat[..., :lkv0].sum(dim=(1, 2, 3)).to(bias0.dtype).reshape(bias0.shape)

    def merge(t):  # (b, m, H, n, D) -> (b, m, n, H*D)
        return t.transpose(2, 3).reshape(b, m, t.shape[3], hd)

    dq = merge(ds @ kh).to(q.dtype).reshape(q.shape)
    dk, dv = merge(ds.transpose(-1, -2) @ qh), merge(p.transpose(-1, -2) @ doh)
    dk0, dv0 = (t[:, :, :lkv0].sum(dim=1).to(k0.dtype) for t in (dk, dv))
    if k1 is None:
        return dq, dk0, dv0, None, None, dbias0
    dk1, dv1 = (t[:, :, lkv0:].to(k1.dtype).reshape(k1.shape) for t in (dk, dv))
    return dq, dk0, dv0, dk1, dv1, dbias0


def _kernel_views(kernel, q, k0, v0, k1, v1, heads, extra=()):
    """4-D views of the operands for the kernels, after the layout checks.
    ``extra``: more tensors with q's shape (out, dout) to view and check."""
    m = _groups(q)
    hd = q.shape[-1]
    d = hd // heads
    q4 = _as4(q, m)
    b, _, lq, _ = q4.shape
    k04, v04 = k0[:, None], v0[:, None]
    like_q = [_as4(t, m) for t in extra]
    tensors = [q4, k04, v04, *like_q]
    k14 = v14 = None
    if k1 is not None:
        k14, v14 = _as4(k1, m), _as4(v1, m)
        tensors += [k14, v14]
    req = _build.require
    req(heads * d == hd and d % 8 == 0 and d <= MAX_HEAD_DIM, kernel,
        f"head_dim {d} must be a multiple of 8 and <= {MAX_HEAD_DIM}")
    bf16 = q.dtype == torch.bfloat16
    for t in tensors:
        req(t.is_cuda and t.dtype == q.dtype and q.dtype in (torch.bfloat16, torch.float32),
            kernel, "operands must be CUDA tensors of one dtype, bf16 or f32")
        req(t.shape[-1] == hd and t.stride(-1) == 1 and t.stride(-2) == hd,
            kernel, "rows must be H*D contiguous values")
        # the bf16 kernels read rows as 16-byte vectors
        req(t.shape[0] == b and (not bf16 or (t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
                                              and t.data_ptr() % 16 == 0)), kernel,
            "outer strides must keep 16-byte row alignment")
    for t in like_q:
        req(t.shape == q4.shape, kernel, "out and dout must have q's shape")
    if k1 is not None:
        req(k14.shape[:2] == (b, m) and v14.shape == k14.shape, kernel,
            "k1/v1 must be (b, m, Lkv1, H*D)")
    req(k0.shape[0] == b and v0.shape == k0.shape, kernel,
        "k0/v0 must be (b, Lkv0, H*D)")
    return m, b, lq, d, q4, k04, v04, k14, v14, like_q


def _bias_rows(bias0, b, lkv0):
    return None if bias0 is None else bias0.float().reshape(b, lkv0).contiguous()


def _packed_strides(t4, d):
    """(sb, sg, sh, sr) of a (b, m, L, H*D) view for the f32 kernels."""
    return [t4.stride(0), t4.stride(1), d, t4.stride(2)]


def _shared_strides(t, d):
    """(sb, sg, sh, sr) of a (b, L, H*D) K0 / V0 / dK0 / dV0 shared by the
    m query groups of a batch element."""
    return [t.stride(0), 0, d, t.stride(1)]


def _f32_launch(entry, kernel, ptrs, strides, dims, scale, like):
    """Call an f32 attention entry point with its pointer, stride and dim
    arrays; count the launch."""
    rc = getattr(_build.library(), entry)(
        (ctypes.c_void_p * len(ptrs))(*[_build.ptr(t) for t in ptrs]),
        (ctypes.c_longlong * len(strides))(*strides),
        (ctypes.c_int * len(dims))(*dims), float(scale), _build.stream_of(like))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1


def flash_attention_fwd(q, k0, v0, heads, *, k1=None, v1=None, bias0=None,
                        scale=None, out=None, return_lse=False):
    """softmax(scale q [K0 | K1]^T + [bias0 | 0]) [V0 | V1] per head.

    A CUDA tensor launches the kernel (bf16 operands, or the f32 kernel on
    f32 ones); a CPU tensor takes ``flash_attention_plain``. ``out`` is an optional preallocated output
    (a view with q's shape and row layout) that receives the result. With
    ``return_lse`` the f32 (N, H, Lq) row log-sum-exp comes back as well."""
    if not q.is_cuda:
        res = flash_attention_plain(q, k0, v0, heads, k1=k1, v1=v1, bias0=bias0,
                                    scale=scale, return_lse=return_lse)
        if out is None:
            return res
        return (out.copy_(res[0]), res[1]) if return_lse else out.copy_(res)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    m, b, lq, d, q4, k04, v04, k14, v14, (o4,) = _kernel_views(
        KERNEL, q, k0, v0, k1, v1, heads, extra=(out,))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bias = _bias_rows(bias0, b, k0.shape[1])
    lse = (torch.empty((b * m, heads, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lkv1 = 0 if k1 is None else k1.shape[-2]
    if q.dtype == torch.float32:
        none = [0, 0, 0, 0]
        strides = [*_packed_strides(q4, d), *_shared_strides(k0, d), *_shared_strides(v0, d),
                   *(none if k1 is None else _packed_strides(k14, d)),
                   *(none if k1 is None else _packed_strides(v14, d)),
                   *_packed_strides(o4, d)]
        _f32_launch("e2v_flash_f32_fwd", KERNEL + "_f32", [q4, k0, v0, k14, v14, o4, bias, lse],
                    strides, [b * m, m, lq, k0.shape[1], lkv1, heads, d], scale, q)
        return (out, lse) if return_lse else out
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
        b * m, m, lq, k0.shape[1], lkv1, heads, d, float(scale), _build.ptr(lse),
        _build.stream_of(q))
    _build.check(rc, KERNEL)
    _build.launches[KERNEL] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k0, v0, heads, dout, out, lse, *, k1=None, v1=None,
                        bias0=None, scale=None, need_dbias=False):
    """(dq, dk0, dv0, dk1, dv1, dbias0) of ``flash_attention_fwd`` from its
    operands, its output, its ``lse`` and the output's gradient; dbias0 is
    None unless ``need_dbias``. A CUDA tensor launches the kernel (bf16 or f32
    operands, f32 lse); a CPU tensor takes ``flash_attention_bwd_plain``."""
    if need_dbias and bias0 is None:
        raise ValueError("flash_attention_bwd: need_dbias without a bias0")
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                         bias0=bias0, scale=scale, need_dbias=need_dbias)
    if dout.stride(-1) != 1 or dout.stride(-2) != dout.shape[-1]:
        dout = dout.contiguous()
    m, b, lq, d, q4, k04, v04, k14, v14, (do4, o4) = _kernel_views(
        KERNEL_BWD, q, k0, v0, k1, v1, heads, extra=(dout, out))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n = b * m
    req = _build.require
    req(lse.is_cuda and lse.dtype == torch.float32 and lse.shape == (n, heads, lq)
        and lse.is_contiguous(), KERNEL_BWD, "lse must be a contiguous f32 (N, H, Lq)")
    bias = _bias_rows(bias0, b, k0.shape[1])
    dev = q.device
    delta = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk0, dv0 = torch.empty_like(k0, memory_format=torch.contiguous_format), \
        torch.empty_like(v0, memory_format=torch.contiguous_format)
    dk1 = dv1 = None
    if k1 is not None:
        dk1 = torch.empty(k1.shape, dtype=k1.dtype, device=dev)
        dv1 = torch.empty(v1.shape, dtype=v1.dtype, device=dev)
    # dbias0: per-head partials (b, H, Lkv0) from the segment-0 dkv pass,
    # added in head order by a short third pass into (b, Lkv0), both f32
    dbias_part = dbias = None
    if need_dbias:
        dbias_part = torch.empty((b, heads, k0.shape[1]), dtype=torch.float32, device=dev)
        dbias = torch.empty((b, k0.shape[1]), dtype=torch.float32, device=dev)
    if q.dtype == torch.float32:
        none = [0, 0, 0, 0]
        seg1 = lambda t: none if t is None else _packed_strides(_as4(t, m), d)  # noqa: E731
        tens = [(q4, _packed_strides(q4, d)), (k0, _shared_strides(k0, d)),
                (v0, _shared_strides(v0, d)), (k14, seg1(k14)), (v14, seg1(v14)),
                (do4, _packed_strides(do4, d)), (o4, _packed_strides(o4, d)),
                (dq, _packed_strides(_as4(dq, m), d)), (dk0, _shared_strides(dk0, d)),
                (dv0, _shared_strides(dv0, d)), (dk1, seg1(dk1)), (dv1, seg1(dv1))]
        _f32_launch("e2v_flash_f32_bwd", KERNEL_BWD + "_f32",
                    [t for t, _ in tens] + [lse, delta, bias, dbias_part, dbias],
                    [x for _, st in tens for x in st],
                    [n, m, lq, k0.shape[1], 0 if k1 is None else k1.shape[-2], heads, d],
                    scale, q)
        if need_dbias:
            _build.launches[KERNEL_BWD_DBIAS + "_f32"] += 1
            dbias = dbias.to(bias0.dtype).reshape(bias0.shape)
        return dq, dk0, dv0, dk1, dv1, dbias
    ptrs = [q4, k04, v04, k14, v14, do4, o4, lse, bias, delta, dq, dk0, dv0, dk1, dv1,
            dbias_part, dbias]
    strides = [q4.stride(0), q4.stride(1), do4.stride(0), do4.stride(1),
               o4.stride(0), o4.stride(1), k04.stride(0), v04.stride(0)]
    strides += [0, 0, 0, 0] if k1 is None else [k14.stride(0), k14.stride(1),
                                                v14.stride(0), v14.stride(1)]
    dims = [n, m, lq, k0.shape[1], 0 if k1 is None else k1.shape[-2], heads, d]
    rc = _build.library().e2v_flash_attention_bwd(
        (ctypes.c_void_p * len(ptrs))(*[_build.ptr(t) for t in ptrs]),
        (ctypes.c_longlong * len(strides))(*strides),
        (ctypes.c_int * len(dims))(*dims), float(scale), _build.stream_of(q))
    _build.check(rc, KERNEL_BWD)
    _build.launches[KERNEL_BWD] += 1
    if need_dbias:
        _build.launches[KERNEL_BWD_DBIAS] += 1
        dbias = dbias.to(bias0.dtype).reshape(bias0.shape)
    return dq, dk0, dv0, dk1, dv1, dbias


class _FlashAttention(torch.autograd.Function):
    """``flash_attention_fwd`` with lse saved, ``flash_attention_bwd`` behind."""

    @staticmethod
    def forward(ctx, q, k0, v0, k1, v1, bias0, heads, scale):
        out, lse = flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=bias0,
                                       scale=scale, return_lse=True)
        ctx.save_for_backward(q, k0, v0, k1, v1, bias0, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k0, v0, k1, v1, bias0, out, lse = ctx.saved_tensors
        dq, dk0, dv0, dk1, dv1, dbias0 = flash_attention_bwd(
            q, k0, v0, ctx.heads, dout, out, lse, k1=k1, v1=v1, bias0=bias0,
            scale=ctx.scale, need_dbias=bias0 is not None and ctx.needs_input_grad[5])
        return dq, dk0, dv0, dk1, dv1, dbias0, None, None


def flash_attention(q, k0, v0, heads, *, k1=None, v1=None, bias0=None, scale=None):
    """Differentiable attention: ``flash_attention_fwd`` where no operand
    (bias0 included) asks for a gradient, else the forward with lse and the
    backward kernel behind one ``autograd.Function``."""
    operands = [t for t in (q, k0, v0, k1, v1, bias0) if t is not None]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in operands)):
        return flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=bias0,
                                   scale=scale)
    return _FlashAttention.apply(q, k0, v0, k1, v1, bias0, heads, scale)


# --- head-major (B, H, L, D) operands ---------------------------------------
# Counterpart of ``fused_attention`` of the JAX package (ops/attention.py:386)
# and the flash forward/backward behind it: q (B, H, Lq, D), k/v (B, H, Lkv,
# D), no bias, default scale 1/sqrt(D). The kernels read the operands in
# place (any batch and head strides; a row is D contiguous values) and the
# gradients come back contiguous. The JAX dispatch sends Lq < 256 to plain
# XLA; here every shape goes to the kernel. f32 operands take the f32
# attention kernels on head-major strides (m = 1, no bias, one segment).

def fused_attention_plain(q, k, v, scale=None, return_lse=False):
    """softmax(scale q k^T) v per (b, h) in plain PyTorch: f32 math, q's
    dtype out (and, with ``return_lse``, the f32 (B, H, Lq) log-sum-exp)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = q.float() @ k.float().transpose(-1, -2) * scale
    out = (torch.softmax(logits, dim=-1) @ v.float()).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def fused_attention_bwd_plain(q, k, v, dout, out, lse, scale=None):
    """(dq, dk, dv) in plain PyTorch, f32, from the residuals the kernel
    takes: p = exp(scale q k^T - lse), delta = rowsum(dout * out), dv = p^T
    dout, ds = p (dout v^T - delta) scale, dq = ds k, dk = ds^T q."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.float()[..., None])
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    return ((ds @ kf).to(q.dtype), (ds.transpose(-1, -2) @ qf).to(k.dtype),
            (p.transpose(-1, -2) @ dof).to(v.dtype))


def _bhld_checks(kernel, q, k, v, extra=()):
    req = _build.require
    req(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape, kernel,
        "operands must be (B, H, Lq, D) and (B, H, Lkv, D)")
    b, h, lq, d = q.shape
    req(k.shape[:2] == (b, h) and k.shape[3] == d, kernel,
        "q and k/v must share batch, heads and head_dim")
    # a row is D bf16 values: 16-byte vector loads need D * 2 % 16 == 0
    req(d % 8 == 0 and d <= MAX_HEAD_DIM, kernel,
        f"head_dim {d} must be a multiple of 8 and <= {MAX_HEAD_DIM}")
    bf16 = q.dtype == torch.bfloat16
    for t in (q, k, v, *extra):
        req(t.is_cuda and t.dtype == q.dtype and q.dtype in (torch.bfloat16, torch.float32),
            kernel, "operands must be CUDA tensors of one dtype, bf16 or f32")
        req(t.stride(3) == 1 and t.stride(2) == d, kernel,
            "rows must be D contiguous values with row stride D")
        req(not bf16 or (t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
                         and t.data_ptr() % 16 == 0),
            kernel, "batch and head strides must keep 16-byte row alignment")
    for t in extra:
        req(t.shape == q.shape, kernel, "out and dout must have q's shape")
    return b, h, lq, k.shape[2], d


def _bhld_strides(t):
    """(sb, sg, sh, sr) of a (B, H, L, D) operand for the f32 kernels."""
    return [t.stride(0), 0, t.stride(1), t.stride(2)]


def fused_attention_fwd(q, k, v, scale=None, return_lse=False):
    """softmax(scale q k^T) v over (B, H, L, D) operands, read in place. A
    CUDA tensor launches the kernel (bf16 or f32); a CPU tensor takes
    ``fused_attention_plain``. With ``return_lse`` the f32 (B, H, Lq) row
    log-sum-exp comes back as well."""
    if not q.is_cuda:
        return fused_attention_plain(q, k, v, scale, return_lse)
    b, h, lq, lkv, d = _bhld_checks(KERNEL_BHLD, q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.dtype == torch.float32:
        none = [0, 0, 0, 0]
        _f32_launch("e2v_flash_f32_fwd", KERNEL_BHLD + "_f32", [q, k, v, None, None, out, None, lse],
                    [*_bhld_strides(q), *_bhld_strides(k), *_bhld_strides(v), *none, *none,
                     *_bhld_strides(out)], [b, 1, lq, lkv, 0, h, d], scale, q)
        return (out, lse) if return_lse else out
    rc = _build.library().e2v_fused_attention_fwd(
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1), out.data_ptr(), out.stride(0), out.stride(1),
        b, h, lq, lkv, d, float(scale), _build.ptr(lse), _build.stream_of(q))
    _build.check(rc, KERNEL_BHLD)
    _build.launches[KERNEL_BHLD] += 1
    return (out, lse) if return_lse else out


def fused_attention_bwd(q, k, v, dout, out, lse, scale=None):
    """(dq, dk, dv) of ``fused_attention_fwd`` from its operands, its output,
    its ``lse`` and the output's gradient. A CUDA tensor launches the kernel;
    a CPU tensor takes ``fused_attention_bwd_plain``."""
    if not q.is_cuda:
        return fused_attention_bwd_plain(q, k, v, dout, out, lse, scale)
    if dout.stride(3) != 1 or dout.stride(2) != dout.shape[3]:
        dout = dout.contiguous()
    b, h, lq, lkv, d = _bhld_checks(KERNEL_BHLD_BWD, q, k, v, extra=(dout, out))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(lse.is_cuda and lse.dtype == torch.float32 and lse.shape == (b, h, lq)
                   and lse.is_contiguous(), KERNEL_BHLD_BWD,
                   "lse must be a contiguous f32 (B, H, Lq)")
    delta = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if q.dtype == torch.float32:
        none = [0, 0, 0, 0]
        tens = [q, k, v, None, None, dout, out, dq, dk, dv, None, None]
        _f32_launch("e2v_flash_f32_bwd", KERNEL_BHLD_BWD + "_f32",
                    tens + [lse, delta, None, None, None],
                    [x for t in tens for x in (none if t is None else _bhld_strides(t))],
                    [b, 1, lq, lkv, 0, h, d], scale, q)
        return dq, dk, dv
    ptrs = [q, k, v, dout, out, lse, delta, dq, dk, dv]
    strides = [s for t in (q, k, v, dout, out) for s in (t.stride(0), t.stride(1))]
    dims = [b, h, lq, lkv, d]
    rc = _build.library().e2v_fused_attention_bwd(
        (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs]),
        (ctypes.c_longlong * len(strides))(*strides),
        (ctypes.c_int * len(dims))(*dims), float(scale), _build.stream_of(q))
    _build.check(rc, KERNEL_BHLD_BWD)
    _build.launches[KERNEL_BHLD_BWD] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """``fused_attention_fwd`` with lse saved, ``fused_attention_bwd`` behind."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = fused_attention_fwd(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, dout, out, lse, ctx.scale), None)


def fused_attention(q, k, v, scale=None):
    """Differentiable (B, H, Lq, D) x (B, H, Lkv, D) -> (B, H, Lq, D)
    attention: ``fused_attention_fwd`` where no operand asks for a gradient,
    else the forward with lse and the backward kernel behind one
    ``autograd.Function``."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return fused_attention_fwd(q, k, v, scale)
    return _FusedAttention.apply(q, k, v, scale)
