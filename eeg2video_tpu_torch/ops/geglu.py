"""GEGLU feed-forward: ``ff_ln`` and ``geglu_out`` (CUDA kernels), their
backwards ``ff_ln_bwd`` and ``geglu_out_bwd`` (CUDA kernels), the plain
PyTorch version of each, and the differentiable ``feed_forward`` router.
Each wrapper launches the bf16 kernel on bf16 operands and its f32
counterpart (``csrc/ff_f32.cu``, ``csrc/geglu_f32.cu``) on f32 ones, as the
JAX package runs its Pallas kernels at either dtype.

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

from . import _build, residuals
from ._build import aligned16 as _aligned16

FF_MAX_C = 640  # C <= 640 runs the whole block in ff_ln (geglu.py:407)
FF_GRID = 64    # csrc/ff_ln.cu: C is a multiple of 64; narrower blocks come zero-padded
FF_CHUNK = 64   # csrc/ff_tiles.cuh kIC: ff_ln walks I in 64-wide chunks
# csrc/geglu_out.cu: a row block of GEGLU_ROWS rows is a cluster of blocks
# along C that share its gate and h2; I is walked in GEGLU_CHUNK-column chunks
GEGLU_ROWS, GEGLU_CHUNK = 64, 64
# csrc/geglu_out_bwd.cu: tiles of GEGLU_BWD_TILE rows x GEGLU_BWD_TILE columns of dgated
GEGLU_BWD_TILE = 128
# csrc/geglu_f32.cu (tf32_gemm.cuh kBM, kOutN): GEGLU_F32_ROWS x GEGLU_F32_COLS
# tiles of the forward's output and of the backward's dgated; the forward
# splits K = I into min(GEGLU_F32_SPLIT, I / 32) runs (kSplitK)
GEGLU_F32_ROWS, GEGLU_F32_COLS, GEGLU_F32_SPLIT = 128, 160, 4


def _gelu_gate(h2, inner):
    h, g = h2[..., :inner], h2[..., inner:]
    return h * F.gelu(g)  # exact erf gelu


def _layer_norm_f32(x, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def ff_ln_plain(x, gamma, beta, wp, bp, wo, bo, eps=1e-5, residual=True):
    """x + (h * gelu(g)) wo^T + bo, [h | g] = LN(x) wp^T + bp; without the
    leading x when ``residual`` is False."""
    inner = wo.shape[1]
    xn = (_layer_norm_f32(x, eps) * gamma.float() + beta.float()).to(wp.dtype)
    h2 = xn.float() @ wp.float().t() + bp.float()
    gated = _gelu_gate(h2, inner).to(wo.dtype)
    out = gated.float() @ wo.float().t() + bo.float()
    return (x.float() + out if residual else out).to(x.dtype)


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


def ff_ln_bwd_plain(x, g, gamma, beta, wp, bp, wo, eps=1e-5, residual=True):
    """dx of ``ff_ln`` as a written-out formula (the kernel's steps in f32,
    rounded where it rounds): everything recomputed from (x, g). Without the
    residual's g (the LayerNorm path's alone) when ``residual`` is False."""
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
    dx = rstd * (dxn - m1 - xhat * m2)
    return (g.float() + dx if residual else dx).to(x.dtype)


def geglu_out_bwd_plain(h2, g, w):
    """dh2 of ``geglu_out`` as a written-out formula, f32 inside."""
    return _gate_bwd(h2.float(), g.float() @ w.float(), w.shape[1], h2.dtype)


def _f32(t):
    return t.float().contiguous()


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


def _kernel_dtype(kernel, *tensors):
    """bf16 or f32: the dtype the operands share, which picks the kernel."""
    dtype = tensors[0].dtype
    _build.require(dtype in (torch.bfloat16, torch.float32)
                   and all(t.is_cuda and t.dtype == dtype for t in tensors), kernel,
                   "operands must be CUDA tensors of one dtype, bf16 or f32")
    return dtype


def _pad_last(t, width):
    """t zero-padded along its last dim to ``width``."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _ff_operands(kernel, x, gamma, beta, wp, bp, wo, extra=()):
    """The shape checks of ff_ln / ff_ln_bwd and their (T, C) views."""
    c = x.shape[-1]
    inner = wo.shape[1]
    req = _build.require
    req(c % 8 == 0 and c <= FF_MAX_C and inner % 64 == 0, kernel,
        f"C={c} must be a multiple of 8 and <= {FF_MAX_C}, I={inner} of 64")
    req(wp.shape == (2 * inner, c) and wo.shape == (c, inner)
        and all(t.shape == x.shape for t in extra), kernel,
        "wp must be (2I, C), wo (C, I) and g shaped as x")
    return c, inner, [t.reshape(-1, c).contiguous() for t in (x, *extra)]


def _ff_bf16(kernel, x, gamma, beta, wp, bp, wo, bo, extra, eps, residual=True):
    """Launch ``e2v_ff_ln`` / ``e2v_ff_ln_bwd``: C is padded with zeros to
    the kernel's 64-column grid (x, g, gamma, beta, bo, the columns of wp and
    the rows of wo) and the true C passed, so that LayerNorm uses the real
    columns only; the padded output columns are never stored."""
    c, inner, rows = _ff_operands(kernel, x, gamma, beta, wp, bp, wo, extra)
    cp = -(-c // FF_GRID) * FF_GRID
    rows = [_aligned16(_pad_last(t, cp)) for t in rows]
    wp = _aligned16(_pad_last(wp, cp).contiguous())
    wo = _aligned16(F.pad(wo, (0, 0, 0, cp - c)).contiguous() if cp != c else wo.contiguous())
    vecs = [None if v is None else _aligned16(_pad_last(_f32(v), cp)) for v in (gamma, beta, bo)]
    out = torch.empty_like(rows[0])
    lib, ptr = _build.library(), _build.ptr
    if kernel == "ff_ln":
        rc = lib.e2v_ff_ln(rows[0].data_ptr(), ptr(vecs[0]), ptr(vecs[1]), wp.data_ptr(),
                           ptr(_aligned16(_f32(bp))), wo.data_ptr(), ptr(vecs[2]),
                           out.data_ptr(), rows[0].shape[0], cp, c, inner, float(eps),
                           _build.stream_of(x), int(residual))
    else:
        rc = lib.e2v_ff_ln_bwd(rows[0].data_ptr(), rows[1].data_ptr(), ptr(vecs[0]),
                               ptr(vecs[1]), wp.data_ptr(), ptr(_aligned16(_f32(bp))),
                               wo.data_ptr(), out.data_ptr(), rows[0].shape[0], cp, c, inner,
                               float(eps), _build.stream_of(x), int(residual))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return (out if cp == c else out[:, :c]).reshape(x.shape)


def ff_f32_workspace_bytes(t, inner, backward=False):
    """Bytes of the f32 feed-forward pair's workspace for t rows
    (``csrc/ff_f32.cu``): the gated (t, I) intermediate (forward) or dh2
    (t, 2I) (backward), then each row's LayerNorm mean and rstd, all f32.
    The kernels write the intermediate once and read it once."""
    return 4 * t * ((2 if backward else 1) * inner + 2)


def _ff_f32(kernel, x, gamma, beta, wp, bp, wo, bo, extra, eps, residual=True):
    """Launch ``e2v_ff_f32`` / ``e2v_ff_f32_bwd`` (any C % 8 == 0 <= 640) with
    a workspace from the caching allocator."""
    c, inner, rows = _ff_operands(kernel, x, gamma, beta, wp, bp, wo, extra)
    rows = [_aligned16(t) for t in rows]
    wp, wo = _aligned16(wp.contiguous()), _aligned16(wo.contiguous())
    gamma, beta, bp, bo = (None if v is None else _f32(v) for v in (gamma, beta, bp, bo))
    t = rows[0].shape[0]
    backward = kernel == "ff_ln_bwd_f32"
    work = torch.empty(ff_f32_workspace_bytes(t, inner, backward) // 4, dtype=torch.float32,
                       device=x.device)
    out = torch.empty_like(rows[0])
    lib, ptr = _build.library(), _build.ptr
    if not backward:
        rc = lib.e2v_ff_f32(ptr(rows[0]), ptr(gamma), ptr(beta), ptr(wp), ptr(bp), ptr(wo),
                            ptr(bo), ptr(out), ptr(work), t, c, inner, float(eps),
                            _build.stream_of(x), int(residual))
    else:
        rc = lib.e2v_ff_f32_bwd(ptr(rows[0]), ptr(rows[1]), ptr(gamma), ptr(beta), ptr(wp),
                                ptr(bp), ptr(wo), ptr(out), ptr(work), t, c, inner, float(eps),
                                _build.stream_of(x), int(residual))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out.reshape(x.shape)


def ff_ln(x, gamma, beta, wp, bp, wo, bo, eps=1e-5, residual=True):
    """Whole pre-LN GEGLU FF block with residual (without it when
    ``residual`` is False: a tensor-parallel rank's partial product). x
    (..., C). A CUDA tensor launches the kernel (C % 8 == 0, C <= 640, I % 64
    == 0): bf16 x/wp/wo ``ff_ln`` (C padded to its 64-column grid), f32 ones
    ``ff_ln_f32``; a CPU tensor takes ``ff_ln_plain``."""
    if not x.is_cuda:
        return ff_ln_plain(x, gamma, beta, wp, bp, wo, bo, eps, residual)
    if _kernel_dtype("ff_ln", x, wp, wo) == torch.float32:
        return _ff_f32("ff_ln_f32", x, gamma, beta, wp, bp, wo, bo, (), eps, residual)
    return _ff_bf16("ff_ln", x, gamma, beta, wp, bp, wo, bo, (), eps, residual)


def ff_ln_bwd(x, g, gamma, beta, wp, bp, wo, eps=1e-5, residual=True):
    """dx of ``ff_ln`` from its input x and the output's gradient g (of the
    block without its residual when ``residual`` is False: no g in dx). A
    CUDA tensor launches the kernel (same shape rules as ``ff_ln``; bf16
    ``ff_ln_bwd``, f32 ``ff_ln_bwd_f32``); a CPU tensor takes
    ``ff_ln_bwd_plain``."""
    if not x.is_cuda:
        return ff_ln_bwd_plain(x, g, gamma, beta, wp, bp, wo, eps, residual)
    if _kernel_dtype("ff_ln_bwd", x, g, wp, wo) == torch.float32:
        return _ff_f32("ff_ln_bwd_f32", x, gamma, beta, wp, bp, wo, None, (g,), eps, residual)
    return _ff_bf16("ff_ln_bwd", x, gamma, beta, wp, bp, wo, None, (g,), eps, residual)


def geglu_out_l2_read_bytes(t, inner, c):
    """Bytes the kernel's blocks copy from L2 in one call, from the tiling:
    the blocks of a row block read each row of w (I bf16) and each bias value
    (f32) once between them, each its own output columns (the tensor map fills
    rows past C with zeros), and each of the row block's rows of h2 below T
    (2I bf16) once between them, sending the gated rows to one another in
    shared memory."""
    return -(-t // GEGLU_ROWS) * c * (inner * 2 + 4) + t * 2 * inner * 2


def geglu_out_bwd_l2_read_bytes(t, inner, c):
    """Bytes ``geglu_out_bwd``'s blocks copy from L2 in one call, from its
    tiling (GEGLU_BWD_TILE x GEGLU_BWD_TILE tiles of dgated): each tile reads
    its rows of g below T (C bf16 each) and W's rows (C) at its columns below
    I, so g is read once per column of tiles and W once per row of tiles; h2
    (2I bf16 a row) is read once."""
    tiles_t, tiles_i = -(-t // GEGLU_BWD_TILE), -(-inner // GEGLU_BWD_TILE)
    return (tiles_i * t * c + tiles_t * c * inner + t * 2 * inner) * 2


def _geglu_f32_splits(inner):
    return min(GEGLU_F32_SPLIT, inner // 32)


def geglu_f32_workspace_bytes(t, inner, c):
    """Bytes of ``geglu_out_f32``'s workspace for t rows (``csrc/geglu_f32.cu``),
    f32: the gated (t, I) product, written once by a row pass and read by the
    out GEMM, then the GEMM's partial (t, C) sums over its runs of K, summed
    by a row pass."""
    return 4 * t * (inner + _geglu_f32_splits(inner) * c)


def geglu_f32_l2_read_bytes(t, inner, c, backward=False):
    """Bytes the f32 GEGLU pair's blocks copy from L2 in one call, from the
    tiling (GEGLU_F32_ROWS x GEGLU_F32_COLS tiles, f32). Forward: the gate's
    row pass reads h2 (2I a row) once; the out tiles of a run of K copy their
    rows of gated below T and W's rows below C over that run, so gated is read
    once per column of tiles and W once per row of tiles; the sum's row pass
    reads the partial (T, C) sums once. Backward: each tile copies its rows
    of g below T (C each) and W's rows (C) at its columns below I, so g is
    read once per column of tiles and W once per row of tiles; the epilogue
    reads h2 once."""
    tiles_t = -(-t // GEGLU_F32_ROWS)
    if backward:
        return 4 * (-(-inner // GEGLU_F32_COLS) * t * c + tiles_t * c * inner + t * 2 * inner)
    return 4 * (t * 2 * inner + -(-c // GEGLU_F32_COLS) * t * inner + tiles_t * c * inner
                + _geglu_f32_splits(inner) * t * c)


def _geglu_f32(kernel, h2, w, extra):
    """Launch ``e2v_geglu_f32`` (extra: b; a workspace from the caching
    allocator) or ``e2v_geglu_f32_bwd`` (extra: g). A call of no rows launches
    nothing and is not counted."""
    c, inner = w.shape
    h2c = _aligned16(h2.reshape(-1, 2 * inner).contiguous())
    t = h2c.shape[0]
    forward = kernel == "geglu_out_f32"
    out = torch.empty((t, c) if forward else (t, 2 * inner), dtype=h2.dtype, device=h2.device)
    shape = (*h2.shape[:-1], c) if forward else h2.shape
    if t == 0:
        return out.reshape(shape)
    w = _aligned16(w.contiguous())
    lib = _build.library()
    if forward:
        work = torch.empty(geglu_f32_workspace_bytes(t, inner, c) // 4, dtype=torch.float32,
                           device=h2.device)
        rc = lib.e2v_geglu_f32(h2c.data_ptr(), w.data_ptr(), _aligned16(_f32(extra)).data_ptr(),
                               out.data_ptr(), work.data_ptr(), t, inner, c,
                               _build.stream_of(h2))
    else:
        gc = _aligned16(extra.reshape(-1, c).contiguous())
        rc = lib.e2v_geglu_f32_bwd(h2c.data_ptr(), gc.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   t, inner, c, _build.stream_of(h2))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out.reshape(shape)


def geglu_out(h2, w, b):
    """(h * gelu(g)) w^T + b with the gate fused into the GEMM. h2 (..., 2I),
    w (C, I), b (C). A CUDA tensor launches the kernel (I % 64 == 0,
    C % 8 == 0): bf16 h2/w ``geglu_out``, f32 ones ``geglu_out_f32``; a CPU
    tensor takes ``geglu_out_plain``."""
    if not h2.is_cuda:
        return geglu_out_plain(h2, w, b)
    kernel = "geglu_out"
    c, inner = w.shape
    req = _build.require
    req(h2.shape[-1] == 2 * inner and inner % GEGLU_CHUNK == 0 and inner > 0, kernel,
        f"h2 must be (..., 2I) with I={inner} a multiple of {GEGLU_CHUNK}")
    req(c % 8 == 0 and c > 0, kernel, f"C={c} must be a multiple of 8")
    if _kernel_dtype(kernel, h2, w) == torch.float32:
        return _geglu_f32("geglu_out_f32", h2, w, b)
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
    (..., C). A CUDA tensor launches the kernel (C % 32 == 0, I % 8 == 0):
    bf16 ``geglu_out_bwd``, f32 ``geglu_out_bwd_f32``; a CPU tensor takes
    ``geglu_out_bwd_plain``."""
    if not h2.is_cuda:
        return geglu_out_bwd_plain(h2, g, w)
    kernel = "geglu_out_bwd"
    c, inner = w.shape
    req = _build.require
    req(h2.shape[-1] == 2 * inner and inner % 8 == 0 and c % 32 == 0, kernel,
        f"h2 must be (..., 2I) with I={inner} a multiple of 8 and C={c} of 32")
    req(g.shape == (*h2.shape[:-1], c), kernel, "g must be (..., C)")
    if _kernel_dtype(kernel, h2, g, w) == torch.float32:
        return _geglu_f32("geglu_out_bwd_f32", h2, w, g)
    h2c = _aligned16(h2.reshape(-1, 2 * inner).contiguous())
    gc, w = _aligned16(g.reshape(-1, c).contiguous()), _aligned16(w.contiguous())
    dh2 = torch.empty_like(h2c)
    rc = _build.library().e2v_geglu_out_bwd(
        h2c.data_ptr(), gc.data_ptr(), w.data_ptr(), dh2.data_ptr(), h2c.shape[0], inner, c,
        _build.stream_of(h2))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return dh2.reshape(h2.shape)


class _FFLn(torch.autograd.Function):
    """``ff_ln`` with ``ff_ln_bwd`` behind for dx (both with or without the
    residual); its output is an ``ff_out`` residual of a recomputed block."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wp, bp, wo, bo, eps, residual):
        ctx.save_for_backward(x, gamma, beta, wp, bp, wo, bo)
        ctx.eps, ctx.residual = eps, residual
        return residuals.forward(residuals.FF_OUT, "ff_ln",
                                 lambda: ff_ln(x, gamma, beta, wp, bp, wo, bo, eps, residual))

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = ff_ln_bwd(x, g, *params[:-1], ctx.eps, ctx.residual)
        grads = _param_grads(lambda x_, *p: ff_ln_plain(x_, *p, ctx.eps, ctx.residual), [x],
                             params, ctx.needs_input_grad[1:7], g)
        return (dx, *grads, None, None)


class _GegluOut(torch.autograd.Function):
    """``geglu_out`` with ``geglu_out_bwd`` behind for dh2; its output is an
    ``ff_out`` residual of a recomputed block."""

    @staticmethod
    def forward(ctx, h2, w, b):
        ctx.save_for_backward(h2, w, b)
        return residuals.forward(residuals.FF_OUT, "geglu_out", lambda: geglu_out(h2, w, b))

    @staticmethod
    def backward(ctx, g):
        h2, w, b = ctx.saved_tensors
        dh2 = geglu_out_bwd(h2, g, w) if ctx.needs_input_grad[0] else None
        grads = _param_grads(geglu_out_plain, [h2], [w, b], ctx.needs_input_grad[1:3], g)
        return (dh2, *grads)


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ff_ln_function(x, gamma, beta, wp, bp, wo, bo, eps=1e-5, residual=True):
    """Differentiable ``ff_ln``."""
    return _FFLn.apply(x, gamma, beta, wp, bp, wo, bo, eps, residual)


def geglu_out_function(h2, w, b):
    """Differentiable ``geglu_out``."""
    return _GegluOut.apply(h2, w, b)


# --- routing: the JAX package's dispatch predicates, one function each ---------
# Its T < 256 tests (geglu.py:407, :434) are TPU speed rules, like
# _FLASH_MIN_LQ: here short row counts take the kernels too. A tensor-parallel
# rank's shard (``shard``) routes on the CUDA kernels' own limits instead: JAX
# never routes on a shard's width (GSPMD partitions the call it routed on the
# global width), so its Pallas grid says nothing of a rank's I / tp.

def ff_route(c, inner, shard=False):
    """The branch JAX's ``fused_ff_ln`` takes (geglu.py:407-419) for width C
    and inner width I: "ff_ln" (the whole block in one kernel), "ln_geglu"
    (C > 640: LayerNorm and the projection as torch ops, then ``geglu``) or
    "ref" (off the grid: ``ff_ref``). With ``shard`` the grid of I is
    ``ff_ln``'s own (FF_CHUNK), not JAX's 128."""
    if c % 8 or inner % (FF_CHUNK if shard else 128):
        return "ref"
    return "ln_geglu" if c > FF_MAX_C else "ff_ln"


def geglu_route(inner, c, shard=False):
    """The branch JAX's ``fused_geglu_out`` takes (geglu.py:434): "geglu_out"
    or "ref" (``geglu_ref``). With ``shard`` the limits are ``geglu_out``'s
    own (I % GEGLU_CHUNK, C % 8)."""
    if shard:
        return "ref" if inner % GEGLU_CHUNK or c % 8 else "geglu_out"
    return "ref" if inner % 128 or c % 128 else "geglu_out"


def ff_ref(x, gamma, beta, wp, bp, wo, bo, eps=1e-5, residual=True):
    """Counterpart of JAX ``_ff_ref`` (geglu.py:197-210) in torch ops, with its
    rounding: the normalised x, the projection and the FF output rounded to
    x.dtype, the gated product to wo.dtype. Without the leading x when
    ``residual`` is False."""
    xn = _layer_norm_f32(x, eps).to(x.dtype) * gamma + beta
    h2 = F.linear(xn, wp) + bp
    inner = wo.shape[1]
    gated = (h2[..., :inner] * F.gelu(h2[..., inner:])).to(wo.dtype)
    out = F.linear(gated, wo) + bo
    return x + out if residual else out


def geglu_ref(h2, w, b):
    """Counterpart of JAX ``_geglu_ref`` (geglu.py:36) in torch ops: the gated
    product rounded to w.dtype, the GEMM to h2.dtype, then + b."""
    inner = w.shape[1]
    gated = (h2[..., :inner] * F.gelu(h2[..., inner:])).to(w.dtype)
    return F.linear(gated, w).to(h2.dtype) + b.to(h2.dtype)


def geglu(h2, w, b, shard=False):
    """(h * gelu(g)) w^T + b, routed as ``fused_geglu_out`` (``geglu_route``,
    ``shard`` for a tensor-parallel rank's slice): the kernel (behind its
    ``autograd.Function`` where an operand asks for a gradient) or
    ``geglu_ref``."""
    if geglu_route(w.shape[1], w.shape[0], shard) == "ref":
        return geglu_ref(h2, w, b)
    return (geglu_out_function if _wants_grad(h2, w, b) else geglu_out)(h2, w, b)


def feed_forward(x, gamma, beta, wp, bp, wo, bo, eps=1e-5, residual=True):
    """x + FF(LN(x)), routed by ``ff_route`` as the JAX package routes it:
    ``ff_ln``; LayerNorm and the projection as torch ops (rounded as at
    geglu.py:411-417) and the gate + out GEMM through ``geglu``; or
    ``ff_ref``. Where an operand asks for a gradient the kernels run behind
    their ``autograd.Function``s, with the backward kernels.

    ``residual`` False gives FF(LN(x)) alone on each route (the kernels
    without their residual, forward and backward): the partial product of a
    tensor-parallel rank, whose widths (I / tp) pick the route on the
    kernels' own limits (``ff_route(..., shard=True)``)."""
    route = ff_route(x.shape[-1], wo.shape[1], shard=not residual)
    grad = _wants_grad(x, gamma, beta, wp, bp, wo, bo)
    if route == "ref":
        return ff_ref(x, gamma, beta, wp, bp, wo, bo, eps, residual)
    if route == "ff_ln":
        if grad:
            return ff_ln_function(x, gamma, beta, wp, bp, wo, bo, eps, residual)
        return ff_ln(x, gamma, beta, wp, bp, wo, bo, eps, residual)
    xn = _layer_norm_f32(x, eps).to(x.dtype) * gamma + beta
    h2 = F.linear(xn, wp) + bp  # f32-accumulated GEMM, rounded to x.dtype
    out = geglu(h2, wo, bo, shard=not residual)
    return x + out if residual else out
