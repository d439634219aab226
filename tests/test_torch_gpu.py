"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: skipped where torch.cuda.is_available() is false. The file
imports torch and the port only, so it runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up the JAX CPU mesh).
The shapes are small and ragged on purpose: KV and query tails, head dims
8, 40, 80 and 160 (padded to 16, 48, 80 and 160 in shared memory), channel
counts that do not fill a tile. chip_smoke.py checks the main paths' own shapes.
Bound: max |kernel - plain| / max |plain| < 1e-2, the plain version in f32
on the same bf16 inputs (bf16 rounding of the output and of the in-kernel
bf16 intermediates). The backward kernels are held to the same bound, each
gradient against the plain backward's on the same residuals. The f32
kernels (f32 operands) keep f32 accuracy (the attention, feed-forward and
GEGLU pairs by three tf32 tensor-core products for each f32 one, about 2^-21
relative each; the others in f32 throughout): they are held to 1e-4 of the
output's max and must give the same bits twice.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from eeg2video_tpu_torch.ops import _build, attention, conv2d, geglu, iir, int8_dense, temporal
from test_torch_kernel_plans import temporal_grid

BOUND = 1e-2
F32_BOUND = 1e-4  # the f32 kernels: summation order and the 3xTF32 split only


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _close(got, want, bound):
    """_err below bound, or both all zero (at F = 1 the softmax over one frame is 1 and
    dq = dk = 0 exactly: there is no scale to be relative to)."""
    if want.abs().max().item() == 0:
        return got.abs().max().item() == 0
    return _err(got, want) < bound


def _f32(ts):
    return [None if t is None else t.float() for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("n,lq,lkv,hd,heads,bias,two_seg", [
    (1, 70, 77, 64, 8, False, False),    # D = 8, query and KV tails
    (2, 300, 130, 320, 8, True, False),  # D = 40, bias
    (1, 100, 100, 128, 8, True, True),   # D = 16, two segments, bias
])
def test_flash_attention_matches_plain(gen, n, lq, lkv, hd, heads, bias, two_seg):
    m = 2 if two_seg else 1
    q = _rand(gen, n, m, lq, hd) if two_seg else _rand(gen, n, lq, hd)
    k0, v0 = _rand(gen, n, lkv, hd), _rand(gen, n, lkv, hd)
    k1 = _rand(gen, n, m, lkv, hd) if two_seg else None
    v1 = _rand(gen, n, m, lkv, hd) if two_seg else None
    b0 = _rand(gen, n, 1, lkv, scale=2.0, dtype=torch.float32) if bias else None
    out = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0)
    q32, k032, v032, k132, v132 = _f32([q, k0, v0, k1, v1])
    want = attention.flash_attention_plain(q32, k032, v032, heads, k1=k132, v1=v132,
                                           bias0=b0)
    assert _err(out, want) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,lq,lkv0,lkv1,hd,heads,bias", [
    (2, 1, 70, 77, 0, 64, 8, False),     # D = 8, one segment, query and KV tails
    (2, 1, 300, 130, 0, 320, 8, True),   # D = 40 (padded to 48), bias in the recompute
    (2, 3, 100, 100, 90, 128, 8, True),  # D = 16, two segments, dk0 summed over m = 3
    (1, 2, 130, 64, 0, 320, 2, False),   # D = 160, m = 2 groups on one shared segment
])
def test_flash_attention_lse_and_backward_match_plain(gen, n, m, lq, lkv0, lkv1, hd, heads,
                                                      bias):
    q = _rand(gen, n, m, lq, hd) if m > 1 else _rand(gen, n, lq, hd)
    k0, v0 = _rand(gen, n, lkv0, hd), _rand(gen, n, lkv0, hd)
    k1 = _rand(gen, n, m, lkv1, hd) if lkv1 else None
    v1 = _rand(gen, n, m, lkv1, hd) if lkv1 else None
    b0 = _rand(gen, n, 1, lkv0, scale=2.0, dtype=torch.float32) if bias else None
    dout = _rand(gen, *q.shape)
    out, lse = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0,
                                             return_lse=True)
    q32, k032, v032, k132, v132 = _f32([q, k0, v0, k1, v1])
    want, want_lse = attention.flash_attention_plain(q32, k032, v032, heads, k1=k132,
                                                     v1=v132, bias0=b0, return_lse=True)
    assert _err(out, want) < BOUND
    assert (lse - want_lse).abs().max().item() < 1e-3  # f32 both sides, absolute
    got = attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                        bias0=b0)
    ref = attention.flash_attention_bwd_plain(q32, k032, v032, heads, dout.float(),
                                              out.float(), lse, k1=k132, v1=v132, bias0=b0)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.shape == r.shape and _err(g, r) < BOUND
    again = attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                          bias0=b0)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,lq,lkv0,lkv1,hd,heads", [
    (2, 1, 300, 130, 0, 320, 8),   # one segment, D = 40, query and KV tails
    (2, 3, 100, 100, 90, 128, 8),  # two segments: dbias0 summed over the m = 3 groups
    (1, 2, 70, 77, 0, 320, 2),     # D = 160, two groups on one shared segment
    (2, 1, 150, 150, 0, 640, 8),   # D = 80, one segment
    (2, 2, 150, 150, 140, 640, 8),  # D = 80, two segments
])
def test_flash_attention_dbias_matches_plain(gen, n, m, lq, lkv0, lkv1, hd, heads):
    """The gradient of bias0: mask-like values (0 / -1e4 holes) plus dense noise, so that
    it is not trivially 0; the other gradients keep the bits of the call without dbias."""
    q = _rand(gen, n, m, lq, hd) if m > 1 else _rand(gen, n, lq, hd)
    k0, v0 = _rand(gen, n, lkv0, hd), _rand(gen, n, lkv0, hd)
    k1 = _rand(gen, n, m, lkv1, hd) if lkv1 else None
    v1 = _rand(gen, n, m, lkv1, hd) if lkv1 else None
    b0 = _rand(gen, n, 1, lkv0, scale=0.5, dtype=torch.float32)
    b0[:, :, ::7] = -1e4
    dout = _rand(gen, *q.shape)
    out, lse = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0,
                                             return_lse=True)
    got = attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                        bias0=b0, need_dbias=True)
    q32, k032, v032, k132, v132 = _f32([q, k0, v0, k1, v1])
    ref = attention.flash_attention_bwd_plain(q32, k032, v032, heads, dout.float(),
                                              out.float(), lse, k1=k132, v1=v132, bias0=b0,
                                              need_dbias=True)
    assert got[5].shape == b0.shape and got[5].dtype == b0.dtype
    assert bool((got[5][:, :, ::7] == 0).all()) and float(got[5].abs().max()) > 0
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.shape == r.shape and _err(g, r) < BOUND
    again = attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                          bias0=b0, need_dbias=True)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))  # no atomics
    without = attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                            bias0=b0)
    assert without[5] is None
    assert all(a is None or torch.equal(a, b) for a, b in zip(without[:5], got[:5]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [5, 26, 53, 106])
def test_flash_attention_runs_head_dims_off_the_multiple_of_8(gen, d, dtype):
    """12 heads of D = 5, 26, 53, 106 (rows of 60 to 1272 values; ``UNet3DConfig(
    attention_heads=12)`` gives 26 / 53 / 106): the forward into a caller's frame view,
    with lse, the backward and dbias0, on one segment and on two (m = 2), through the
    kernels on heads padded to a multiple of 8 (``attention.pad_heads``): within 1e-2
    (bf16) or 1e-4 (f32) of the plain versions, lse within 1e-3, the same bits twice,
    and each call counted as a launch of its kernel."""
    bound = BOUND if dtype == torch.bfloat16 else F32_BOUND
    sfx = "_f32" if dtype == torch.float32 else ""
    heads, hd = 12, 12 * d
    for m, lkv1 in ((1, 0), (2, 90)):
        frames = _rand(gen, 2, m + 1, 70, hd, dtype=dtype)  # the forward writes frames 1..m
        q = _rand(gen, 2, m, 70, hd, dtype=dtype) if m > 1 else _rand(gen, 2, 70, hd, dtype=dtype)
        k0, v0 = _rand(gen, 2, 77, hd, dtype=dtype), _rand(gen, 2, 77, hd, dtype=dtype)
        k1 = _rand(gen, 2, m, lkv1, hd, dtype=dtype) if lkv1 else None
        v1 = _rand(gen, 2, m, lkv1, hd, dtype=dtype) if lkv1 else None
        b0 = _rand(gen, 2, 1, 77, scale=0.5, dtype=torch.float32)
        b0[:, :, ::7] = -1e4
        dout = _rand(gen, *q.shape, dtype=dtype)
        view = frames[:, 1:] if m > 1 else frames[:, 1]
        before = dict(_build.launches)
        out, lse = _twice(lambda: attention.flash_attention_fwd(
            q, k0, v0, heads, k1=k1, v1=v1, bias0=b0, out=view, return_lse=True))
        assert out.data_ptr() == view.data_ptr() and torch.equal(frames[:, 1:m + 1].reshape(
            out.shape), out)
        q32, k032, v032, k132, v132 = _f32([q, k0, v0, k1, v1])
        want, want_lse = attention.flash_attention_plain(q32, k032, v032, heads, k1=k132,
                                                         v1=v132, bias0=b0, return_lse=True)
        assert _err(out, want) < bound and (lse - want_lse).abs().max().item() < 1e-3
        got = _twice(lambda: attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse,
                                                           k1=k1, v1=v1, bias0=b0,
                                                           need_dbias=True))
        ref = attention.flash_attention_bwd_plain(q32, k032, v032, heads, dout.float(),
                                                  out.float(), lse, k1=k132, v1=v132,
                                                  bias0=b0, need_dbias=True)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                assert g.shape == r.shape and _err(g, r) < bound, (d, m)
        assert bool((got[5][:, :, ::7] == 0).all()) and float(got[5].abs().max()) > 0
        assert _launched(before) == {"flash_attention_fwd" + sfx: 2,
                                     "flash_attention_bwd" + sfx: 2,
                                     "flash_attention_bwd_dbias" + sfx: 2}


@pytest.mark.gpu
def test_flash_attention_function_returns_the_bias_gradient(gen):
    """The differentiable call with a bias that asks for a gradient, on a two-segment call:
    all six gradients against autograd through the plain version."""
    b, m, l, hd, heads = 2, 2, 70, 64, 8
    q, k1, v1 = (_rand(gen, b, m, l, hd).requires_grad_() for _ in range(3))
    k0, v0 = (_rand(gen, b, l, hd).requires_grad_() for _ in range(2))
    bias = _rand(gen, b, 1, l, dtype=torch.float32).requires_grad_()
    leaves = [q, k0, v0, k1, v1, bias]
    ref = [t.detach().float().requires_grad_() for t in leaves]
    out = attention.flash_attention(q, k0, v0, heads, k1=k1, v1=v1, bias0=bias)
    want = attention.flash_attention_plain(ref[0], ref[1], ref[2], heads, k1=ref[3], v1=ref[4],
                                           bias0=ref[5])
    dout = _rand(gen, *out.shape)
    got = torch.autograd.grad(out, leaves, dout)
    wanted = torch.autograd.grad(want, ref, dout.float())
    for g, w in zip(got, wanted):
        assert g.shape == w.shape and _err(g, w) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lkv,d", [
    (1, 2, 300, 450, 40),   # D = 40 (padded to 48), query and KV tails
    (2, 8, 256, 512, 40),
    (2, 3, 70, 77, 8),      # D = 8, short sequences
    (1, 2, 130, 64, 160),   # D = 160
])
def test_fused_attention_matches_plain(gen, b, h, lq, lkv, d):
    q, k, v, dout = _rand(gen, b, h, lq, d), _rand(gen, b, h, lkv, d), _rand(gen, b, h, lkv, d), \
        _rand(gen, b, h, lq, d)
    out, lse = attention.fused_attention_fwd(q, k, v, return_lse=True)
    want, want_lse = attention.fused_attention_plain(*_f32([q, k, v]), return_lse=True)
    assert out.shape == q.shape and out.is_contiguous() and _err(out, want) < BOUND
    assert (lse - want_lse).abs().max().item() < 1e-3  # f32 both sides, absolute
    assert torch.equal(attention.fused_attention_fwd(q, k, v), out)  # the no-lse instantiation
    got = attention.fused_attention_bwd(q, k, v, dout, out, lse)
    ref = attention.fused_attention_bwd_plain(*_f32([q, k, v, dout, out]), lse)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) < BOUND
    again = attention.fused_attention_bwd(q, k, v, dout, out, lse)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, got))  # no atomics


@pytest.mark.gpu
def test_fused_attention_function_reads_strided_heads_in_place(gen):
    """The differentiable call on head slices of a wider (B, 2H, L, D) tensor (batch and
    head strides that are not the contiguous ones) and a custom scale, against autograd
    through the plain version, in bf16 and (the f32 kernels) f32; what the kernels do not
    take raises."""
    b, h, lq, lkv, d = 2, 3, 100, 90, 40
    wide_q, wide_k, wide_v = (_rand(gen, b, 2 * h, l, d).requires_grad_() for l in (lq, lkv, lkv))
    ref = [t.detach().float().requires_grad_() for t in (wide_q, wide_k, wide_v)]
    out = attention.fused_attention(wide_q[:, ::2], wide_k[:, h:], wide_v[:, :h], scale=0.2)
    want = attention.fused_attention_plain(ref[0][:, ::2], ref[1][:, h:], ref[2][:, :h], scale=0.2)
    dout = _rand(gen, *out.shape)
    got = torch.autograd.grad(out, [wide_q, wide_k, wide_v], dout)
    wanted = torch.autograd.grad(want, ref, dout.float())
    assert _err(out, want) < BOUND
    for g, w in zip(got, wanted):
        assert _err(g, w) < BOUND
    wide32 = [t.detach().float().requires_grad_() for t in (wide_q, wide_k, wide_v)]
    out32 = attention.fused_attention(wide32[0][:, ::2], wide32[1][:, h:], wide32[2][:, :h],
                                      scale=0.2)
    assert _err(out32, want) < F32_BOUND
    for g, w in zip(torch.autograd.grad(out32, wide32, dout.float()), wanted):
        assert _err(g, w) < F32_BOUND
    q = wide_q.detach()
    with pytest.raises(ValueError, match="row stride"):
        attention.fused_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention.fused_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.fused_attention(q[..., :4].contiguous(), q[..., :4].contiguous(),
                                  q[..., :4].contiguous())


@pytest.mark.gpu
def test_flash_attention_function_takes_strided_frame_slices(gen):
    """The differentiable call on frame slices of one (B, F, L, H*D) projection, as the
    sparse-causal attention makes it: gradients against autograd through the plain version."""
    b, f, l, hd, heads = 2, 4, 70, 64, 8
    qkv = [_rand(gen, b, f, l, hd).requires_grad_() for _ in range(3)]
    ref = [t.detach().float().requires_grad_() for t in qkv]

    def run(fn, q, k, v):
        return fn(q[:, 2:], k[:, 0], v[:, 0], heads, k1=k[:, 1:-1], v1=v[:, 1:-1])

    out = run(attention.flash_attention, *qkv)
    want = run(attention.flash_attention_plain, *ref)
    dout = _rand(gen, *out.shape)
    got = torch.autograd.grad(out, qkv, dout)
    wanted = torch.autograd.grad(want, ref, dout.float())
    assert _err(out, want) < BOUND
    for g, w in zip(got, wanted):
        assert _err(g, w) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,lq,lkv0,lkv1,hd,heads,bias", [
    (2, 1, 77, 40, 0, 64, 8, False),        # D = 8: one n8 tile of P V; 80- and 48-row blocks
    (2, 1, 40, 77, 0, 320, 8, True),        # D = 40 (5 of 6 n8 tiles), level-3 Lq, cross Lkv
    (2, 2, 144, 144, 144, 640, 8, True),    # D = 80, two segments, both tails at 16 of 64
    (2, 4, 40, 40, 40, 1280, 8, True),      # D = 160, four groups on one shared segment
    (2, 1, 1100, 1100, 0, 320, 8, True),    # 128-row blocks in every pass, ragged last block
    (2, 2, 600, 600, 590, 320, 8, False),   # 128-row dq and segment-1 dkv, 64-row segment 0
])
def test_flash_attention_tile_edges_match_plain(gen, n, m, lq, lkv0, lkv1, hd, heads, bias):
    """Lq and Lkv that are not multiples of the 64- and 128-row tiles, every head dim the
    model uses: out and lse against the plain version, the backward (with dbias0 where a
    bias is given) against the plain backward, and two backward runs give the same bits."""
    q = _rand(gen, n, m, lq, hd) if m > 1 else _rand(gen, n, lq, hd)
    k0, v0 = _rand(gen, n, lkv0, hd), _rand(gen, n, lkv0, hd)
    k1 = _rand(gen, n, m, lkv1, hd) if lkv1 else None
    v1 = _rand(gen, n, m, lkv1, hd) if lkv1 else None
    b0 = None
    if bias:
        b0 = _rand(gen, n, 1, lkv0, scale=0.5, dtype=torch.float32)
        b0[:, :, ::5] = -1e4
    dout = _rand(gen, *q.shape)
    out, lse = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0,
                                             return_lse=True)
    q32, k032, v032, k132, v132 = _f32([q, k0, v0, k1, v1])
    want, want_lse = attention.flash_attention_plain(q32, k032, v032, heads, k1=k132, v1=v132,
                                                     bias0=b0, return_lse=True)
    assert _err(out, want) < BOUND
    assert (lse - want_lse).abs().max().item() < 1e-3
    assert torch.equal(attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0),
                       out)  # the no-lse instantiation
    got = attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                        bias0=b0, need_dbias=bias)
    ref = attention.flash_attention_bwd_plain(q32, k032, v032, heads, dout.float(), out.float(),
                                              lse, k1=k132, v1=v132, bias0=b0, need_dbias=bias)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.shape == r.shape and _err(g, r) < BOUND
    again = attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                          bias0=b0, need_dbias=bias)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lkv,d", [
    (1, 2, 300, 450, 40),    # the ragged case of chip_smoke.py
    (2, 8, 77, 40, 8),       # D = 8
    (2, 8, 144, 77, 80),     # D = 80
    (2, 8, 40, 144, 160),    # D = 160
    (2, 8, 1100, 1100, 40),  # 128-row blocks in every pass
])
def test_fused_attention_tile_edges_match_plain(gen, b, h, lq, lkv, d):
    q, k, v, dout = _rand(gen, b, h, lq, d), _rand(gen, b, h, lkv, d), _rand(gen, b, h, lkv, d), \
        _rand(gen, b, h, lq, d)
    out, lse = attention.fused_attention_fwd(q, k, v, return_lse=True)
    want, want_lse = attention.fused_attention_plain(*_f32([q, k, v]), return_lse=True)
    assert _err(out, want) < BOUND and (lse - want_lse).abs().max().item() < 1e-3
    got = attention.fused_attention_bwd(q, k, v, dout, out, lse)
    ref = attention.fused_attention_bwd_plain(*_f32([q, k, v, dout, out]), lse)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) < BOUND
    again = attention.fused_attention_bwd(q, k, v, dout, out, lse)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, got))  # no atomics


@pytest.mark.gpu
def test_flash_attention_mask_gradient_at_tile_edges(gen):
    """A mask that asks for a gradient on a two-segment call at D = 40 with KV and query
    tails: the bias gradient through the differentiable call against autograd through the
    plain version, and the same bits from a second backward."""
    b, m, lq, lkv, hd, heads = 2, 4, 144, 77, 320, 8
    q, k1, v1 = (_rand(gen, b, m, l, hd).requires_grad_() for l in (lq, lkv, lkv))
    k0, v0 = (_rand(gen, b, lkv, hd).requires_grad_() for _ in range(2))
    bias = (0.5 * torch.randn(b, 1, lkv, generator=gen, device="cuda"))
    bias[:, :, ::6] = -1e4
    bias.requires_grad_()
    leaves = [q, k0, v0, k1, v1, bias]
    ref = [t.detach().float().requires_grad_() for t in leaves]
    out = attention.flash_attention(q, k0, v0, heads, k1=k1, v1=v1, bias0=bias)
    want = attention.flash_attention_plain(ref[0], ref[1], ref[2], heads, k1=ref[3], v1=ref[4],
                                           bias0=ref[5])
    dout = _rand(gen, *out.shape)
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dout)
    wanted = torch.autograd.grad(want, ref, dout.float())
    for g, w in zip(got, wanted):
        assert g.shape == w.shape and _err(g, w) < BOUND
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert bool((got[5][:, :, ::6] == 0).all()) and float(got[5].abs().max()) > 0


# the model's widths (D = 40, 80, 160 at H = 8: one, two and four backward
# units a token in bf16, two, four and eight in f32) at lengths that end
# inside a run of units, and F = 1 and F = 8
TEMPORAL_MODEL_CASES = [(2, 6, l, hd, 8) for hd in (320, 640, 1280) for l in (1, 37, 130)] + [
    (2, 1, 37, 320, 8), (1, 8, 37, 320, 8), (1, 8, 130, 1280, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,l,hd,heads", [
    (2, 6, 50, 320, 8),   # D = 40: two values per lane
    (1, 3, 33, 32, 4),    # D = 8 over 8 lanes: one value per lane
    (2, 2, 7, 1280, 8),   # D = 160
    (1, 8, 5, 64, 8),     # F = 8
    *TEMPORAL_MODEL_CASES,
])
def test_temporal_attention_matches_plain(gen, b, f, l, hd, heads):
    q, k, v, dout = (_rand(gen, b, f, l, hd) for _ in range(4))
    out = temporal.temporal_attention_fwd(q, k, v, heads)
    assert _err(out, temporal.temporal_attention_plain(*_f32([q, k, v]), heads)) < BOUND
    got = temporal.temporal_attention_bwd(q, k, v, dout, heads)
    want = temporal.temporal_attention_bwd_plain(*_f32([q, k, v, dout]), heads)
    for g, w in zip(got, want):
        assert _close(g, w, BOUND)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [320, 640, 1280])
def test_temporal_attention_bwd_repeats_and_tokens_do_not_depend_on_l(gen, hd, dtype):
    """The backward gives the same bits twice, and tokens 0..36 of an L = 130 call equal
    an L = 37 call: every token's sums run in one order, wherever its run starts."""
    q, k, v, dout = (_rand(gen, 2, 6, 130, hd, dtype=dtype) for _ in range(4))
    got = _twice(lambda: temporal.temporal_attention_bwd(q, k, v, dout, 8))
    head = temporal.temporal_attention_bwd(*(t[:, :, :37].contiguous() for t in (q, k, v, dout)),
                                           8)
    for g, h in zip(got, head):
        assert torch.equal(g[:, :, :37], h)


@pytest.mark.gpu
def test_temporal_attention_bwd_refuses_units_that_do_not_fit(gen):
    """One f32 head of 1280 values over 32 frames: its operands do not fit a block's
    shared memory on either route, and the call is refused by the f32 kernel's name
    before any launch, in both directions. Over 6 frames (refused until the any route
    came) it runs."""
    q = _rand(gen, 1, 32, 4, 1280, dtype=torch.float32)
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="temporal_attention_bwd_f32.*shared memory"):
        temporal.temporal_attention_bwd(q, q, q, q, 1)
    with pytest.raises(ValueError, match="temporal_attention_fwd_f32.*shared memory"):
        temporal.temporal_attention_fwd(q, q, q, 1)
    assert _build.launches == before
    q, k, v, dout = (_rand(gen, 1, 6, 4, 1280, dtype=torch.float32) for _ in range(4))
    for g, w in zip(temporal.temporal_attention_bwd(q, k, v, dout, 1),
                    temporal.temporal_attention_bwd_plain(q, k, v, dout, 1)):
        assert _err(g, w) < F32_BOUND
    assert _launched(before) == {"temporal_attention_bwd_f32": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [320, 640, 1280])
def test_temporal_attention_runs_every_head_and_frame_count(gen, width, dtype):
    """Every (heads, F) of the grid at this width: heads that do not divide 32, head
    dims that are not a multiple of 32 / heads (D = 26, 53, 106 at 12 heads; a 12-head
    row of 636 bf16 values is 1272 bytes), F up to 32. Both kernels launch, once a
    call, within 1e-2 (bf16) or 1e-4 (f32) of the plain version's max, give the same
    bits twice, and tokens 0-10 of an L = 37 call equal an L = 11 call."""
    bound = BOUND if dtype == torch.bfloat16 else F32_BOUND
    fwd, bwd = (k + ("_f32" if dtype == torch.float32 else "")
                for k in (temporal.KERNEL_FWD, temporal.KERNEL_BWD))
    for _, heads, d, f in temporal_grid((width,)):
        hd = heads * d
        q, k, v, dout = (_rand(gen, 2, f, 37, hd, dtype=dtype) for _ in range(4))
        before = dict(_build.launches)
        out = _twice(lambda: temporal.temporal_attention_fwd(q, k, v, heads))
        want = temporal.temporal_attention_plain(*_f32([q, k, v]), heads)
        assert _err(out, want) < bound, (heads, f)
        got = _twice(lambda: temporal.temporal_attention_bwd(q, k, v, dout, heads))
        for g, w in zip(got, temporal.temporal_attention_bwd_plain(*_f32([q, k, v, dout]),
                                                                   heads)):
            assert _close(g, w, bound), (heads, f)
        assert _launched(before) == {fwd: 2, bwd: 2}, (heads, f)
        head = [t[:, :, :11].contiguous() for t in (q, k, v, dout)]
        assert torch.equal(temporal.temporal_attention_fwd(*head[:3], heads), out[:, :, :11])
        for g, h in zip(got, temporal.temporal_attention_bwd(*head, heads)):
            assert torch.equal(g[:, :, :11], h), (heads, f)


@pytest.mark.gpu
def test_temporal_attention_bwd_reads_misaligned_views(gen):
    """Operands at an address that is not 16-byte aligned (a view's offset) give the
    same bits as aligned copies."""
    q, k, v, dout = (_rand(gen, 1 + 2 * 6 * 37 * 320, dtype=torch.bfloat16)[1:].view(
        2, 6, 37, 320) for _ in range(4))
    assert q.data_ptr() % 16 != 0
    got = temporal.temporal_attention_bwd(q, k, v, dout, 8)
    want = temporal.temporal_attention_bwd(*(t.clone() for t in (q, k, v, dout)), 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("t,c", [(100, 64), (37, 128), (70, 640),
                                 # the model's widths: one row, and row counts that end
                                 # inside a 64-row (C = 320) or 32-row (C = 640) block
                                 (1, 320), (37, 320), (130, 320), (1, 640), (130, 640)])
def test_ff_ln_bwd_matches_plain(gen, t, c):
    i = 4 * c
    args = [_rand(gen, t, c), _rand(gen, t, c), 1.0 + 0.05 * _rand(gen, c, dtype=torch.float32),
            0.02 * _rand(gen, c, dtype=torch.float32), _rand(gen, 2 * i, c, scale=c ** -0.5),
            0.02 * _rand(gen, 2 * i, dtype=torch.float32), _rand(gen, c, i, scale=i ** -0.5)]
    got = geglu.ff_ln_bwd(*args)
    assert _err(got, geglu.ff_ln_bwd_plain(*_f32(args))) < BOUND
    assert torch.equal(got, geglu.ff_ln_bwd(*args))  # every sum in a fixed order


@pytest.mark.gpu
@pytest.mark.parametrize("t,i,c", [(50, 64, 32), (130, 200, 96),
                                   # the model's width: one row, rows that end inside a
                                   # 128-row tile, the mid block's T = 2400
                                   (1, 5120, 1280), (37, 5120, 1280), (130, 5120, 1280),
                                   (2400, 5120, 1280)])
def test_geglu_out_bwd_matches_plain(gen, t, i, c):
    args = [_rand(gen, t, 2 * i), _rand(gen, t, c), _rand(gen, c, i, scale=i ** -0.5)]
    assert _err(geglu.geglu_out_bwd(*args), geglu.geglu_out_bwd_plain(*_f32(args))) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("t1,t2", [(37, 130), (130, 2400)])
def test_geglu_out_bwd_repeats_and_rows_do_not_depend_on_t(gen, t1, t2):
    """The same bits twice, and rows 0..t1-1 of a t2-row call equal a t1-row call."""
    h2, g, w = _rand(gen, t2, 10240), _rand(gen, t2, 1280), _rand(gen, 1280, 5120,
                                                                  scale=5120 ** -0.5)
    got = _twice(lambda: geglu.geglu_out_bwd(h2, g, w))
    assert torch.equal(got[:t1], geglu.geglu_out_bwd(h2[:t1].clone(), g[:t1].clone(), w))


@pytest.mark.gpu
def test_feed_forward_functions_give_parameter_gradients_on_request(gen):
    """Behind their autograd.Functions the kernels give dx; parameters that ask get their
    gradient from plain ops, the others none."""
    t, c = 64, 64
    i = 4 * c
    x = _rand(gen, t, c).requires_grad_()
    params = [1.0 + 0.05 * _rand(gen, c), 0.02 * _rand(gen, c), _rand(gen, 2 * i, c, scale=c ** -0.5),
              0.02 * _rand(gen, 2 * i), _rand(gen, c, i, scale=i ** -0.5), 0.02 * _rand(gen, c)]
    params[4].requires_grad_()
    out = geglu.ff_ln_function(x, *params)
    dout = _rand(gen, t, c)
    dx, dwo = torch.autograd.grad(out, [x, params[4]], dout)
    ref = [t_.detach().float().requires_grad_(t_.requires_grad) for t_ in [x] + params]
    wdx, wdwo = torch.autograd.grad(geglu.ff_ln_plain(*ref), [ref[0], ref[5]], dout.float())
    assert _err(dx, wdx) < BOUND and _err(dwo, wdwo) < BOUND
    assert all(p.grad is None for p in params)


@pytest.mark.gpu
@pytest.mark.parametrize("t,c", [(100, 64), (37, 128),
                                 # one row, and row counts that end inside a 64-row block
                                 (1, 64), (130, 64), (1, 320), (37, 320), (130, 320),
                                 (1, 640), (37, 640), (130, 640)])
def test_ff_ln_matches_plain(gen, t, c):
    i = 4 * c
    args = [_rand(gen, t, c), 1.0 + 0.05 * _rand(gen, c, dtype=torch.float32),
            0.02 * _rand(gen, c, dtype=torch.float32), _rand(gen, 2 * i, c, scale=c ** -0.5),
            0.02 * _rand(gen, 2 * i, dtype=torch.float32), _rand(gen, c, i, scale=i ** -0.5),
            0.02 * _rand(gen, c, dtype=torch.float32)]
    got = geglu.ff_ln(*args)
    assert _err(got, geglu.ff_ln_plain(*_f32(args))) < BOUND
    assert torch.equal(got, geglu.ff_ln(*args))  # every sum in a fixed order


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, BOUND), (torch.float32, F32_BOUND)])
@pytest.mark.parametrize("t,c", [(130, 64), (37, 320), (130, 640)])
def test_ff_ln_without_residual_matches_plain(gen, t, c, dtype, bound):
    """A tensor-parallel rank's partial product (I / 2 of the weights): the
    kernel's epilogue leaves x out, bf16 ``ff_ln`` and ``ff_ln_f32`` alike."""
    i = 4 * c // 2
    args = [_rand(gen, t, c, dtype=dtype), 1.0 + 0.05 * _rand(gen, c, dtype=torch.float32),
            0.02 * _rand(gen, c, dtype=torch.float32),
            _rand(gen, 2 * i, c, scale=c ** -0.5, dtype=dtype),
            0.02 * _rand(gen, 2 * i, dtype=torch.float32),
            _rand(gen, c, i, scale=i ** -0.5, dtype=dtype),
            0.02 * _rand(gen, c, dtype=torch.float32)]
    got = geglu.ff_ln(*args, residual=False)
    assert _err(got, geglu.ff_ln_plain(*_f32(args), residual=False)) < bound
    assert torch.equal(got, geglu.ff_ln(*args, residual=False))


@pytest.mark.gpu
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("lkv", [256, 77])
def test_ring_hops_match_one_whole_kv_call(gen, sp, lkv):
    """``ring.ring_step`` over sp K/V blocks, the exchange played by the
    order of the blocks (replicated KV where Lkv does not divide), against
    one ``flash_attention_fwd`` over the whole KV, with a bias; the ring's
    rows and the whole-KV call each against ``flash_attention_plain``."""
    from eeg2video_tpu_torch.ops import ring

    heads, lq = 2, 128
    q, k, v = _rand(gen, 2, lq, 80), _rand(gen, 2, lkv, 80), _rand(gen, 2, lkv, 80)
    bias = _rand(gen, 2, 1, lkv, dtype=torch.float32)
    want = attention.flash_attention_plain(*_f32([q, k, v]), heads, bias0=bias)
    assert _err(attention.flash_attention_fwd(q, k, v, heads, bias0=bias), want) < BOUND
    blocks = [(k, v, bias)]  # replicated KV: one block, one launch a rank
    if lkv % sp == 0:
        w = lkv // sp
        blocks = [(k[:, j * w:(j + 1) * w].contiguous(), v[:, j * w:(j + 1) * w].contiguous(),
                   bias[..., j * w:(j + 1) * w].contiguous()) for j in range(sp)]
    outs = []
    for r in range(sp):  # rank r holds block (r + t) % sp at hop t
        out = lse = None
        for kb, vb, bb in blocks[r:] + blocks[:r]:
            out, lse = ring.ring_step(out, lse, q[:, r * lq // sp:(r + 1) * lq // sp], kb, vb,
                                      bb, heads, 40 ** -0.5)
        outs.append(out.to(q.dtype))
    assert _err(torch.cat(outs, dim=1), want) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, BOUND), (torch.float32, F32_BOUND)])
@pytest.mark.parametrize("t,c,tp", [(130, 64, 2), (37, 320, 4), (130, 640, 2)])
def test_ff_ln_bwd_without_residual_matches_plain(gen, t, c, tp, dtype, bound):
    """The gradient of a tensor-parallel rank's partial product (I / tp of
    the weights): ``ff_ln_bwd`` and ``ff_ln_bwd_f32`` leave the residual's g
    out of dx, and the differentiable residual-free ``feed_forward`` launches
    the kernel once in its backward, with the same bits."""
    i = 4 * c // tp
    args = [_rand(gen, t, c, dtype=dtype), _rand(gen, t, c, dtype=dtype),
            1.0 + 0.05 * _rand(gen, c, dtype=torch.float32),
            0.02 * _rand(gen, c, dtype=torch.float32),
            _rand(gen, 2 * i, c, scale=c ** -0.5, dtype=dtype),
            0.02 * _rand(gen, 2 * i, dtype=torch.float32),
            _rand(gen, c, i, scale=i ** -0.5, dtype=dtype)]
    got = geglu.ff_ln_bwd(*args, residual=False)
    assert _err(got, geglu.ff_ln_bwd_plain(*_f32(args), residual=False)) < bound
    assert torch.equal(got, geglu.ff_ln_bwd(*args, residual=False))
    kernel = "ff_ln_bwd" if dtype == torch.bfloat16 else "ff_ln_bwd_f32"
    x = args[0].detach().requires_grad_()
    before = _build.launches[kernel]
    geglu.feed_forward(x, *args[2:], torch.zeros_like(args[2]), residual=False).backward(args[1])
    assert _build.launches[kernel] - before == 1 and torch.equal(x.grad, got)


@pytest.mark.gpu
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("lkv", [256, 77])
def test_ring_backward_hops_match_the_plain_backward(gen, sp, lkv):
    """``ring.ring_bwd_step`` over sp K/V blocks against the global (out,
    lse) of the ring's forward, the rotating dk / dv / dbias accumulators
    played by indexing them by block (replicated KV: one block, the ranks'
    partials summed), against ``flash_attention_bwd_plain`` on the whole KV."""
    from eeg2video_tpu_torch.ops import ring

    heads, lq, scale = 2, 128, 40 ** -0.5
    q, k, v, dout = (_rand(gen, 2, n, 80) for n in (lq, lkv, lkv, lq))
    bias = _rand(gen, 2, 1, lkv, dtype=torch.float32)
    out, lse = attention.flash_attention_plain(*_f32([q, k, v]), heads, bias0=bias,
                                               return_lse=True)
    want = attention.flash_attention_bwd_plain(*_f32([q, k, v]), heads, dout.float(), out, lse,
                                               bias0=bias, need_dbias=True)
    blocks = [(k, v, bias)]
    if lkv % sp == 0:
        w = lkv // sp
        blocks = [(k[:, j * w:(j + 1) * w].contiguous(), v[:, j * w:(j + 1) * w].contiguous(),
                   bias[..., j * w:(j + 1) * w].contiguous()) for j in range(sp)]
    acc = [[torch.zeros(t.shape, device="cuda") for t in blk] for blk in blocks]
    before = _build.launches["flash_attention_bwd"]
    dqs = []
    for r in range(sp):
        rows = slice(r * lq // sp, (r + 1) * lq // sp)
        qr, dr = q[:, rows].contiguous(), dout[:, rows].contiguous()
        o = l_ = None
        for kb, vb, bb in blocks[r:] + blocks[:r]:
            o, l_ = ring.ring_step(o, l_, qr, kb, vb, bb, heads, scale)
        dq = torch.zeros(qr.shape, device="cuda")
        for t in range(len(blocks)):
            j = (r + t) % len(blocks)
            dq_p, *parts = ring.ring_bwd_step(qr, *blocks[j], dr, o.to(q.dtype), l_, heads,
                                              scale)
            dq += dq_p.float()
            for a, p in zip(acc[j], parts):
                a += p.float()
        dqs.append(dq)
    assert _build.launches["flash_attention_bwd"] - before == sp * len(blocks)
    got = [torch.cat(dqs, dim=1), torch.cat([a[0] for a in acc], dim=1),
           torch.cat([a[1] for a in acc], dim=1), torch.cat([a[2] for a in acc], dim=-1)]
    for g, w in zip(got, (want[0], want[1], want[2], want[5])):
        assert _err(g, w) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("t,i,c", [(50, 64, 40), (130, 256, 200)])
def test_geglu_out_matches_plain(gen, t, i, c):
    args = [_rand(gen, t, 2 * i), _rand(gen, c, i, scale=i ** -0.5),
            0.02 * _rand(gen, c, dtype=torch.float32)]
    assert _err(geglu.geglu_out(*args), geglu.geglu_out_plain(*_f32(args))) < BOUND


def _geglu_args(gen, t, i=5120, c=1280):
    return [_rand(gen, t, 2 * i), _rand(gen, c, i, scale=i ** -0.5),
            0.02 * _rand(gen, c, dtype=torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1728, 37])  # the main shape; rows that end inside a block
def test_geglu_out_at_model_width_matches_plain_and_repeats(gen, t):
    args = _geglu_args(gen, t)
    got = geglu.geglu_out(*args)
    assert _err(got, geglu.geglu_out_plain(*_f32(args))) < BOUND
    assert torch.equal(got, geglu.geglu_out(*args))  # every sum in a fixed order


@pytest.mark.gpu
def test_geglu_out_rows_do_not_depend_on_t(gen):
    """A clip's rows give the same bits alone (T = 1728) and beside another clip's (3456)."""
    h2, w, b = _geglu_args(gen, 3456)
    both = geglu.geglu_out(h2, w, b)
    assert torch.equal(both[:1728], geglu.geglu_out(h2[:1728].clone(), w, b))


@pytest.mark.gpu
def test_geglu_out_function_gradient_is_the_backward_kernel(gen):
    """Behind its autograd.Function the forward is the geglu_out kernel and dh2 is
    geglu_out_bwd's, bit for bit; both agree with autograd through the plain version."""
    h2, w, b = _geglu_args(gen, 130, 256, 192)  # C % 32 == 0 for the backward kernel
    h2.requires_grad_()
    out = geglu.geglu_out_function(h2, w, b)
    dout = _rand(gen, *out.shape)
    (dh2,) = torch.autograd.grad(out, [h2], dout)
    assert torch.equal(out, geglu.geglu_out(h2.detach(), w, b))
    assert torch.equal(dh2, geglu.geglu_out_bwd(h2.detach(), dout, w))
    ref = h2.detach().float().requires_grad_()
    (want,) = torch.autograd.grad(geglu.geglu_out_plain(ref, w.float(), b), [ref], dout.float())
    assert _err(dh2, want) < BOUND


def _conv_args(gen, n, h, w, cin, cout, temb):
    return [_rand(gen, n, h, w, cin), _rand(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
            0.02 * _rand(gen, cout, dtype=torch.float32),
            torch.rand(n, cin, generator=gen, device="cuda") + 0.5,
            _rand(gen, n, cin, scale=0.5, dtype=torch.float32),
            _rand(gen, n, cout, dtype=torch.float32) if temb else None]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,cin,cout,stats,temb", [
    (2, 5, 6, 8, 16, False, True),      # Cin and Cout below one tile, ragged M
    (3, 10, 10, 128, 64, False, False),  # images smaller than a tile, two Cin chunks
    (2, 8, 8, 8, 16, True, True),       # stats: two tiles per image
    (3, 8, 16, 128, 64, True, False),   # stats: two tiles per image, added in order
    (1, 7, 9, 40, 72, False, True),     # Cout = 72: a tail of the 160-channel block
    # 4 x 64 tiles: past the right edge of a 32-wide image, stats and temb
    (2, 12, 32, 320, 320, True, True),
    # 48-wide rows end inside a tile, and H % 4 = 2 rows of the last tiles
    (2, 10, 48, 64, 72, True, True),
    (12, 36, 64, 640, 320, False, True),  # Cin = 640 with temb: the skip split's ha
    (12, 36, 64, 320, 320, True, False),  # the main shape with stats
])
def test_conv3x3_matches_plain(gen, n, h, w, cin, cout, stats, temb):
    args = _conv_args(gen, n, h, w, cin, cout, temb)
    got = conv2d.conv3x3_gn_silu(*args, with_stats=stats)
    want = conv2d.conv3x3_gn_silu_plain(*_f32(args), with_stats=stats)
    for g, wnt in zip(got if stats else [got], want if stats else [want]):
        assert _err(g, wnt) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("cin,temb", [(320, True), (640, True), (320, False)])
def test_conv3x3_images_do_not_depend_on_the_batch(gen, cin, temb):
    """Images 0-11 alone (N = 12) and inside an N = 24 launch: the same output
    and stats bits (tiles never cross an image; partials added in tile order)."""
    args = _conv_args(gen, 24, 36, 64, cin, 320, temb)
    x, w, b, scale, shift, tb = args
    alone = [x[:12], w, b, scale[:12], shift[:12], None if tb is None else tb[:12]]
    out24, stats24 = conv2d.conv3x3_gn_silu(*args, with_stats=True)
    out12, stats12 = conv2d.conv3x3_gn_silu(*alone, with_stats=True)
    assert torch.equal(out12, out24[:12]) and torch.equal(stats12, stats24[:12])


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,cin,stats,temb", [
    (12, 36, 64, 320, True, True), (12, 36, 64, 640, False, True), (2, 10, 48, 64, True, False)])
def test_conv3x3_repeats_bit_for_bit(gen, n, h, w, cin, stats, temb):
    args = _conv_args(gen, n, h, w, cin, 320, temb)
    first = conv2d.conv3x3_gn_silu(*args, with_stats=stats)
    again = conv2d.conv3x3_gn_silu(*args, with_stats=stats)
    for a, b in zip(first if stats else [first], again if stats else [again]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,bn", [
    (1, 310, 700, 512),       # one row, K and N padded (320, 1024)
    (100, 1000, 3000, 512),   # the serving chunk's rows; K split, the last block finishes
    (113, 96, 130, 512),      # two row blocks of 104, the second with 9 rows; two K slabs
    (7, 4100, 33000, 512),    # 33 clusters of column tiles: no split, epilogue in the kernel
    (1, 10000, 10000, 512),   # the middle layer at one row: K = 10016 ends inside a slab
    (7, 10000, 10000, 512),
    (100, 10000, 10000, 512),
    (200, 10000, 10000, 512),  # two row blocks of 104
    (100, 320, 10000, 512),   # the first layer's K = 320: 5 slabs over 3 splits
    (113, 310, 10000, 512),
    (100, 20, 200, 256),      # one K step (Kp = 32) and one column tile (Np = 256)
    (7, 64, 100, 128),        # half a column tile (Np = 128), one slab
    (37, 640, 1200, 256),     # 5 tiles in 2 clusters: 3 blocks past Np
    (1, 4096, 100, 128),      # Np = 128, K split 8 ways: the finisher's tile half past Np,
                              # the cluster's other three tiles wholly past it
    (7, 10000, 77 * 768, 512),  # the out layer (Np = 59392, 232 tiles): a ragged last wave
    (100, 10000, 77 * 768, 512),
])
def test_int8_dense_matches_plain(gen, m, k, n, bn):
    w = _rand(gen, k, n, scale=k ** -0.5, dtype=torch.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 0
    w_q, scale = int8_dense.quantize_int8(w, bn=bn)
    del w
    bias = _rand(gen, n, scale=0.1, dtype=torch.float32)
    x = _rand(gen, m, k, dtype=torch.float32)
    got = int8_dense.int8_dense(x, w_q, scale, bias, n)
    want = int8_dense.int8_dense_plain(x, w_q, scale, bias, n)
    assert got.shape == (m, n) and got.dtype == torch.float32
    # same bf16 operands and f32 accumulation: only the summation order differs
    assert _err(got, want) < 1e-4
    assert torch.equal(got[:, 3], bias[3].expand(m))  # the zero column: its bias alone
    again = int8_dense.int8_dense(x, w_q, scale, bias, n)
    assert torch.equal(got, again)  # fixed-order split-K sum: same bits every run


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(10000, 10000), (310, 10000), (10000, 77 * 768)])
@pytest.mark.parametrize("m_few,m_many", [(7, 100), (1, 7), (100, 200)])
def test_int8_dense_rows_do_not_depend_on_m(gen, k, n, m_few, m_many):
    """Rows 0 .. m_few - 1 of an m_many-row call equal an m_few-row call bit for
    bit: the split of K comes from the weight's shape alone, and the wgmma widths
    (8 at 1 and 7 rows, 104 at 100 and in each of 200's two row blocks) give
    each row the same bits."""
    w = _rand(gen, k, n, scale=k ** -0.5, dtype=torch.float32)
    w_q, scale = int8_dense.quantize_int8(w)
    del w
    bias = _rand(gen, n, scale=0.1, dtype=torch.float32)
    x = _rand(gen, m_many, k, dtype=torch.float32)
    many = int8_dense.int8_dense(x, w_q, scale, bias, n)
    few = int8_dense.int8_dense(x[:m_few].clone(), w_q, scale, bias, n)
    assert torch.equal(many[:m_few], few)


@pytest.mark.gpu
def test_int8_dense_rejects_what_the_kernel_does_not_take(gen):
    w_q, scale = int8_dense.quantize_int8(_rand(gen, 64, 256, dtype=torch.float32))
    bias = torch.zeros(256, device="cuda")
    x = _rand(gen, 4, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        int8_dense.int8_dense(x.bfloat16(), w_q, scale, bias, 256)
    with pytest.raises(ValueError, match="Kp"):
        int8_dense.int8_dense(_rand(gen, 4, 65, dtype=torch.float32), w_q, scale, bias, 256)
    with pytest.raises(ValueError, match="device"):
        int8_dense.int8_dense(x, w_q, scale.cpu(), bias, 256)


# --- the f32 counterparts (f32 operands) --------------------------------------


def _r32(gen, *shape, scale=1.0):
    return _rand(gen, *shape, scale=scale, dtype=torch.float32)


def _twice(fn):
    """fn's result, after checking that a second run gives the same bits."""
    first, again = fn(), fn()
    pairs = zip(*(r if isinstance(r, (tuple, list)) else [r] for r in (first, again)))
    assert all(a is None and b is None or torch.equal(a, b) for a, b in pairs)
    return first


def _launched(before):
    return {k: n - before[k] for k, n in _build.launches.items() if n != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,lq,lkv0,lkv1,hd,heads,bias", [
    (2, 1, 40, 77, 0, 64, 8, True),       # D = 8: Lq 40 against Lkv 77, bias
    (2, 2, 77, 40, 40, 320, 8, True),     # D = 40: two segments, dk0 over m = 2
    (1, 1, 300, 450, 0, 640, 8, False),   # D = 80: 300 x 450
    (2, 3, 77, 77, 40, 1280, 8, True),    # D = 160: two segments, m = 3, bias
    (1, 1, 1, 3, 0, 64, 8, True),         # one query row against three keys
    (1, 2, 1030, 1030, 70, 320, 8, True),  # 17 tiles, the last of 6 rows
    (1, 4, 130, 130, 70, 320, 8, True),   # the model's m = 4 at D = 40, ragged tiles
    (2, 2, 150, 97, 41, 640, 8, False),   # D = 80, two segments, ragged tiles
])
def test_flash_attention_f32_matches_plain(gen, n, m, lq, lkv0, lkv1, hd, heads, bias):
    q = _r32(gen, n, m, lq, hd) if m > 1 else _r32(gen, n, lq, hd)
    k0, v0 = _r32(gen, n, lkv0, hd), _r32(gen, n, lkv0, hd)
    k1 = _r32(gen, n, m, lkv1, hd) if lkv1 else None
    v1 = _r32(gen, n, m, lkv1, hd) if lkv1 else None
    b0 = _r32(gen, n, 1, lkv0, scale=2.0) if bias else None
    seg = dict(k1=k1, v1=v1, bias0=b0)
    before = dict(_build.launches)
    out, lse = _twice(lambda: attention.flash_attention_fwd(q, k0, v0, heads, **seg,
                                                            return_lse=True))
    want, wlse = attention.flash_attention_plain(q, k0, v0, heads, **seg, return_lse=True)
    assert _err(out, want) < F32_BOUND and _err(lse, wlse) < F32_BOUND
    dout = _r32(gen, *q.shape)
    got = _twice(lambda: attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, **seg,
                                                       need_dbias=bias))
    want = attention.flash_attention_bwd_plain(q, k0, v0, heads, dout, out, lse, **seg,
                                               need_dbias=bias)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == w.shape and _err(g, w) < F32_BOUND
    expected = {"flash_attention_fwd_f32": 2, "flash_attention_bwd_f32": 2}
    if bias:
        expected["flash_attention_bwd_dbias_f32"] = 2
    assert _launched(before) == expected


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lkv,d", [
    (1, 2, 300, 450, 40), (2, 8, 77, 40, 8), (2, 8, 144, 77, 80), (2, 8, 40, 144, 160)])
def test_fused_attention_f32_matches_plain(gen, b, h, lq, lkv, d):
    q, k, v, dout = _r32(gen, b, h, lq, d), _r32(gen, b, h, lkv, d), _r32(gen, b, h, lkv, d), \
        _r32(gen, b, h, lq, d)
    before = dict(_build.launches)
    out, lse = _twice(lambda: attention.fused_attention_fwd(q, k, v, return_lse=True))
    want, wlse = attention.fused_attention_plain(q, k, v, return_lse=True)
    assert _err(out, want) < F32_BOUND and _err(lse, wlse) < F32_BOUND
    got = _twice(lambda: attention.fused_attention_bwd(q, k, v, dout, out, lse))
    for g, w in zip(got, attention.fused_attention_bwd_plain(q, k, v, dout, out, lse)):
        assert _err(g, w) < F32_BOUND
    assert _launched(before) == {"fused_attention_fwd_f32": 2, "fused_attention_bwd_f32": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,l,hd,heads", [
    (2, 6, 50, 320, 8), (1, 3, 33, 32, 4), (2, 2, 7, 1280, 8), *TEMPORAL_MODEL_CASES])
def test_temporal_attention_f32_matches_plain(gen, b, f, l, hd, heads):
    q, k, v, dout = (_r32(gen, b, f, l, hd) for _ in range(4))
    before = dict(_build.launches)
    got = _twice(lambda: temporal.temporal_attention_fwd(q, k, v, heads))
    assert _err(got, temporal.temporal_attention_plain(q, k, v, heads)) < F32_BOUND
    got = _twice(lambda: temporal.temporal_attention_bwd(q, k, v, dout, heads))
    for g, w in zip(got, temporal.temporal_attention_bwd_plain(q, k, v, dout, heads)):
        assert _close(g, w, F32_BOUND)
    assert _launched(before) == {"temporal_attention_fwd_f32": 2,
                                 "temporal_attention_bwd_f32": 2}


def _ff_args(gen, t, c, dtype):
    i = 4 * c
    vec = lambda *s, scale=1.0: _rand(gen, *s, scale=scale, dtype=torch.float32)  # noqa: E731
    return [_rand(gen, t, c, dtype=dtype), 1.0 + 0.05 * vec(c), 0.02 * vec(c),
            _rand(gen, 2 * i, c, scale=c ** -0.5, dtype=dtype), 0.02 * vec(2 * i),
            _rand(gen, c, i, scale=i ** -0.5, dtype=dtype), 0.02 * vec(c)]


@pytest.mark.gpu
@pytest.mark.parametrize("c", [32, 320, 640, 16, 96, 336])
@pytest.mark.parametrize("t", [1, 37, 130, 127, 129, 255])
def test_ff_ln_f32_matches_plain(gen, t, c):
    """T around the kernels' 128-row tiles, C = 16 / 96 / 336 inside their
    32-wide k slabs and 160-column out tiles."""
    args = _ff_args(gen, t, c, torch.float32)
    g = _r32(gen, t, c)
    before = dict(_build.launches)
    got = _twice(lambda: geglu.ff_ln(*args))
    assert _err(got, geglu.ff_ln_plain(*args)) < F32_BOUND
    got = _twice(lambda: geglu.ff_ln_bwd(args[0], g, *args[1:6]))
    assert _err(got, geglu.ff_ln_bwd_plain(args[0], g, *args[1:6])) < F32_BOUND
    assert _launched(before) == {"ff_ln_f32": 2, "ff_ln_bwd_f32": 2}


@pytest.mark.gpu
def test_ff_ln_f32_takes_zero_rows(gen):
    """T = 0: empty outputs of the input's shape, nothing launched on the card."""
    args = _ff_args(gen, 0, 320, torch.float32)
    assert geglu.ff_ln(*args).shape == (0, 320)
    assert geglu.ff_ln_bwd(args[0], args[0], *args[1:6]).shape == (0, 320)


@pytest.mark.gpu
def test_ff_ln_f32_rows_do_not_depend_on_t(gen):
    """The first 128 rows of a T = 256 call, forward and backward, have the
    bits of a T = 128 call on those rows."""
    args = _ff_args(gen, 256, 320, torch.float32)
    g = _r32(gen, 256, 320)
    head = [args[0][:128].clone(), *args[1:]]
    assert torch.equal(geglu.ff_ln(*args)[:128], geglu.ff_ln(*head))
    assert torch.equal(geglu.ff_ln_bwd(args[0], g, *args[1:6])[:128],
                       geglu.ff_ln_bwd(head[0], g[:128].clone(), *args[1:6]))


def _geglu_f32_args(gen, t, i=5120, c=1280):
    """h2 (t, 2I), W (C, I), b (C) and the output's gradient g (t, C), f32."""
    return (_r32(gen, t, 2 * i), _r32(gen, c, i, scale=i ** -0.5), 0.02 * _r32(gen, c),
            _r32(gen, t, c))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 37, 130, 127, 128, 129, 255, 1728])
def test_geglu_out_f32_matches_plain(gen, t):
    """The model's I = 5120, C = 1280 at row counts around the kernels'
    128-row tiles and at one clip's level 2 (T = 1728)."""
    h2, w, b, g = _geglu_f32_args(gen, t)
    before = dict(_build.launches)
    assert _err(_twice(lambda: geglu.geglu_out(h2, w, b)), geglu.geglu_out_plain(h2, w, b)) \
        < F32_BOUND
    assert _err(_twice(lambda: geglu.geglu_out_bwd(h2, g, w)),
                geglu.geglu_out_bwd_plain(h2, g, w)) < F32_BOUND
    assert _launched(before) == {"geglu_out_f32": 2, "geglu_out_bwd_f32": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("i,c", [(64, 8), (64, 40), (192, 8), (192, 40), (64, 1288)])
@pytest.mark.parametrize("t", [37, 130])
def test_geglu_out_f32_tile_edges_match_plain(gen, t, i, c):
    """The forward off its 160-column out tiles and at one or six 32-wide k
    slabs (I = 64, 192; C = 8, 40, 1288)."""
    h2, w, b, _ = _geglu_f32_args(gen, t, i, c)
    assert _err(_twice(lambda: geglu.geglu_out(h2, w, b)), geglu.geglu_out_plain(h2, w, b)) \
        < F32_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("i,c", [(64, 32), (64, 96), (192, 32), (192, 96), (200, 96)])
@pytest.mark.parametrize("t", [37, 130])
def test_geglu_out_bwd_f32_tile_edges_match_plain(gen, t, i, c):
    """The backward off its 160-column dgated tiles (I = 64, 192, 200) and at
    one or three 32-wide k slabs (C = 32, 96)."""
    h2, w, _, g = _geglu_f32_args(gen, t, i, c)
    assert _err(_twice(lambda: geglu.geglu_out_bwd(h2, g, w)),
                geglu.geglu_out_bwd_plain(h2, g, w)) < F32_BOUND


@pytest.mark.gpu
def test_geglu_out_f32_takes_zero_rows(gen):
    """T = 0: empty outputs of the right shape, nothing launched on the card."""
    h2, w, b, g = _geglu_f32_args(gen, 0)
    before = dict(_build.launches)
    assert geglu.geglu_out(h2, w, b).shape == (0, 1280)
    assert geglu.geglu_out_bwd(h2, g, w).shape == (0, 10240)
    assert _launched(before) == {}


@pytest.mark.gpu
@pytest.mark.parametrize("t1,t2", [(37, 130), (128, 256)])
def test_geglu_out_f32_rows_do_not_depend_on_t(gen, t1, t2):
    """The first t1 rows of a t2-row call, forward and backward, have the bits
    of a t1-row call on those rows."""
    h2, w, b, g = _geglu_f32_args(gen, t2)
    head, ghead = h2[:t1].clone(), g[:t1].clone()
    assert torch.equal(geglu.geglu_out(h2, w, b)[:t1], geglu.geglu_out(head, w, b))
    assert torch.equal(geglu.geglu_out_bwd(h2, g, w)[:t1], geglu.geglu_out_bwd(head, ghead, w))


@pytest.mark.gpu
def test_geglu_out_f32_reads_misaligned_views(gen):
    """h2, W, b and g at addresses that are not 16-byte aligned (a view's
    offset) give the bits of aligned copies, both directions."""
    t, i, c = 37, 192, 96

    def view(*shape, scale=1.0):
        n = int(np.prod(shape))
        return (_r32(gen, n + 1, scale=scale)[1:]).view(*shape)

    h2, w, b, g = view(t, 2 * i), view(c, i, scale=i ** -0.5), view(c), view(t, c)
    assert all(x.data_ptr() % 16 != 0 for x in (h2, w, b, g))
    aligned = [x.clone() for x in (h2, w, b, g)]
    assert torch.equal(geglu.geglu_out(h2, w, b), geglu.geglu_out(*aligned[:3]))
    assert torch.equal(geglu.geglu_out_bwd(h2, g, w),
                       geglu.geglu_out_bwd(aligned[0], aligned[3], aligned[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [32, 96])
@pytest.mark.parametrize("t", [37, 130])
def test_ff_ln_bf16_pads_narrow_widths(gen, t, c):
    """C % 64 != 0 (the tiny configs' C = 32) runs the bf16 kernels on operands
    zero-padded to 64 columns, LayerNorm over the true C."""
    args = _ff_args(gen, t, c, torch.bfloat16)
    g = _rand(gen, t, c)
    before = dict(_build.launches)
    got = _twice(lambda: geglu.ff_ln(*args))
    assert got.shape == (t, c) and _err(got, geglu.ff_ln_plain(*_f32(args))) < BOUND
    got = _twice(lambda: geglu.ff_ln_bwd(args[0], g, *args[1:6]))
    want = geglu.ff_ln_bwd_plain(*_f32([args[0], g, *args[1:6]]))
    assert got.shape == (t, c) and _err(got, want) < BOUND
    assert _launched(before) == {"ff_ln": 2, "ff_ln_bwd": 2}


def _tiny_unet(dtype, cross_dim=16):
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    cfg = dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=cross_dim)
    g = torch.Generator(device="cuda").manual_seed(4)
    return random_init_(UNet3DConditionModel(cfg).to("cuda"), g).to(dtype).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_refuses_heads_wider_than_160(gen, dtype):
    """A settled divergence: no configuration has D > 160, and the kernels
    refuse it by name (the JAX kernels have no such limit)."""
    q = _rand(gen, 1, 16, 8 * 168, dtype=dtype)
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="head_dim 168 must be a multiple of 8 and <= 160"):
        attention.flash_attention_fwd(q, q, q, 8)
    assert _build.launches == before


@pytest.mark.gpu
def test_f32_unet_forward_launches_only_f32_kernels(gen):
    """An f32 UNet3DConfig.tiny() forward: every attention and feed-forward
    call on the f32 kernels, no bf16 kernel and no conv kernel (JAX sends f32
    convs to XLA)."""
    unet = _tiny_unet(torch.float32)
    sample, ctx = _r32(gen, 2, 6, 16, 16, 4), _r32(gen, 2, 77, 16)
    before = dict(_build.launches)
    with torch.inference_mode():
        out = unet(sample, torch.tensor([10, 900], device="cuda"), ctx)
    torch.cuda.synchronize()
    launched = _launched(before)
    assert out.shape == sample.shape and bool(torch.isfinite(out).all())
    assert set(launched) == {"flash_attention_fwd_f32", "ff_ln_f32"}, launched


@pytest.mark.gpu
def test_bf16_tiny_unet_forward_runs_ff_ln_at_c32(gen):
    """UNet3DConfig.tiny() in bf16 on the card: C = 32 through the padded ff_ln."""
    unet = _tiny_unet(torch.bfloat16)
    sample, ctx = _rand(gen, 2, 6, 16, 16, 4), _rand(gen, 2, 77, 16)
    before = dict(_build.launches)
    with torch.inference_mode():
        out = unet(sample, torch.tensor([10, 900], device="cuda"), ctx)
    launched = _launched(before)
    assert bool(torch.isfinite(out.float()).all())
    assert launched.get("ff_ln", 0) > 0 and launched.get("flash_attention_fwd", 0) > 0
    assert not any(k.endswith("_f32") for k in launched)


@pytest.mark.gpu
def test_f32_server_answers_through_f32_kernels(gen, monkeypatch, tmp_path):
    """``serve --dtype float32`` on a tiny pipeline: one embeddings request
    answered, its GIF written, through the f32 kernels only."""
    from eeg2video_tpu_torch.cli import serve
    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.models.vae import VAEConfig

    def load(unet, vae, dtype="bfloat16", device="cuda"):
        cfg = dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768)
        pipe = EEG2VideoPipeline.create(None, None, cfg, VAEConfig.tiny(),
                                        dtype=getattr(torch, dtype), device=device)
        g = torch.Generator(device=device).manual_seed(5)
        random_init_(pipe.unet, g)
        random_init_(pipe.vae, g)
        return pipe

    emb = tmp_path / "emb.npy"
    np.save(emb, np.random.default_rng(6).standard_normal((2, 77 * 768)).astype(np.float32))
    monkeypatch.setattr(serve, "load_pipeline", load)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        json.dumps({"id": "e", "embeddings": str(emb), "indices": [1]}) + "\n"
        + json.dumps({"cmd": "shutdown"}) + "\n"))
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    before = dict(_build.launches)
    rc = serve.main(["--dtype", "float32", "--device", "cuda", "--height", "32", "--width", "32",
                     "--video_length", "2", "--num_inference_steps", "2",
                     "--gif_encoder", "native", "--out_dir", str(tmp_path / "out")])
    monkeypatch.undo()
    replies = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    launched = _launched(before)
    assert rc == 0 and replies[1]["ok"] and replies[1]["id"] == "e", replies
    assert list((tmp_path / "out").rglob("*.gif"))
    assert set(launched) == {"flash_attention_fwd_f32", "ff_ln_f32"}, launched


# --- the training recipe's eager paths on the card against the CPU --------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(10000, 59136), ()])
def test_adam8bit_update_on_the_card_equals_the_cpu(gen, shape):
    """One 8-bit step from the same state and gradient (a second step, so the
    stored codes and scales are in play) on the card and on the CPU: codes at
    most 1 apart, parameters within 1e-6 of the step's largest update."""
    from eeg2video_tpu_torch.train.optim import adam8_update

    p = torch.randn(shape, generator=gen, device="cuda")
    g1 = torch.randn(shape, generator=gen, device="cuda")
    g2 = torch.randn(shape, generator=gen, device="cuda") * 0.3
    state = [torch.zeros(shape, dtype=torch.int8, device="cuda")] * 2
    sshape = (1,) + tuple(shape[1:]) if shape else (1,)
    state = [state[0], torch.zeros(sshape, device="cuda"), state[1], torch.zeros(sshape,
                                                                                    device="cuda")]
    _, *state = adam8_update(g1, *state, 1, 0.9, 0.999, 1e-8)
    u, *card = adam8_update(g2, *state, 2, 0.9, 0.999, 1e-8)
    cu, *cpu = adam8_update(g2.cpu(), *[s.cpu() for s in state], 2, 0.9, 0.999, 1e-8)
    for a, b in ((card[0], cpu[0]), (card[2], cpu[2])):
        assert a.dtype == torch.int8
        assert (a.cpu().int() - b.int()).abs().max().item() <= 1
    new, want = p - 1e-3 * u, p.cpu() - 1e-3 * cu
    assert (new.cpu() - want).abs().max().item() <= 1e-6 * (1e-3 * cu).abs().max().item()
    torch.testing.assert_close(card[1].cpu(), cpu[1], rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_seq2seq_train_forward_on_the_card_equals_the_cpu(gen):
    """The Seq2Seq transformer in train mode (batch statistics, dropout off)
    on the card against the same weights on the CPU: outputs, gradients and
    the updated running statistics."""
    from eeg2video_tpu_torch.models.seq2seq import Dropout, Seq2SeqTransformer

    torch.manual_seed(0)
    cpu = Seq2SeqTransformer(n_frames=2, latent_shape=(4, 4, 4)).train()
    for m in cpu.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    card = Seq2SeqTransformer(n_frames=2, latent_shape=(4, 4, 4)).train()
    card.load_state_dict(cpu.state_dict())
    card = card.cuda()
    for m in card.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    src = torch.randn(3, 7, 62, 100, generator=gen, device="cuda")
    y = torch.randn(3, 2, 4, 4, 4, generator=gen, device="cuda")
    outs = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        _, lat = model(src.to(dev))
        torch.mean((lat[:, :-1] - y.to(dev)) ** 2).backward()
        outs.append(lat.detach().cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-4)
    grads = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        if p.grad is None:
            assert grads[name].grad is None, name
            continue
        want = grads[name].grad
        assert (p.grad.cpu() - want).abs().max() <= 2e-3 * want.abs().max() + 1e-6, name
    cpu_buffers = dict(cpu.named_buffers())
    for name, b in card.named_buffers():
        torch.testing.assert_close(b.cpu(), cpu_buffers[name], rtol=1e-3, atol=1e-4)


# --- sos_filtfilt (csrc/sos_filtfilt.cu): the bandpass recursion ----------

def _iir_case(form, dtype):
    """(coefficient rows for the plain version, zi, padlen, the wrapper's
    call) of an order-4 bandpass (biquads), an order-2 one in the
    transfer-function form (stable in float32), or an order-3 lowpass in that
    form (an odd order, which the wrapper runs as order 4)."""
    from scipy import signal

    from eeg2video_tpu_torch.dsp import bandpass as bp

    if form == "sos":
        sos = bp.butter_bandpass_sos(4, 0.5, 47.0, 200.0)
        zi = bp._sos_zi(sos)
        return (torch.as_tensor(sos, dtype=dtype, device="cuda"),
                torch.as_tensor(zi, dtype=dtype, device="cuda"), 27,
                lambda x: iir.sos_filtfilt(x, sos, zi, 27))
    b, a = bp.butter_bandpass(2, 4.0, 31.0, 200.0) if form == "tf" else signal.butter(3, 0.3)
    zi, padlen = bp.lfilter_zi(b, a), 3 * len(a)
    return (torch.as_tensor(np.stack([b, a]), dtype=dtype, device="cuda"),
            torch.as_tensor(zi, dtype=dtype, device="cuda"), padlen,
            lambda x: iir.tf_filtfilt(x, b, a, zi, padlen))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["sos", "tf", "tf_odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", [1, 31, 434])
@pytest.mark.parametrize("t", ["padlen+1", 4000])
def test_sos_filtfilt_matches_plain(gen, form, dtype, rows, t):
    """Within F32_BOUND of the output's max of the plain version on the card
    (both round every product and sum on its own: they agree to the bit where
    the card's eager ops do), twice bit for bit, one launch a call."""
    coef, zi, padlen, call = _iir_case(form, dtype)
    t = padlen + 1 if t == "padlen+1" else t
    x = torch.randn(rows, t, generator=gen, device="cuda", dtype=dtype)
    kernel = "sos_filtfilt" if dtype == torch.float32 else "sos_filtfilt_f64"
    before = dict(_build.launches)
    out = call(x)
    torch.cuda.synchronize()
    assert _build.launches[kernel] == before[kernel] + 1
    assert all(_build.launches[k] == before[k] for k in before if k != kernel)
    want = iir.filtfilt_plain(x, coef, zi, padlen, tf=form != "sos")
    assert out.dtype == dtype and out.shape == x.shape
    assert _err(out, want) < F32_BOUND
    assert torch.equal(call(x), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sos_filtfilt_rows_do_not_depend_on_the_row_count(gen, dtype):
    _, _, _, call = _iir_case("sos", dtype)
    x = torch.randn(434, 4000, generator=gen, device="cuda", dtype=dtype)
    full = call(x)
    for lo, hi in ((0, 31), (31, 33), (400, 434)):
        assert torch.equal(call(x[lo:hi].contiguous()), full[lo:hi]), (lo, hi)


@pytest.mark.gpu
def test_sos_filtfilt_refuses_what_it_does_not_take(gen):
    from eeg2video_tpu_torch.dsp import bandpass as bp

    x = torch.randn(2, 500, generator=gen, device="cuda")
    sos = bp.butter_bandpass_sos(9, 1.0, 40.0, 200.0)  # 9 biquads, one more than the kernel's 8
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="sos_filtfilt: the cascade takes 1..8 biquads"):
        iir.sos_filtfilt(x, sos, bp._sos_zi(sos), 57)
    with pytest.raises(ValueError, match="sos_filtfilt: x must be float32 or float64"):
        iir.sos_filtfilt(x.half(), sos[:4], bp._sos_zi(sos[:4]), 27)
    with pytest.raises(ValueError, match="must exceed padlen"):
        iir.sos_filtfilt(x[:, :27].contiguous(), sos[:4], bp._sos_zi(sos[:4]), 27)
    assert dict(_build.launches) == before


# --- saved residuals and evaluation on the card -------------------------------------

def _narrow_step(save, dtype):
    """One forward/backward of the fine-tune loss on a narrow UNet (64, 128,
    128, 128), every block recomputed: the loss, the trainable gradients and
    the kernels launched."""
    import functools

    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from eeg2video_tpu_torch.train import videodiffusion as vd

    g = torch.Generator(device="cuda").manual_seed(7)
    unet = random_init_(UNet3DConditionModel(UNet3DConfig(block_out_channels=(64, 128, 128, 128)))
                        .to("cuda"), g)
    cfg = vd.VideoDiffusionTrainConfig(remat_min_hw=0, remat_save_attn=save,
                                       compute_dtype="float32" if dtype == torch.float32
                                       else "bfloat16")
    state = vd.init_video_train_state(unet, cfg, "cuda")
    post = torch.randn(2, 6, 16, 16, 8, generator=g, device="cuda") * 0.5
    ctx = torch.randn(2, 77, 768, generator=g, device="cuda")
    draws = dict(t=torch.tensor([10, 900], device="cuda"),
                 noise=torch.randn(2, 6, 16, 16, 4, generator=g, device="cuda"),
                 eps=torch.randn(12, 16, 16, 4, generator=g, device="cuda"))
    before = dict(_build.launches)
    loss = vd.video_loss(functools.partial(state.unet, remat_save_convs=save), None, post, ctx,
                         cfg, **draws)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), {n: p.grad for n, p in state.working.items()}, _launched(before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_saved_residuals_launch_each_forward_once_per_call_site(gen, dtype):
    """The narrow UNet's 16 transformer blocks, all recomputed: with the
    residuals kept each forward kernel launches once per call site (3
    attention calls, one feed-forward, one temporal attention a block),
    without them twice; the loss is the same bits and the gradients agree
    within the bound of the kernels."""
    sfx = "_f32" if dtype == torch.float32 else ""
    loss_s, grads_s, saved = _narrow_step(True, dtype)
    loss_r, grads_r, again = _narrow_step(False, dtype)
    for k, sites in (("flash_attention_fwd", 48), ("temporal_attention_fwd", 16)):
        assert saved[k + sfx] == sites and again[k + sfx] == 2 * sites, (k, saved, again)
    ff = saved.get("ff_ln" + sfx, 0) + saved.get("geglu_out" + sfx, 0)
    assert ff == 16 and again.get("ff_ln" + sfx, 0) + again.get("geglu_out" + sfx, 0) == 32
    for k in ("flash_attention_bwd", "temporal_attention_bwd"):
        assert saved[k + sfx] == again[k + sfx] == (48 if k.startswith("flash") else 16)
    assert torch.equal(loss_s, loss_r)
    for n in grads_s:
        assert _close(grads_s[n], grads_r[n], F32_BOUND if sfx else BOUND), n


@pytest.mark.gpu
def test_horn_schunck_on_the_card_equals_the_cpu(gen):
    from eeg2video_tpu_torch.data import optical_flow as flow

    base = torch.nn.functional.interpolate(torch.rand(1, 1, 18, 32, generator=gen, device="cuda"),
                                           size=(72 + 8, 128 + 8), mode="bilinear")[0, 0]
    i1 = torch.stack([base[4:76, 4:132]] * 3)
    i2 = torch.stack([base[4 - dy:76 - dy, 4 - dx:132 - dx] for dx, dy in ((2, 1), (-3, 2), (0, 0))])
    u, v = flow.horn_schunck(i1, i2)
    cu, cv = flow.horn_schunck(i1.cpu(), i2.cpu())
    assert float(u.abs().max()) > 1.0
    assert float((u.cpu() - cu).abs().max()) < 1e-5 and float((v.cpu() - cv).abs().max()) < 1e-5
    clips = (torch.stack([torch.stack([base[4:76, 4 + k:132 + k]] * 3, -1) for k in range(4)])
             * 255).to(torch.uint8)[None].cpu().numpy()
    got = flow.score_clips(clips, device="cuda")
    want = flow.score_clips(clips, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.gpu
def test_pixel_metrics_on_the_card_equal_the_cpu(gen):
    from eeg2video_tpu_torch.eval import metrics

    rng = np.random.default_rng(3)
    gt = rng.integers(0, 255, (5, 64, 96, 3), dtype=np.uint8)
    pred = np.clip(gt + rng.normal(0, 20, gt.shape), 0, 255).astype(np.uint8)
    for fn, tol in ((metrics.ssim_frames, dict(atol=1e-9)), (metrics._mse, dict(rtol=1e-6)),
                    (metrics._psnr, dict(rtol=1e-6)), (metrics._hue, dict(rtol=1e-5))):
        got = metrics.per_frame(fn, pred, gt, device="cuda")
        want = metrics.per_frame(fn, pred, gt, device="cpu")
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.gpu
def test_clip_text_full_width_on_the_card_equals_the_cpu(gen):
    """CLIPTextConfig() (12 layers, 768 wide) with seeded weights, f32 on the
    card (TF32 off) against the same model on the CPU: 8 prompts' ids, padded
    with eos after 20; within 1e-4 of the output's max (summation order only)."""
    from eeg2video_tpu_torch.models.clip_text import CLIPTextModel, encode_ids
    from eeg2video_tpu_torch.models.init import random_init_

    model = random_init_(CLIPTextModel(), torch.Generator().manual_seed(0)).eval()
    ids = torch.randint(0, 49406, (8, 77), generator=torch.Generator().manual_seed(1))
    ids[:, 20:] = 49407
    want = encode_ids(model, ids)
    got = encode_ids(model.to("cuda"), ids)
    assert got.shape == (8, 77, 768) and got.device.type == "cuda"
    assert _err(got.cpu(), want) < F32_BOUND


@pytest.mark.gpu
def test_one_ddim_inversion_step_launches_the_generation_kernels(gen, monkeypatch):
    """One inverse step of UNet3DConfig() in bf16 on one clip of (1, 6, 36, 64,
    4) latents: one UNet forward's launches (48 attention, 10 ff_ln, 6
    geglu_out, 13 level-0 convs) and nothing else; finite f32 latents out.
    That step's eps (batch 1, no guidance pair) against the same UNet call
    with the plain versions in the kernels' place: ||diff|| / ||plain|| within
    5e-2 (bf16 activations between the layers)."""
    from eeg2video_tpu_torch.diffusion.text_pipeline import ddim_inversion
    from eeg2video_tpu_torch.models import attention3d, resnet3d
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    with torch.device("meta"):
        unet = UNet3DConditionModel(UNet3DConfig())
    unet = random_init_(unet.to_empty(device="cuda"), gen).to(torch.bfloat16).eval()
    lat = torch.randn(1, 6, 36, 64, 4, generator=gen, device="cuda")
    ctx = torch.randn(1, 77, 768, generator=gen, device="cuda")
    before = dict(_build.launches)
    out = ddim_inversion(unet, lat, ctx, num_inv_steps=1)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_attention_fwd": 48, "ff_ln": 10, "geglu_out": 6,
                                 "conv3x3_gn_silu": 13}
    assert out.dtype == torch.float32 and out.shape == lat.shape
    assert bool(torch.isfinite(out).all()) and not torch.equal(out, lat)

    t = torch.ones(1, device="cuda", dtype=torch.int64)  # the first inverse step's t
    with torch.inference_mode():
        got = unet(lat.bfloat16(), t, ctx.bfloat16()).float()
        monkeypatch.setattr(attention3d, "flash_attention", attention.flash_attention_plain)
        monkeypatch.setattr(attention3d, "flash_attention_fwd",
                            lambda *a, out=None, **kw: out.copy_(
                                attention.flash_attention_plain(*a, **kw)))
        monkeypatch.setattr(attention3d, "feed_forward", geglu.ff_ln_plain)
        monkeypatch.setattr(resnet3d, "conv3x3_gn_silu", conv2d.conv3x3_gn_silu_plain)
        before = dict(_build.launches)
        want = unet(lat.bfloat16(), t, ctx.bfloat16()).float()
    assert _launched(before) == {}
    assert bool(torch.isfinite(got).all())
    assert ((got - want).norm() / want.norm()).item() < 5e-2
