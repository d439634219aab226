"""Port kernels (eeg2video_tpu_torch.ops) against the JAX package's Pallas
kernels.

On the CPU each wrapper takes its plain PyTorch version, so these tests hold
that plain version against the Pallas kernel run in interpret mode (the way
the JAX package's own tests run it), on the same float32 inputs made with
numpy from a seed. Tolerance: 2e-5, float32 summation-order noise at these
sizes. The CUDA kernels themselves are checked on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eeg2video_tpu.ops import attention as jattn
from eeg2video_tpu.ops import conv2d as jconv
from eeg2video_tpu.ops import geglu as jgeglu
from eeg2video_tpu_torch.ops import _build
from eeg2video_tpu_torch.ops import attention, conv2d, geglu

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("lq,lkv,with_bias", [(256, 96, False), (256, 77, True)])
def test_flash_single_matches_packed_kernel(lq, lkv, with_bias):
    rng = np.random.default_rng(0)
    n, heads, d = 2, 2, 8
    q = rng.standard_normal((n, lq, heads * d)).astype(np.float32)
    k = rng.standard_normal((n, lkv, heads * d)).astype(np.float32)
    v = rng.standard_normal((n, lkv, heads * d)).astype(np.float32)
    bias = (rng.standard_normal((n, 1, lkv)) * 2).astype(np.float32) if with_bias else None
    ref = jattn.fused_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads, bias=None if bias is None else jnp.asarray(bias))
    out = attention.flash_attention_fwd(_t(q), _t(k), _t(v), heads,
                                        bias0=None if bias is None else _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_dual_matches_dual_kernel(with_bias):
    rng = np.random.default_rng(1)
    b, m, l, heads, d = 2, 2, 256, 2, 8
    hd = heads * d
    q = rng.standard_normal((b * m, l, hd)).astype(np.float32)
    k0 = rng.standard_normal((b, l, hd)).astype(np.float32)
    v0 = rng.standard_normal((b, l, hd)).astype(np.float32)
    k1 = rng.standard_normal((b * m, l, hd)).astype(np.float32)
    v1 = rng.standard_normal((b * m, l, hd)).astype(np.float32)
    bias = (rng.standard_normal((b, 1, l)) * 2).astype(np.float32) if with_bias else None
    ref = jattn.fused_attention_dual(*map(jnp.asarray, (q, k0, v0, k1, v1)), heads, m,
                                     bias0=None if bias is None else jnp.asarray(bias))
    # the port takes the query frames as (b, m, L, H*D)
    out = attention.flash_attention_fwd(
        _t(q).reshape(b, m, l, hd), _t(k0), _t(v0), heads,
        k1=_t(k1).reshape(b, m, l, hd), v1=_t(v1).reshape(b, m, l, hd),
        bias0=None if bias is None else _t(bias))
    np.testing.assert_allclose(out.reshape(b * m, l, hd).numpy(), np.asarray(ref), **TOL)


def test_flash_out_view_receives_result():
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.standard_normal((1, 3, 8, 16))) for _ in range(3))
    full = torch.zeros(1, 3, 8, 16)
    attention.flash_attention_fwd(q[:, :2].flatten(1, 2), k[:, 0], v[:, 0], 2,
                                  out=full[:, :2].flatten(1, 2))
    ref = attention.flash_attention_plain(q[:, :2].flatten(1, 2), k[:, 0], v[:, 0], 2)
    torch.testing.assert_close(full[:, :2].flatten(1, 2), ref)
    assert torch.all(full[:, 2] == 0)


def test_geglu_out_matches_geglu_kernel():
    rng = np.random.default_rng(3)
    t, inner, c = 256, 128, 128
    h2 = rng.standard_normal((t, 2 * inner)).astype(np.float32)
    w = (rng.standard_normal((inner, c)) / np.sqrt(inner)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    ref = jgeglu._geglu_fused(jnp.asarray(h2), jnp.asarray(w), jnp.asarray(b))
    out = geglu.geglu_out(_t(h2), _t(w.T), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c", [32, 64])
def test_ff_ln_matches_ff_kernel(c):
    rng = np.random.default_rng(4)
    t, inner = 256, 4 * c
    x = rng.standard_normal((t, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wp = (rng.standard_normal((c, 2 * inner)) / np.sqrt(c)).astype(np.float32)
    bp = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    wo = (rng.standard_normal((inner, c)) / np.sqrt(inner)).astype(np.float32)
    bo = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jgeglu.fused_ff_ln(*map(jnp.asarray, (x, gamma, beta, wp, bp, wo, bo)), eps=1e-5)
    out = geglu.ff_ln(_t(x), _t(gamma), _t(beta), _t(wp.T), _t(bp), _t(wo.T), _t(bo))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_feed_forward_wide_route_matches_jax_route():
    """C > 640 runs LN + projection as torch ops and the gate + GEMM in
    geglu_out (geglu.py:407-419); checked against the JAX dispatcher."""
    rng = np.random.default_rng(5)
    t, c = 8, 648
    inner = 4 * c
    x = rng.standard_normal((t, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wp = (rng.standard_normal((c, 2 * inner)) / np.sqrt(c)).astype(np.float32)
    bp = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    wo = (rng.standard_normal((inner, c)) / np.sqrt(inner)).astype(np.float32)
    bo = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jgeglu.fused_ff_ln(*map(jnp.asarray, (x, gamma, beta, wp, bp, wo, bo)), eps=1e-5)
    out = geglu.feed_forward(_t(x), _t(gamma), _t(beta), _t(wp.T), _t(bp), _t(wo.T), _t(bo))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("temb_on,stats", [
    (False, False), (True, False), (False, True), (True, True)])
def test_conv3x3_matches_conv_kernel(temb_on, stats):
    rng = np.random.default_rng(6)
    n, h, w, cin, cout = 2, 5, 6, 8, 16
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    scale = rng.standard_normal((n, cin)).astype(np.float32)
    shift = rng.standard_normal((n, cin)).astype(np.float32)
    temb = rng.standard_normal((n, cout)).astype(np.float32) if temb_on else None
    ref = jconv._conv3x3_t_fwd(*map(jnp.asarray, (x, wk, b, scale, shift)),
                               None if temb is None else jnp.asarray(temb),
                               interpret=True, with_stats=stats)
    out = conv2d.conv3x3_gn_silu(_t(x), _t(wk.transpose(3, 2, 0, 1)), _t(b), _t(scale),
                                 _t(shift), None if temb is None else _t(temb),
                                 with_stats=stats)
    if stats:
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
        # sums over 30 pixels of O(1) values: f32 summation-order noise
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_conv_eligible_matches_jax_without_dtype():
    for shape in [(36, 64, 320, 320), (36, 64, 640, 320), (36, 64, 960, 320),
                  (18, 32, 640, 640), (16, 16, 128, 64), (5, 8, 1280, 1280)]:
        assert conv2d.eligible(*shape) == jconv.eligible(*shape, jnp.bfloat16)


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    before = dict(_build.launches)
    x = torch.randn(2, 8, 16)
    attention.flash_attention_fwd(x, x, x, 2)
    geglu.ff_ln(torch.randn(4, 64), torch.ones(64), torch.zeros(64),
                torch.randn(512, 64), torch.zeros(512), torch.randn(64, 256),
                torch.zeros(64))
    geglu.geglu_out(torch.randn(4, 64), torch.randn(8, 32), torch.zeros(8))
    conv2d.conv3x3_gn_silu(torch.randn(1, 4, 4, 8), torch.randn(8, 8, 3, 3), torch.zeros(8),
                           torch.ones(1, 8), torch.zeros(1, 8))
    assert _build.launches == before
    assert _build._lib is None  # nothing was built
