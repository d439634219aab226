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

from test_torch_models import capped_threads

_threads = capped_threads()

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


@pytest.mark.parametrize("t", [37, 130])
def test_geglu_out_plain_matches_pallas_at_model_width(t):
    """geglu_out_plain, the CUDA kernel's oracle, against the Pallas kernel in interpret mode
    at the model's I = 5120, C = 1280, with row counts that end inside a 64-row block; TOL
    (2e-5) holds there too (the largest difference is 1.8e-6 on outputs up to 3.2)."""
    rng = np.random.default_rng(30 + t)
    inner, c = 5120, 1280
    h2 = rng.standard_normal((t, 2 * inner)).astype(np.float32)
    w = (rng.standard_normal((inner, c)) / np.sqrt(inner)).astype(np.float32)
    b = (0.02 * rng.standard_normal(c)).astype(np.float32)
    ref = jgeglu._geglu_pallas(jnp.asarray(h2), jnp.asarray(w), jnp.asarray(b), interpret=True)
    out = geglu.geglu_out_plain(_t(h2), _t(w.T.copy()), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_geglu_out_l2_read_bytes_matches_a_hand_count():
    """T = 100, I = 128, C = 400: two row blocks (64 + 36 rows), each a cluster of four
    column blocks of 320 (the second holds 80 columns, the other two none). Per row block w
    gives (320 + 80) rows x 128 x 2 bytes and the bias 400 x 4; the clusters read h2's 100
    rows x 256 x 2 bytes once."""
    want = 2 * ((320 + 80) * 128 * 2 + 400 * 4) + 100 * 256 * 2
    assert want == 259200
    assert geglu.geglu_out_l2_read_bytes(100, 128, 400) == want
    # the main shape: 27 row blocks of 4 blocks, each 320 x 5120 of w; h2 once
    assert geglu.geglu_out_l2_read_bytes(1728, 5120, 1280) == (
        27 * 4 * 320 * 5120 * 2 + 27 * 1280 * 4 + 1728 * 10240 * 2)


def test_geglu_f32_l2_read_bytes_match_a_hand_count():
    """The f32 pair's 128 x 160 tiles, f32. Forward at T = 200, I = 64, C = 200: two row
    tiles (128 + 72 rows), two column tiles (160 + 40), K = 64 in two runs of one slab; the
    gate's pass reads h2's 200 x 128 once, each column tile the 200 gated rows of 64, each
    row tile W's 200 rows of 64, the sum's pass the two 200 x 200 partials. Backward at
    T = 200, I = 200, C = 64: each of two column tiles reads g's 200 rows of 64, each of two
    row tiles W's 64 rows at its columns (200 in all); the epilogue reads h2's 200 x 400
    once. The workspace is the (T, I) gated product and the partials."""
    assert geglu.geglu_f32_l2_read_bytes(200, 64, 200) == 4 * (
        200 * 128 + 2 * 200 * 64 + 2 * 200 * 64 + 2 * 200 * 200) == 627200
    assert geglu.geglu_f32_l2_read_bytes(200, 200, 64, backward=True) == 4 * (
        2 * 200 * 64 + 2 * 64 * 200 + 200 * 400) == 524800
    assert geglu.geglu_f32_workspace_bytes(200, 64, 200) == 4 * (200 * 64 + 2 * 200 * 200)
    # the train step's level 2: 68 row tiles, 8 column tiles of C, 32 of I, K in 4 runs
    assert geglu.geglu_f32_l2_read_bytes(8640, 5120, 1280) == 4 * (
        8640 * 10240 + 8 * 8640 * 5120 + 68 * 1280 * 5120 + 4 * 8640 * 1280)
    assert geglu.geglu_f32_l2_read_bytes(8640, 5120, 1280, backward=True) == 4 * (
        32 * 8640 * 1280 + 68 * 1280 * 5120 + 8640 * 10240)
    assert geglu.geglu_f32_workspace_bytes(8640, 5120, 1280) == 4 * 8640 * (5120 + 4 * 1280)


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
    """C = 648 against the JAX dispatcher (geglu.py:407-419): I = 2592 is off
    the 128 grid, so both packages take their reference route."""
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_conv_eligible_matches_jax_without_dtype(dtype):
    """The port's conv route is JAX's ``eligible`` (conv2d.py:124-135) at
    both compute dtypes: the kernel at bf16 level-0 shapes, the library conv
    for every f32 conv (JAX sends f32 to XLA's)."""
    for shape in [(36, 64, 320, 320), (36, 64, 640, 320), (36, 64, 960, 320),
                  (18, 32, 640, 640), (16, 16, 128, 64), (5, 8, 1280, 1280)]:
        assert (conv2d.eligible(*shape, getattr(torch, dtype))
                == jconv.eligible(*shape, getattr(jnp, dtype)))


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (12, 36, 64, 320, 320), (12, 36, 64, 640, 320), (2, 10, 48, 64, 72), (1, 5, 130, 8, 400)])
def test_conv_l2_read_bytes_count_what_each_block_copies(n, h, w, cin, cout):
    """conv2d.l2_read_bytes against a count over the kernel's blocks: a block
    (4 x 64 pixels of one image, 160 channels) copies its weight rows, scale and
    shift of its image, and the halo pixels that lie inside the image."""
    inside = np.zeros((h + 2, w + 2), bool)  # the image in zero-padded coordinates
    inside[1:-1, 1:-1] = True
    per_image = 0
    for co0 in range(0, cout, 160):
        rows = min(160, cout - co0)
        for y0 in range(0, h, 4):
            for x0 in range(0, w, 64):
                halo = int(inside[y0:y0 + 6, x0:x0 + 66].sum())
                per_image += rows * 9 * cin * 2 + 2 * cin * 4 + halo * cin * 2
    assert conv2d.l2_read_bytes(n, h, w, cin, cout) == n * per_image


@pytest.mark.parametrize("cout,cin", [(320, 320), (320, 640), (72, 40), (16, 8)])
def test_conv_weight_slabs_place_every_weight_once(cout, cin):
    """conv2d.weight_slabs: w[co, ci, dy, dx] at [co // 160, ci // 64, dy, dx,
    co % 160 // 8, ci % 64 // 8, co % 8, ci % 8], zeros in the padding."""
    w = torch.arange(1, cout * cin * 9 + 1, dtype=torch.float32).reshape(cout, cin, 3, 3)
    slabs = conv2d.weight_slabs(w)
    cb, nc = -(-cout // 160), -(-cin // 64)
    assert slabs.shape == (cb, nc, 3, 3, 20, 8, 8, 8) and slabs.is_contiguous()
    co, ci, dy, dx = (t.flatten() for t in torch.meshgrid(
        torch.arange(cout), torch.arange(cin), torch.arange(3), torch.arange(3), indexing="ij"))
    placed = slabs[co // 160, ci // 64, dy, dx, co % 160 // 8, ci % 64 // 8, co % 8, ci % 8]
    assert torch.equal(placed, w[co, ci, dy, dx])
    assert int((slabs != 0).sum()) == cout * cin * 9


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


def test_kernel_resources_name_kernels_in_anonymous_namespaces():
    """build.log's ``-Xptxas -v`` lines give registers and spills per kernel, named by function
    and template arguments; nvcc mangles a file's anonymous namespace with a per-file suffix."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN3e2v40_GLOBAL__N__a77dbe88_8_ff_ln_cu_"
        "49e8f03d12ff_ln_kernelILi10EEEvPK13__nv_bfloat16PKfS6_S4_S6_S4_S6_PS2_iif' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN3e2v16flash_fwd_kernelILi48ELb1ELb0EEEvNS_"
        "8AttnArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers",
    ])
    assert _build.kernel_resources(log) == {"ff_ln_kernel<10>": (128, 8, 4),
                                            "flash_fwd_kernel<48,1,0>": (122, 0, 0)}
