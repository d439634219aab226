"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: skipped where torch.cuda.is_available() is false. The file
imports torch and the port only, so it runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up the JAX CPU mesh).
The shapes are small and ragged on purpose: KV and query tails, head dims
8 and 40 (padded to 16 and 48 in shared memory), channel counts that do not
fill a tile. chip_smoke.py checks the generation path's own shapes.
Bound: max |kernel - plain| / max |plain| < 1e-2, the plain version in f32
on the same bf16 inputs (bf16 rounding of the output and of the in-kernel
bf16 intermediates).
"""

import pytest
import torch

from eeg2video_tpu_torch.ops import attention, conv2d, geglu, int8_dense

BOUND = 1e-2


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
@pytest.mark.parametrize("t,c", [(100, 64), (37, 128)])
def test_ff_ln_matches_plain(gen, t, c):
    i = 4 * c
    args = [_rand(gen, t, c), 1.0 + 0.05 * _rand(gen, c, dtype=torch.float32),
            0.02 * _rand(gen, c, dtype=torch.float32), _rand(gen, 2 * i, c, scale=c ** -0.5),
            0.02 * _rand(gen, 2 * i, dtype=torch.float32), _rand(gen, c, i, scale=i ** -0.5),
            0.02 * _rand(gen, c, dtype=torch.float32)]
    assert _err(geglu.ff_ln(*args), geglu.ff_ln_plain(*_f32(args))) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("t,i,c", [(50, 64, 40), (130, 256, 200)])
def test_geglu_out_matches_plain(gen, t, i, c):
    args = [_rand(gen, t, 2 * i), _rand(gen, c, i, scale=i ** -0.5),
            0.02 * _rand(gen, c, dtype=torch.float32)]
    assert _err(geglu.geglu_out(*args), geglu.geglu_out_plain(*_f32(args))) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,cin,cout,stats,temb", [
    (2, 5, 6, 8, 16, False, True),      # Cin and Cout below one tile, ragged M
    (3, 10, 10, 128, 64, False, False),  # 64-pixel tiles spanning two images
    (2, 8, 8, 8, 16, True, True),       # stats: one 64-pixel block per image
    (3, 8, 16, 128, 64, True, False),   # stats: two blocks per image, added in order
    (1, 7, 9, 40, 72, False, True),     # Cout tail past one 64-wide tile
])
def test_conv3x3_matches_plain(gen, n, h, w, cin, cout, stats, temb):
    args = [_rand(gen, n, h, w, cin), _rand(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
            0.02 * _rand(gen, cout, dtype=torch.float32),
            torch.rand(n, cin, generator=gen, device="cuda") + 0.5,
            _rand(gen, n, cin, scale=0.5, dtype=torch.float32),
            _rand(gen, n, cout, dtype=torch.float32) if temb else None]
    got = conv2d.conv3x3_gn_silu(*args, with_stats=stats)
    want = conv2d.conv3x3_gn_silu_plain(*_f32(args), with_stats=stats)
    for g, wnt in zip(got if stats else [got], want if stats else [want]):
        assert _err(g, wnt) < BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (1, 310, 700),      # one row, K and N padded (320, 1024), one K split per step
    (100, 1000, 3000),  # the serving chunk; split K, second pass
    (113, 96, 130),     # two row blocks, the second with one row
    (7, 4100, 33000),   # many column blocks: one split, epilogue in the kernel
])
def test_int8_dense_matches_plain(gen, m, k, n):
    w = _rand(gen, k, n, scale=k ** -0.5, dtype=torch.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 0
    w_q, scale = int8_dense.quantize_int8(w)
    bias = _rand(gen, n, scale=0.1, dtype=torch.float32)
    x = _rand(gen, m, k, dtype=torch.float32)
    got = int8_dense.int8_dense(x, w_q, scale, bias, n)
    want = int8_dense.int8_dense_plain(x, w_q, scale, bias, n)
    assert got.shape == (m, n) and got.dtype == torch.float32
    # same bf16 operands and f32 accumulation: only the summation order differs
    assert _err(got, want) < 1e-4
    again = int8_dense.int8_dense(x, w_q, scale, bias, n)
    assert torch.equal(got, again)  # fixed-order split-K sum: same bits every run


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
