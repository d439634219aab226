"""The error budget of the 3xTF32 products in the f32 attention kernels.

``csrc/flash_f32.cuh`` forms every f32 product on the tensor cores from tf32
operands: each element x is split into big = cvt.rna.tf32(x) and small =
cvt.rna.tf32(x - big), and a b is taken as a_small b_big + a_big b_small +
a_big b_big. This file emulates cvt.rna.tf32 on the CPU (the f32 mantissa
rounded to 10 bits, ties away from zero) and shows, on standard-normal q, k,
v at the model's head dims and a two-segment key length:

- the split is nearly exact: big + small = x within 2^-22 relative;
- scores and P V formed from the three products (summed in f64) stay within
  1e-6 of the f64 product, relative to the output's max: far inside the f32
  kernels' bound of 1e-4 (chip_smoke.py's F32_KERNEL_BOUND);
- one tf32 product (big b big alone) lands above that bound, which is why the
  kernels take three.

The f32 feed-forward pair (``csrc/ff_f32.cu``) takes the same three
products over longer sums: K = C (320, 640) in the projection and dgated,
I (1280, 2560) in the out GEMM, 2I (2560, 5120) in dh2 Wp. The tensor cores
truncate as they accumulate, so the kernels run each chain of mma over one
32-wide k slab into fresh accumulators and add the runs by f32 adds. The
tests below emulate that accumulation (each mma's sum rounded toward zero
to f32) and show that runs of 32 keep the three products within THREE_BOUND
at every one of those K, that one tf32 product misses F32_KERNEL_BOUND, and
that one chain over the whole of K lands further from the f64 product.

The emulation lives here only; nothing on the package's path uses it.
"""

import numpy as np
import pytest
import torch

F32_KERNEL_BOUND = 1e-4  # the f32 kernels against their plain versions (chip_smoke.py)
THREE_BOUND = 1e-6       # the 3xTF32 products' share of that budget
LKV = 4608               # two segments of 2304 keys (frames 2-5 at level 0)
LQ = 64                  # one block of query rows


def tf32_rna(x):
    """cvt.rna.tf32.f32 on finite f32 values: round the mantissa to 10 bits,
    ties away from zero (add half a tf32 ulp to the magnitude, clear the low
    13 bits)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits & 0x80000000) | (((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def _operands(d, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((LQ, d), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((LKV, d), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((LKV, d), dtype=np.float32))
    return q, k, v


def _products(a, b):
    """(f64 oracle, three tf32 products, one tf32 product) of a @ b, each
    product's terms summed in f64."""
    (ab, as_), (bb, bs) = split(a), split(b)
    f = lambda t: t.double()  # noqa: E731
    oracle = f(a) @ f(b)
    three = f(as_) @ f(bb) + f(ab) @ f(bs) + f(ab) @ f(bb)
    one = f(ab) @ f(bb)
    return oracle, three, one


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _attention_errors(d, seed=0):
    """Relative errors of the scores and of P V, three products and one."""
    q, k, v = _operands(d, seed)
    s_oracle, s_three, s_one = _products(q, k.T)
    # P as the kernel holds it (f32), from the exact scores
    p = torch.softmax(s_oracle * d ** -0.5, dim=-1).float()
    o_oracle, o_three, o_one = _products(p, v)
    return ((_rel(s_three, s_oracle), _rel(o_three, o_oracle)),
            (_rel(s_one, s_oracle), _rel(o_one, o_oracle)))


def test_tf32_rna_rounds_to_ten_mantissa_bits_ties_away_from_zero():
    ulp = 2.0 ** -10  # a tf32 ulp at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4, 1.0 + 0.75 * ulp,
                      3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, 3.0, -0.0])
    got = tf32_rna(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_reconstructs_within_two_to_the_minus_22(seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(1 << 16, dtype=np.float32))
    big, small = split(x)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -22


@pytest.mark.parametrize("d", [40, 80, 160])
def test_three_tf32_products_keep_f32_accuracy(d):
    (s_err, o_err), _ = _attention_errors(d)
    assert s_err < THREE_BOUND and o_err < THREE_BOUND


@pytest.mark.parametrize("d", [40, 80, 160])
def test_one_tf32_product_misses_the_f32_bound(d):
    _, (s_err, o_err) = _attention_errors(d)
    assert max(s_err, o_err) > F32_KERNEL_BOUND


FF_RUN = 32                      # csrc/ff_f32.cu kBK: the k of one run of fresh accumulators
FF_KS = (320, 640, 1280, 2560, 5120)


def _rz_f32(x):
    """f64 values to f32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _ff_product(a, b, run, passes=3):
    """a @ b (f32) as the feed-forward kernels form it: per k8 step one mma
    per pass (a_small b_big, a_big b_small, a_big b_big), each adding its
    eight exact tf32 products to the accumulator and rounding toward zero to
    f32; each ``run`` of k into fresh accumulators, the runs added in f32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    pairs = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else ((ab, bb),)
    pairs = [(x.double(), y.double()) for x, y in pairs]
    total = torch.zeros(a.shape[0], b.shape[1])
    for r0 in range(0, a.shape[1], run):
        t = torch.zeros_like(total)
        for k0 in range(r0, min(r0 + run, a.shape[1]), 8):
            for x, y in pairs:
                t = _rz_f32(t.double() + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
        total = total + t
    return total


def _ff_errors(k, seed=0):
    """Relative errors (to the output's max) of a (16, K) x (K, 16) product:
    three products in runs of FF_RUN, three in one chain, one product."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((16, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 16), dtype=np.float32) * k ** -0.5)
    want = a.double() @ b.double()
    return (_rel(_ff_product(a, b, FF_RUN), want), _rel(_ff_product(a, b, k), want),
            _rel(_ff_product(a, b, FF_RUN, passes=1), want))


@pytest.mark.parametrize("k", FF_KS)
def test_ff_runs_of_32_keep_three_tf32_products_within_bound(k):
    runs, _, _ = _ff_errors(k)
    assert runs < THREE_BOUND


@pytest.mark.parametrize("k", FF_KS)
def test_ff_one_tf32_product_misses_the_f32_bound(k):
    _, _, one = _ff_errors(k)
    assert one > F32_KERNEL_BOUND


def test_ff_one_chain_over_all_of_k_lands_further_than_runs():
    runs, chain, _ = _ff_errors(FF_KS[-1])
    assert chain > 4 * runs
