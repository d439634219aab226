"""The training kernels' plain versions (eeg2video_tpu_torch.ops) against the
JAX package, on the CPU.

Each test makes its inputs with numpy from a seed, in float32, and runs the
JAX function the way the JAX package's own tests run it on the CPU: the
Pallas kernels in interpret mode (``interpret=True``), ``jax.grad`` through
the public dual-KV call, ``jax.vjp`` of the XLA references for the parameter
gradients. Shapes are small but on the kernels' grids (Lq >= 256, inner %
128 == 0, T >= 256, head dims 40 and 80). On CPU tensors the port's wrappers
take their plain versions, which is what is compared here; the CUDA kernels
are held to the same plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances: 2e-5 absolute for forward outputs and lse (float32 summation
order); gradients 5e-5 relative to the gradient's largest entry (the Pallas
backward bodies recompute base-2 scores and use a rational erf, each good to
about 1e-6 relative), 2e-5 for the bias gradient and the head-major op.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg2video_tpu.ops import attention as ja
from eeg2video_tpu.ops import geglu as jg
from eeg2video_tpu.ops import temporal as jt
from eeg2video_tpu_torch.ops import attention, geglu, temporal

from test_torch_models import capped_threads

_threads = capped_threads()

FWD_TOL = 2e-5
GRAD_RTOL = 5e-5


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def tt(a):
    return None if a is None else torch.from_numpy(np.array(a))


def assert_grad_close(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("n,lq,lkv,heads,d", [(1, 256, 256, 2, 40), (2, 256, 128, 1, 80)])
def test_one_segment_lse_and_backward_match_pallas(n, lq, lkv, heads, d):
    rng = np.random.default_rng(0)
    hd = heads * d
    q, k, v, do = rand(rng, n, lq, hd), rand(rng, n, lkv, hd), rand(rng, n, lkv, hd), \
        rand(rng, n, lq, hd)
    scale = 1.0 / math.sqrt(d)
    jout, jlse = ja._flash_fwd_packed(q, k, v, heads, scale, interpret=True, return_lse=True)
    jlse = jlse[:, :, 0, :lq]
    out, lse = attention.flash_attention_fwd(tt(q), tt(k), tt(v), heads, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_TOL, rtol=0)
    jgrads = ja._flash_bwd_packed(q, k, v, do, jout, jlse, scale, heads, interpret=True)
    dq, dk0, dv0, dk1, dv1, _ = attention.flash_attention_bwd(
        tt(q), tt(k), tt(v), heads, tt(do), tt(np.asarray(jout)), tt(np.asarray(jlse)))
    assert dk1 is None and dv1 is None
    for got, want in zip((dq, dk0, dv0), jgrads):
        assert_grad_close(got.numpy(), want)


def test_two_segment_backward_matches_jax_grad_of_the_dual_call():
    """dk0/dv0 are summed over the m frames that shared K0, as the vjp of the
    JAX dual-KV call sums them."""
    rng = np.random.default_rng(1)
    b, m, l, heads, d = 1, 2, 256, 2, 40
    hd = heads * d
    q, k1, v1 = (rand(rng, b * m, l, hd) for _ in range(3))
    k0, v0 = rand(rng, b, l, hd), rand(rng, b, l, hd)
    w = rand(rng, b * m, l, hd)

    def jloss(q, k0, v0, k1, v1):
        return jnp.sum(ja.fused_attention_dual(q, k0, v0, k1, v1, heads, m) * w)

    jout = ja.fused_attention_dual(q, k0, v0, k1, v1, heads, m)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(q, k0, v0, k1, v1)
    ops = [tt(a).requires_grad_() for a in (q, k0, v0, k1, v1)]
    out = attention.flash_attention(ops[0], ops[1], ops[2], heads, k1=ops[3], v1=ops[4])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=FWD_TOL, rtol=0)
    grads = torch.autograd.grad(out, ops, tt(w))
    for got, want in zip(grads, jgrads):
        assert_grad_close(got.numpy(), want)


@pytest.mark.parametrize("n,f,l,heads,d", [(1, 3, 32, 2, 40), (2, 6, 16, 1, 80)])
def test_temporal_attention_matches_pallas(n, f, l, heads, d):
    rng = np.random.default_rng(2)
    hd = heads * d
    q, k, v, do = (rand(rng, n, f, l, hd) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jout = jt._temporal_fwd_pallas(q, k, v, heads, scale, interpret=True)
    out = temporal.temporal_attention_fwd(tt(q), tt(k), tt(v), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL, rtol=0)
    jgrads = jt._temporal_bwd_pallas(q, k, v, do, heads, scale, interpret=True)
    grads = temporal.temporal_attention_bwd(tt(q), tt(k), tt(v), tt(do), heads)
    for got, want in zip(grads, jgrads):
        assert_grad_close(got.numpy(), want)


def _ff_operands(rng, t, c):
    i = 4 * c
    return dict(x=rand(rng, t, c), g=rand(rng, t, c), gamma=1.0 + rand(rng, c, scale=0.1),
                beta=rand(rng, c, scale=0.1), wp=rand(rng, c, 2 * i, scale=c ** -0.5),
                bp=rand(rng, 2 * i, scale=0.1), wo=rand(rng, i, c, scale=i ** -0.5),
                bo=rand(rng, c, scale=0.1))


@pytest.mark.parametrize("t,c", [(256, 32),
                                 (130, 64)])  # T not a multiple of a row block
def test_ff_ln_backward_matches_pallas_and_the_reference_vjp(t, c):
    """dx against the Pallas backward kernel; the parameter gradients of the
    autograd.Function against jax.vjp of the XLA reference (as _ff_fused_bwd
    forms them). JAX weights are (in, out): transposed for the port."""
    o = _ff_operands(np.random.default_rng(3), t, c)
    eps = 1e-5
    jdx = jg._ff_bwd_pallas(o["x"], o["g"], o["gamma"], o["beta"], o["wp"], o["bp"], o["wo"],
                            eps, interpret=True)
    dx = geglu.ff_ln_bwd(tt(o["x"]), tt(o["g"]), tt(o["gamma"]), tt(o["beta"]),
                         tt(o["wp"].T.copy()), tt(o["bp"]), tt(o["wo"].T.copy()), eps)
    assert_grad_close(dx.numpy(), jdx)

    names = ("gamma", "beta", "wp", "bp", "wo", "bo")
    _, vjp = jax.vjp(lambda *p: jg._ff_ref(o["x"], *p, eps), *(o[n] for n in names))
    jgrads = dict(zip(names, vjp(jnp.asarray(o["g"]))))
    x = tt(o["x"]).requires_grad_()
    params = [tt(o[n].T.copy() if n in ("wp", "wo") else o[n]).requires_grad_() for n in names]
    out = geglu.ff_ln_function(x, *params, eps)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jg._ff_ref(o["x"], *(o[n] for n in names), eps)), atol=FWD_TOL, rtol=0)
    grads = torch.autograd.grad(out, [x] + params, tt(o["g"]))
    assert_grad_close(grads[0].numpy(), jdx)
    for n, got in zip(names, grads[1:]):
        want = np.asarray(jgrads[n])
        assert_grad_close(got.numpy(), want.T if n in ("wp", "wo") else want)


def test_geglu_out_backward_matches_pallas_and_the_reference_vjp():
    rng = np.random.default_rng(4)
    t, i, c = 256, 128, 128
    h2, g = rand(rng, t, 2 * i), rand(rng, t, c)
    w, b = rand(rng, i, c, scale=i ** -0.5), rand(rng, c, scale=0.1)
    jdh2 = jg._geglu_bwd_pallas(h2, g, w, interpret=True)
    dh2 = geglu.geglu_out_bwd(tt(h2), tt(g), tt(w.T.copy()))
    assert_grad_close(dh2.numpy(), jdh2)

    _, vjp = jax.vjp(lambda w_, b_: jg._geglu_ref(h2, w_, b_), w, b)
    jdw, jdb = vjp(jnp.asarray(g))
    ops = [tt(h2).requires_grad_(), tt(w.T.copy()).requires_grad_(), tt(b).requires_grad_()]
    out = geglu.geglu_out_function(*ops)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jg._geglu_ref(h2, w, b)),
                               atol=FWD_TOL, rtol=0)
    got = torch.autograd.grad(out, ops, tt(g))
    assert_grad_close(got[0].numpy(), jdh2)
    assert_grad_close(got[1].numpy(), np.asarray(jdw).T)
    assert_grad_close(got[2].numpy(), jdb)


# --- each autograd.Function against autograd through its plain forward ----------

def _leaves(rng, *shapes):
    return [tt(rand(rng, *s)).requires_grad_() for s in shapes]


@pytest.mark.parametrize("two_segments,bias", [(False, False), (False, True), (True, True)])
def test_flash_attention_function_is_consistent_with_its_plain_forward(two_segments, bias):
    rng = np.random.default_rng(5)
    b, m, lq, lkv, heads, d = 2, 3, 10, 7, 2, 8
    hd = heads * d
    q, k0, v0 = _leaves(rng, (b, m, lq, hd), (b, lkv, hd), (b, lkv, hd))
    k1, v1 = _leaves(rng, (b, m, 5, hd), (b, m, 5, hd)) if two_segments else (None, None)
    b0 = tt(rand(rng, b, 1, lkv)) if bias else None
    ops = [t for t in (q, k0, v0, k1, v1) if t is not None]
    dout = tt(rand(rng, b, m, lq, hd))
    out = attention.flash_attention(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0)
    want = attention.flash_attention_plain(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), atol=1e-6)
    for g, w in zip(torch.autograd.grad(out, ops, dout), torch.autograd.grad(want, ops, dout)):
        assert_grad_close(g.numpy(), w.numpy(), rtol=1e-5)


def test_flash_attention_refuses_a_bias_that_asks_for_a_gradient():
    """The one refusal left is ``need_dbias`` without a ``bias0`` to differentiate
    (the test's name dates from when every bias gradient was refused). A bias
    that asks for a gradient gets it, equal to
    autograd through the plain forward, and under ``no_grad`` the forward alone
    runs."""
    rng = np.random.default_rng(6)
    q, k0, v0 = _leaves(rng, (1, 4, 16), (1, 4, 16), (1, 4, 16))
    b0 = tt(rand(rng, 1, 1, 4)).requires_grad_()
    out = attention.flash_attention(q, k0, v0, 2, bias0=b0)
    lse = attention.flash_attention_fwd(q, k0, v0, 2, bias0=b0, return_lse=True)[1]
    with pytest.raises(ValueError, match="need_dbias without a bias0"):
        attention.flash_attention_bwd(q, k0, v0, 2, out, out, lse, need_dbias=True)
    want = attention.flash_attention_plain(q, k0, v0, 2, bias0=b0)
    dout = tt(rand(rng, 1, 4, 16))
    for g, w in zip(torch.autograd.grad(out, [q, k0, v0, b0], dout),
                    torch.autograd.grad(want, [q, k0, v0, b0], dout)):
        assert_grad_close(g.numpy(), w.numpy(), rtol=1e-5)
    with torch.no_grad():  # the forward alone takes it
        assert attention.flash_attention(q, k0, v0, 2, bias0=b0).shape == q.shape


# --- the gradient of the bias (dbias0) against the Pallas biased backward ------

def _mask_bias(rng, *shape):
    """The mask contract's values (0 / -1e4 holes) plus small dense noise, so
    that the gradient of the bias is not trivially 0."""
    holes = (rng.random(shape) < 0.2).astype(np.float32) * -1e4
    return holes + rand(rng, *shape, scale=0.5)


@pytest.mark.parametrize("n,lq,lkv,heads,d", [(2, 256, 512, 4, 40), (1, 300, 450, 2, 40)])
def test_one_segment_dbias_matches_jax_grad_of_the_packed_call(n, lq, lkv, heads, d):
    """All four gradients of the biased call against ``jax.grad`` of
    ``fused_attention_packed`` (its split dq / dkv Pallas passes in interpret
    mode, dbias from the dkv pass); 2e-5 of the gradient's largest entry."""
    rng = np.random.default_rng(9)
    hd = heads * d
    q, k, v, w = rand(rng, n, lq, hd), rand(rng, n, lkv, hd), rand(rng, n, lkv, hd), \
        rand(rng, n, lq, hd)
    bias = _mask_bias(rng, n, 1, lkv)

    def jloss(q, k, v, b):
        return jnp.sum(ja.fused_attention_packed(q, k, v, heads, bias=b) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    ops = [tt(a).requires_grad_() for a in (q, k, v, bias)]
    out = attention.flash_attention(ops[0], ops[1], ops[2], heads, bias0=ops[3])
    grads = torch.autograd.grad(out, ops, tt(w))
    assert grads[3].shape == bias.shape and float(grads[3].abs().max()) > 0
    for got, want in zip(grads, jgrads):
        assert_grad_close(got.numpy(), want, rtol=2e-5)
    # the same gradient from the backward's own entry point and residuals
    o, lse = attention.flash_attention_fwd(ops[0], ops[1], ops[2], heads, bias0=ops[3],
                                           return_lse=True)
    dbias = attention.flash_attention_bwd(
        *(t.detach() for t in ops[:3]), heads, tt(w), o.detach(), lse.detach(),
        bias0=ops[3].detach(), need_dbias=True)[5]
    assert_grad_close(dbias.numpy(), jgrads[3], rtol=2e-5)


@pytest.mark.parametrize("b,l,lkv,heads,d", [(2, 256, 256, 4, 40), (1, 300, 225, 2, 40)])
def test_two_segment_dbias0_is_summed_over_the_frames_as_jax_sums_it(b, l, lkv, heads, d):
    """m = 2 query groups share K0 and bias0. The JAX model's masked training
    path is the concat formulation (``fused_attention_packed`` over [K0 | K1]
    with the bias [bias0 | 0] repeated per frame, models/attention3d.py:258-269):
    ``jax.grad`` with respect to bias0 adds the frames' contributions."""
    rng = np.random.default_rng(10)
    m, hd = 2, heads * d
    q, w = rand(rng, b * m, l, hd), rand(rng, b * m, l, hd)
    k1, v1 = rand(rng, b * m, lkv, hd), rand(rng, b * m, lkv, hd)
    k0, v0 = rand(rng, b, lkv, hd), rand(rng, b, lkv, hd)
    bias0 = _mask_bias(rng, b, 1, lkv)

    def jloss(q, k0, v0, k1, v1, b0):
        rep = lambda t: jnp.repeat(t, m, axis=0)
        kg, vg = jnp.concatenate([rep(k0), k1], axis=1), jnp.concatenate([rep(v0), v1], axis=1)
        bias = rep(jnp.concatenate([b0, jnp.zeros_like(b0)], axis=-1))
        return jnp.sum(ja.fused_attention_packed(q, kg, vg, heads, bias=bias) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4, 5))(q, k0, v0, k1, v1, bias0)
    # the port takes the m groups as an axis: (b, m, L, H*D)
    grouped = lambda a: tt(a).unflatten(0, (b, m))
    ops = [t.requires_grad_() for t in (grouped(q), tt(k0), tt(v0), grouped(k1), grouped(v1),
                                        tt(bias0))]
    out = attention.flash_attention(ops[0], ops[1], ops[2], heads, k1=ops[3], v1=ops[4],
                                    bias0=ops[5])
    grads = torch.autograd.grad(out, ops, grouped(w))
    assert grads[5].shape == bias0.shape
    for got, want in zip(grads, jgrads):
        assert_grad_close(got.numpy().reshape(want.shape), want, rtol=2e-5)


# --- head-major (B, H, L, D) attention against the JAX package's flash kernels --

@pytest.mark.parametrize("b,h,lq,lkv,d", [
    (1, 2, 256, 512, 40),   # padded head dim on the TPU
    (2, 2, 300, 600, 64),   # lengths off the kernel's blocks
    (1, 2, 300, 450, 40),   # the ragged backward case
])
def test_fused_attention_matches_the_pallas_flash_kernels(b, h, lq, lkv, d):
    """``fused_attention`` (plain version on the CPU) and its gradients against
    ``_flash_attention`` and ``jax.grad`` of it (Pallas forward, dq and dk/dv
    kernels in interpret mode), and the backward's own entry point against the
    same gradients from the forward's residuals; 2e-5."""
    rng = np.random.default_rng(11)
    q, k, v, w = rand(rng, b, h, lq, d), rand(rng, b, h, lkv, d), rand(rng, b, h, lkv, d), \
        rand(rng, b, h, lq, d)
    scale = 1.0 / math.sqrt(d)
    jout = ja._flash_attention(q, k, v, scale)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(ja._flash_attention(q, k, v, scale) * w),
                      argnums=(0, 1, 2))(q, k, v)
    ops = [tt(a).requires_grad_() for a in (q, k, v)]
    out = attention.fused_attention(*ops)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=FWD_TOL, rtol=0)
    for got, want in zip(torch.autograd.grad(out, ops, tt(w)), jgrads):
        assert_grad_close(got.numpy(), want, rtol=2e-5)
    o, lse = attention.fused_attention_fwd(tt(q), tt(k), tt(v), return_lse=True)
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    for got, want in zip(attention.fused_attention_bwd(tt(q), tt(k), tt(v), tt(w), o, lse),
                         jgrads):
        assert_grad_close(got.numpy(), want, rtol=2e-5)


def test_fused_attention_matches_mha_reference_on_short_sequences():
    """Lq = 6 (the temporal-attention shape): the JAX dispatch sends it to
    ``mha_reference``; the port has one route for every length. A custom scale
    goes through both."""
    rng = np.random.default_rng(12)
    q, k, v = (rand(rng, 2, 4, 6, 40) for _ in range(3))
    for scale in (None, 0.3):
        want = ja.fused_attention(q, k, v, scale)
        got = attention.fused_attention(tt(q), tt(k), tt(v), scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    from eeg2video_tpu_torch import ops
    assert ops.fused_attention is attention.fused_attention


def test_temporal_attention_function_is_consistent_with_its_plain_forward():
    rng = np.random.default_rng(7)
    q, k, v = _leaves(rng, *[(2, 4, 5, 16)] * 3)
    dout = tt(rand(rng, 2, 4, 5, 16))
    out = temporal.temporal_attention(q, k, v, 2)
    want = temporal.temporal_attention_plain(q, k, v, 2)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), atol=1e-6)
    for g, w in zip(torch.autograd.grad(out, [q, k, v], dout),
                    torch.autograd.grad(want, [q, k, v], dout)):
        assert_grad_close(g.numpy(), w.numpy(), rtol=1e-5)


def test_feed_forward_functions_are_consistent_with_their_plain_forwards():
    """Every route of ``feed_forward`` (``geglu.ff_route``: C = 16 off the
    128 grid of I: ff_ref; 32: ff_ln; 704 and 768, wider than 640: LN + proj
    as torch ops, then geglu_ref at C % 128 != 0 and geglu_out at 768), with
    every operand asking for its gradient and with the weights frozen (then
    no parameter gradient is formed)."""
    rng = np.random.default_rng(8)
    for c in (16, 32, 704, 768):
        i = 4 * c
        x, = _leaves(rng, (6, c))
        params = [tt(1.0 + rand(rng, c, scale=0.1)), tt(rand(rng, c, scale=0.1)),
                  tt(rand(rng, 2 * i, c, scale=c ** -0.5)), tt(rand(rng, 2 * i, scale=0.1)),
                  tt(rand(rng, c, i, scale=i ** -0.5)), tt(rand(rng, c, scale=0.1))]
        dout = tt(rand(rng, 6, c))
        for frozen in (False, True):
            for p in params:
                p.requires_grad_(not frozen)
            leaves = [x] if frozen else [x] + params
            out = geglu.feed_forward(x, *params)
            want = geglu.ff_ln_plain(x, *params)
            np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                                       atol=2e-5, rtol=2e-5)
            for g, w in zip(torch.autograd.grad(out, leaves, dout),
                            torch.autograd.grad(want, leaves, dout)):
                assert_grad_close(g.numpy(), w.numpy(), rtol=2e-5)
