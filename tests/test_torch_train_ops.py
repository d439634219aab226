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
about 1e-6 relative).
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
    dq, dk0, dv0, dk1, dv1 = attention.flash_attention_bwd(
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


def test_ff_ln_backward_matches_pallas_and_the_reference_vjp():
    """dx against the Pallas backward kernel; the parameter gradients of the
    autograd.Function against jax.vjp of the XLA reference (as _ff_fused_bwd
    forms them). JAX weights are (in, out): transposed for the port."""
    o = _ff_operands(np.random.default_rng(3), 256, 32)
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
    rng = np.random.default_rng(6)
    q, k0, v0 = _leaves(rng, (1, 4, 16), (1, 4, 16), (1, 4, 16))
    b0 = tt(rand(rng, 1, 1, 4)).requires_grad_()
    with pytest.raises(NotImplementedError, match="dbias"):
        attention.flash_attention(q, k0, v0, 2, bias0=b0)
    with torch.no_grad():  # the forward alone takes it
        assert attention.flash_attention(q, k0, v0, 2, bias0=b0).shape == q.shape


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
    """Both routes of ``feed_forward`` (C <= 640: ff_ln; wider: LN + proj as
    torch ops and geglu_out), with every operand asking for its gradient and
    with the weights frozen (then no parameter gradient is formed)."""
    rng = np.random.default_rng(8)
    for c in (16, 704):
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
