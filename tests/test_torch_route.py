"""The port's routing against the JAX package's dispatch, and the feed-forward
at the widths the new routes reach.

Each routing decision of the port is a named function of shape and dtype
(``conv2d.eligible``, ``geglu.ff_route``, ``geglu.geglu_route``). The tests
hold each one to the branch the JAX package takes for the same shape and
dtype: the conv calls JAX's ``eligible`` itself; the feed-forward and the
gate GEMM are observed by running ``fused_ff_ln`` / ``fused_geglu_out``
with their branches replaced by recorders (geglu.py:407-419, :434). JAX's
``T < 256`` tests are TPU speed rules that the port leaves out, as it does
``_FLASH_MIN_LQ``: at T >= 256 the branches must agree, and at T = 130 the
port's kernel route is held to JAX's reference route numerically (2e-5, f32
summation order).

Numerics at C = 32 (the tiny configs), on the CPU where each wrapper takes
its plain version: against ``fused_ff_ln`` with its Pallas kernels in
interpret mode (how the JAX package's own tests run them), forward and dx,
f32 (2e-5) and bf16 (3e-2 of the output: both round to bf16 at the same
places, so a value may land one bf16 step, 7.8e-3 relative, the other way).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg2video_tpu.ops import conv2d as jconv
from eeg2video_tpu.ops import geglu as jgeglu
from eeg2video_tpu_torch.ops import _build, attention, conv2d, geglu

from test_torch_models import capped_threads

_threads = capped_threads()

TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_branch(monkeypatch, fn, recorders, *args):
    """Which of ``recorders`` (names of module functions of JAX's geglu.py)
    ``fn(*args)`` calls: each is replaced by one that records its name and
    returns zeros shaped like the real result."""
    seen = []
    for name, shape_of in recorders.items():
        def record(*a, _name=name, _shape_of=shape_of, **k):
            seen.append(_name)
            return jnp.zeros(_shape_of(*a), a[0].dtype)
        monkeypatch.setattr(jgeglu, name, record)
    fn(*args)
    monkeypatch.undo()
    return seen


def _ff_operands(t, c, inner, dtype=jnp.float32):
    z = lambda *s: jnp.zeros(s, dtype)  # noqa: E731
    return z(t, c), z(c), z(c), z(c, 2 * inner), z(2 * inner), z(inner, c), z(c)


# (C, I): the model's widths, the tiny configs', and each branch's edges
FF_SHAPES = [(32, 128), (64, 256), (320, 1280), (640, 2560), (648, 2592), (704, 2816),
             (768, 3072), (1280, 128), (24, 128), (40, 96), (16, 64), (12, 128)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c,inner", FF_SHAPES)
def test_ff_route_is_jax_dispatch(monkeypatch, c, inner, dtype):
    """``geglu.ff_route`` gives the branch of ``fused_ff_ln`` (geglu.py:407-419)
    at T = 256, at either dtype (neither package tests it here): the
    whole-block kernel, LN in XLA + ``fused_geglu_out``, or ``_ff_ref``."""
    recorders = {"_ff_fused": lambda x, *a: x.shape,
                 "fused_geglu_out": lambda h2, w, b: (*h2.shape[:-1], w.shape[1]),
                 "_ff_ref": lambda x, *a: x.shape}
    seen = _jax_branch(monkeypatch, jgeglu.fused_ff_ln, recorders,
                       *_ff_operands(256, c, inner, getattr(jnp, dtype)))
    want = {"_ff_fused": "ff_ln", "fused_geglu_out": "ln_geglu", "_ff_ref": "ref"}[seen[0]]
    assert len(seen) == 1 and geglu.ff_route(c, inner) == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("inner,c", [(5120, 1280), (2816, 704), (3072, 768), (128, 128),
                                     (96, 128), (128, 200), (256, 64)])
def test_geglu_route_is_jax_dispatch(monkeypatch, inner, c, dtype):
    """``geglu.geglu_route`` gives the branch of ``fused_geglu_out``
    (geglu.py:434) at T = 256, at either dtype: the kernel or ``_geglu_ref``."""
    recorders = {"_geglu_fused": lambda h2, w, b: (*h2.shape[:-1], w.shape[1]),
                 "_geglu_ref": lambda h2, w, b: (*h2.shape[:-1], w.shape[1])}
    z = lambda *s: jnp.zeros(s, getattr(jnp, dtype))  # noqa: E731
    seen = _jax_branch(monkeypatch, jgeglu.fused_geglu_out, recorders,
                       z(256, 2 * inner), z(inner, c), z(c))
    assert len(seen) == 1
    assert geglu.geglu_route(inner, c) == ("geglu_out" if seen[0] == "_geglu_fused" else "ref")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(36, 64, 320, 320), (36, 64, 640, 320), (18, 32, 640, 640),
                                   (16, 16, 32, 32), (16, 16, 64, 32), (4, 4, 64, 64),
                                   (9, 16, 1280, 1280), (36, 64, 960, 320)])
def test_conv_route_is_jax_eligible(shape, dtype):
    """The level-0 conv kernel exactly where JAX's ``eligible`` (conv2d.py:124-135)
    sends its kernel: bf16 only; every f32 conv takes the library's."""
    assert (conv2d.eligible(*shape, getattr(torch, dtype))
            == jconv.eligible(*shape, getattr(jnp, dtype)))


def test_attention_refuses_heads_wider_than_160_by_name():
    """Settled divergence: the kernels take D <= 160 (the model's widest head);
    a wider one is refused by name before any launch (JAX has no such limit)."""
    q = torch.zeros(1, 8, 8 * 168)
    with pytest.raises(ValueError, match="head_dim 168 must be a multiple of 8 and <= 160"):
        attention._kernel_views("flash_attention_fwd", q, q, q, None, None, 8)


def _ff_inputs(rng, t, c, inner):
    return [rng.standard_normal((t, c)).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            (rng.standard_normal((c, 2 * inner)) / np.sqrt(c)).astype(np.float32),
            (0.1 * rng.standard_normal(2 * inner)).astype(np.float32),
            (rng.standard_normal((inner, c)) / np.sqrt(inner)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32)]


def _port_args(arrays, dtype):
    """numpy (JAX layout: wp (C, 2I), wo (I, C)) -> torch (nn.Linear layout)."""
    x, gamma, beta, wp, bp, wo, bo = (torch.from_numpy(a).to(dtype) for a in arrays)
    return [x, gamma, beta, wp.t().contiguous(), bp, wo.t().contiguous(), bo]


def _jax_ff(arrays, dtype, dout):
    """fused_ff_ln and its dx (jax.vjp) on the same values in ``dtype``."""
    xs = [jnp.asarray(a, dtype) for a in arrays]
    out, vjp = jax.vjp(lambda x: jgeglu.fused_ff_ln(x, *xs[1:], eps=1e-5), xs[0])
    (dx,) = vjp(jnp.asarray(dout, dtype))
    return np.asarray(out, np.float32), np.asarray(dx, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c32_feed_forward_matches_pallas_ff(dtype):
    """C = 32, I = 128, T = 256 (the tiny configs' level 0): the port's
    ``feed_forward`` and the plain ``ff_ln`` / ``ff_ln_bwd`` against
    ``fused_ff_ln`` with its Pallas kernels (interpret mode) and their dx."""
    rng = np.random.default_rng(31)
    t, c, inner = 256, 32, 128
    arrays = _ff_inputs(rng, t, c, inner)
    dout = rng.standard_normal((t, c)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    want, want_dx = _jax_ff(arrays, getattr(jnp, dtype), dout)
    args = _port_args(arrays, tdtype)
    assert geglu.ff_route(c, inner) == "ff_ln"
    x = args[0].clone().requires_grad_()
    out = geglu.feed_forward(x, *args[1:])
    (dx,) = torch.autograd.grad(out, [x], torch.from_numpy(dout).to(tdtype))
    np.testing.assert_allclose(out.detach().float().numpy(), want, **tol)
    np.testing.assert_allclose(dx.float().numpy(), want_dx, **tol)
    np.testing.assert_allclose(geglu.ff_ln_plain(*args).float().numpy(), want, **tol)
    plain_dx = geglu.ff_ln_bwd_plain(args[0], torch.from_numpy(dout).to(tdtype), *args[1:6])
    np.testing.assert_allclose(plain_dx.float().numpy(), want_dx, **tol)


@pytest.mark.parametrize("c,inner,route", [(704, 2816, "ln_geglu"), (16, 64, "ref"),
                                           (40, 96, "ref")])
def test_xla_branches_match_jax(c, inner, route):
    """The branches JAX computes in XLA, forward and dx at f32: C > 640 with
    I or C off the 128 grid (LN and the projection in XLA, then ``_geglu_ref``)
    and C or I off the grid (``_ff_ref``); the port's torch ops in their place."""
    rng = np.random.default_rng(32)
    t = 256
    arrays = _ff_inputs(rng, t, c, inner)
    dout = rng.standard_normal((t, c)).astype(np.float32)
    want, want_dx = _jax_ff(arrays, jnp.float32, dout)
    args = _port_args(arrays, torch.float32)
    assert geglu.ff_route(c, inner) == route
    x = args[0].clone().requires_grad_()
    out = geglu.feed_forward(x, *args[1:])
    (dx,) = torch.autograd.grad(out, [x], torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-4)


def test_short_row_counts_take_the_kernel_route_within_2e5_of_jax_reference():
    """Settled divergence: at T < 256 JAX sends the FF and the gate GEMM to
    ``_ff_ref`` / ``_geglu_ref`` (geglu.py:407, :434, TPU speed rules); the port
    keeps its kernel route. At T = 130 the two agree within 2e-5 (f32)."""
    rng = np.random.default_rng(33)
    t, c, inner = 130, 32, 128
    arrays = _ff_inputs(rng, t, c, inner)
    xs = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jgeglu._ff_ref(*xs, 1e-5))
    np.testing.assert_allclose(np.asarray(jgeglu.fused_ff_ln(*xs, eps=1e-5)), want, rtol=0, atol=0)
    args = _port_args(arrays, torch.float32)
    before = dict(_build.launches)
    np.testing.assert_allclose(geglu.feed_forward(*args).numpy(), want, **TOL)

    gi, gc = 128, 128
    h2 = rng.standard_normal((t, 2 * gi)).astype(np.float32)
    w = (rng.standard_normal((gi, gc)) / np.sqrt(gi)).astype(np.float32)
    b = (0.1 * rng.standard_normal(gc)).astype(np.float32)
    gwant = np.asarray(jgeglu._geglu_ref(jnp.asarray(h2), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(
        np.asarray(jgeglu.fused_geglu_out(jnp.asarray(h2), jnp.asarray(w), jnp.asarray(b))),
        gwant, rtol=0, atol=0)
    assert geglu.geglu_route(gi, gc) == "geglu_out"
    got = geglu.geglu(torch.from_numpy(h2), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), gwant, **TOL)
    assert _build.launches == before  # CPU tensors: the plain versions, no launch
