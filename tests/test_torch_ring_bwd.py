"""The port's ring attention backward (ops/ring.py) against ``jax.grad`` of
the JAX package's ``ring_attention_packed`` on the virtual CPU devices.

The port runs in two gloo processes for sp = 2 (ring and replicated-KV mode,
each with and without a bias, and the shard-level ``ring_attention_inner``)
and in four for sp = 2 x tp = 2 with the heads over tp
(``tests/_torch_dist_worker.py``; 60 s group timeout, 120 s deadline, both
spawns started before JAX's side so that they overlap with it). JAX runs in
the pytest process, its packed flash kernels in interpret mode as its own
tests run them. The same numpy operands and output gradient from a seed go
to both, at ``HEADS, D = 2, 40`` and ``N, L = 2, 512`` in f32; every rank's
gradients (whole and replicated for ``ring_attention_packed``, the local
shards' for ``ring_attention_inner``) agree with JAX's within 3e-5, the gate
of ``tests/test_ring_attention.py``. The port's hops take the plain version
of ``flash_attention_bwd`` on the CPU; the kernel under them is held on the
card (chip_smoke.py section 15).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from eeg2video_tpu.ops.ring import ring_attention_packed as jring

import _torch_dist_worker
from test_torch_models import capped_threads
from test_torch_ring import HEADS, D, N, L, _bias

_threads = capped_threads()

TOL = dict(rtol=3e-5, atol=3e-5)
CASES = {  # case -> (k, v, bias) of the call
    "ring": ("k", "v", None),
    "ring_bias": ("k", "v", "bias"),
    "repkv": ("k77", "v77", None),
    "repkv_bias": ("k77", "v77", "bias77"),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((N, L, HEADS * D)).astype(np.float32)
                     for _ in range(4))
    return {"heads": HEADS, "q": q, "k": k, "v": v, "dout": dout,
            "k77": np.ascontiguousarray(k[:, :77]), "v77": np.ascontiguousarray(v[:, :77]),
            "bias": _bias(rng, L), "bias77": _bias(rng, 77), "cases": CASES}


def _jax_grads(inp, mesh, k="k", v="v", bias=None, **kw):
    """[out, dq, dk, dv(, dbias)] of sum(ring(q, k, v, bias) * dout)."""
    ops = [jnp.asarray(inp[n]) for n in ("q", k, v)] + ([jnp.asarray(inp[bias])] if bias else [])
    dout = jnp.asarray(inp["dout"])

    def f(*a):
        return jring(*a[:3], HEADS, mesh, bias=a[3] if bias else None, **kw)

    out, vjp = jax.vjp(f, *ops)
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(dout)]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both spawns, started before JAX's side so that they overlap with it."""
    inp2, inp4 = _inputs(20), _inputs(21)
    tmp = tmp_path_factory.mktemp("ring_bwd")
    return {2: (inp2, _torch_dist_worker.start("ring_bwd_cases", 2, inp2, tmp)),
            4: (inp4, _torch_dist_worker.start("ring_bwd_sp_tp_cases", 4, inp4, tmp))}


@pytest.fixture(scope="module")
def jax_out(started):
    inp2, inp4 = started[2][0], started[4][0]
    sp = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    sp_tp = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("sp", "tp"))
    out = {case: _jax_grads(inp2, sp, *names) for case, names in CASES.items()}
    out["sp_tp"] = {b: _jax_grads(inp4, sp_tp, bias="bias" if b else None, head_axis="tp")
                    for b in (False, True)}
    return out


@pytest.fixture(scope="module")
def world2(started, jax_out):
    return started[2][1].join()


@pytest.fixture(scope="module")
def world4(started, jax_out):
    return started[4][1].join()


@pytest.mark.parametrize("case", list(CASES))
def test_ring_gradients_match_jax_at_sp_2(world2, jax_out, case):
    """Ring mode (the rotating dk / dv / dbias accumulators come home and are
    gathered over sp) and replicated-KV mode (summed over sp), with and
    without a (N, 1, Lkv) bias: every rank returns JAX's whole gradients."""
    want = jax_out[case]
    for res in world2:
        got = res[case]
        assert len(got) == len(want) == (5 if CASES[case][2] else 4)
        for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
            np.testing.assert_allclose(g, w, err_msg=f"{case} {name}", **TOL)


def test_inner_gradients_are_the_local_shards(world2, jax_out):
    """``ring_attention_inner`` on each rank's local q rows and K/V/bias
    block: its dq rows and its home block's dk / dv / dbias are JAX's global
    gradients at those rows and keys."""
    want = jax_out["ring_bias"]
    lq = L // 2
    for r, res in enumerate(world2):
        rows = slice(r * lq, (r + 1) * lq)
        got = res["inner"]
        for name, g, w in zip(("out", "dq", "dk", "dv"), got[:4], want[:4]):
            np.testing.assert_allclose(g, w[:, rows], err_msg=name, **TOL)
        np.testing.assert_allclose(got[4], want[4][..., rows], err_msg="dbias", **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_sp_2_by_tp_2_gradients_match_jax(world4, jax_out, with_bias):
    """Four ranks on a (1, 2, 2) mesh, heads over tp: the gradients gathered
    over sp and over tp by heads, dbias summed over tp, against JAX's (sp,
    tp) mesh with head_axis="tp"."""
    want = jax_out["sp_tp"][with_bias]
    for res in world4:
        got = res[with_bias]
        assert len(got) == len(want)
        for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)
