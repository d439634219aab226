"""The port's ring attention forward (ops/ring.py) against the JAX package's
``ring_attention_packed`` on a 2-device mesh of the virtual CPU devices.

The port runs in two gloo processes (one spawn for the world-size-2 cases,
``tests/_torch_dist_worker.py``; 60 s group timeout, 120 s deadline) and one
of four for sp = 2 x tp = 2; JAX runs in the pytest process, its packed
flash kernel in interpret mode as its own tests run it. The same numpy
operands from a seed go to both, at ``HEADS, D = 2, 40`` and ``N, L = 2,
512`` in f32, and the outputs agree within 2e-5 (the exactness gate of
``tests/test_ring_attention.py``). The port's hops take the plain version of
``flash_attention_fwd`` on the CPU; the kernel under them is held on the card
(chip_smoke.py section 14).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from eeg2video_tpu.ops.ring import ring_attention_packed as jring

import _torch_dist_worker
from test_torch_models import capped_threads

_threads = capped_threads()

HEADS, D = 2, 40
N, L = 2, 512
TOL = dict(rtol=2e-5, atol=2e-5)


def _bias(rng, lkv):
    """(N, 1, Lkv): half the keys masked at -1e4, the rest a random offset."""
    mask = (rng.uniform(size=(N, 1, lkv)) < 0.5) * -1e4
    return (mask + rng.standard_normal((N, 1, lkv))).astype(np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((N, L, HEADS * D)).astype(np.float32) for _ in range(3))
    return {"heads": HEADS, "q": q, "k": k, "v": v, "k77": np.ascontiguousarray(k[:, :77]),
            "v77": np.ascontiguousarray(v[:, :77]), "bias": _bias(rng, L),
            "bias77": _bias(rng, 77)}


def _jax(inp, mesh, k="k", v="v", bias=None, **kw):
    b = None if bias is None else jnp.asarray(inp[bias])
    return np.asarray(jring(jnp.asarray(inp["q"]), jnp.asarray(inp[k]), jnp.asarray(inp[v]),
                            HEADS, mesh, bias=b, **kw))


CASES = {  # port result -> (k, v, bias) of the JAX call
    "ring": ("k", "v", None),
    "ring_bias": ("k", "v", "bias"),
    "repkv": ("k77", "v77", None),
    "repkv_bias": ("k77", "v77", "bias77"),
}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both spawns, started before JAX's side so that they overlap with it."""
    inp2, inp4 = _inputs(0), _inputs(9)
    tmp = tmp_path_factory.mktemp("ring")
    return {2: (inp2, _torch_dist_worker.start("ring_cases", 2, inp2, tmp)),
            4: (inp4, _torch_dist_worker.start("ring_sp_tp_cases", 4, inp4, tmp))}


@pytest.fixture(scope="module")
def jax_out(started):
    inp2, inp4 = started[2][0], started[4][0]
    sp = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    sp_tp = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("sp", "tp"))
    out = {case: _jax(inp2, sp, *names) for case, names in CASES.items()}
    out["sp_tp"] = {b: _jax(inp4, sp_tp, bias="bias" if b else None, head_axis="tp")
                    for b in (False, True)}
    return out


@pytest.fixture(scope="module")
def world2(started, jax_out):
    inp, handle = started[2]
    return inp, handle.join()


@pytest.mark.parametrize("case", list(CASES))
def test_ring_forward_matches_jax_at_sp_2(world2, jax_out, case):
    """Ring mode (KV blocks rotate, the bias shard with its block) and
    replicated-KV mode (the 77-token context stays whole), each with and
    without a (N, 1, Lkv) bias; both ranks return the whole output."""
    _, results = world2
    want = jax_out[case]
    for res in results:
        np.testing.assert_allclose(res[case], want, **TOL)
        assert res["groups"] == {"dp": None, "sp": [0, 1], "tp": None}


def test_sp_1_is_one_plain_call(world2):
    """On a mesh whose sp axis has size 1 the ring is one hop: the same
    values as flash_attention_plain, bit for bit."""
    _, results = world2
    assert all(res["sp1_equal"] for res in results)


def test_divisibility_errors_and_gradient_refusal(world2):
    _, results = world2
    for res in results:
        assert res["tokens_error"] == "query token axis 511 not divisible by sp=2"
        assert res["heads_error"] == "heads=1 not divisible by tp=2 for head sharding"
        assert "ring's backward is not ported yet" in res["grad_error"]
    # JAX's own wording of the two errors
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    q = jnp.zeros((N, 511, HEADS * D))
    with pytest.raises(ValueError, match="query token axis 511 not divisible by sp=2"):
        jring(q, q, q, HEADS, mesh)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("sp", "tp"))
    with pytest.raises(ValueError, match="heads=1 not divisible by tp=2 for head sharding"):
        jring(jnp.zeros((N, L, D)), jnp.zeros((N, L, D)), jnp.zeros((N, L, D)), 1, mesh,
              head_axis="tp")


@pytest.fixture(scope="module")
def world4(started, jax_out):
    inp, handle = started[4]
    return inp, handle.join()


@pytest.mark.parametrize("with_bias", [False, True])
def test_sp_2_by_tp_2_matches_jax(world4, jax_out, with_bias):
    """Four ranks on a (dp, sp, tp) = (1, 2, 2) mesh: each runs the ring over
    its heads // tp heads; against JAX's (sp, tp) mesh with head_axis="tp"
    (tests/test_ring_attention.py::test_sp_tp_head_sharded_composition)."""
    _, results = world4
    want = jax_out["sp_tp"][with_bias]
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["bias" if with_bias else "plain"], want, **TOL)
        assert res["groups"]["sp"] == [r % 2, r % 2 + 2] and res["groups"]["dp"] is None
        assert res["groups"]["tp"] == [r // 2 * 2, r // 2 * 2 + 1]
