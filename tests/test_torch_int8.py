"""The port's int8 dense layer and semantic predictor against the JAX package,
on the CPU.

On the CPU ``int8_dense`` takes its plain PyTorch version, so these tests hold
that plain version against the JAX package's Pallas kernel run in interpret
mode (what ``eeg2video_tpu.ops.int8_dense.int8_dense`` does off the TPU), on
the same inputs made with numpy from a seed. Tolerances:

- the quantizer is exact (same float32 arithmetic, round-half-even);
- ``int8_dense_plain`` and the int8 MLP: max error <= 2e-5 of the output's
  max (identical bf16 operands, float32 sums in another order);
- the float32 MLP: rtol 1e-4 / atol 1e-5 (five float32 matrix products).

The CUDA kernel itself is checked on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg2video_tpu.models.semantic import SemanticPredictor as JSemantic
from eeg2video_tpu.ops import int8_dense as jint8
from eeg2video_tpu.train.semantic import predict_semantic_int8
from eeg2video_tpu.utils import StandardScaler as JScaler
from eeg2video_tpu_torch.convert.from_jax import semantic_state_dict_from_jax
from eeg2video_tpu_torch.models.semantic import (Int8SemanticPredictor, SemanticPredictor,
                                                 semantic_state_dict_from_reference)
from eeg2video_tpu_torch.ops import _build, int8_dense
from eeg2video_tpu_torch.serving import runtimes
from eeg2video_tpu_torch.utils import StandardScaler

from test_torch_models import capped_threads

_threads = capped_threads()

INT8_BOUND = 2e-5


def _rel_max_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def _kernel(rng, k, n):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    w[:, 3] = 0.0             # an all-zero column: scale 0, zeros
    w[:, 5] *= 1e-3           # a small column
    w[0, 7] = 2.5             # an outlier that sets its column's scale
    return w


@pytest.mark.parametrize("k,n,bn", [(310, 700, 512), (64, 512, 512), (33, 9, 128), (96, 130, 512)])
def test_quantize_int8_equals_numpy_quantizer(k, n, bn):
    w = _kernel(np.random.default_rng(0), k, n)
    want_q, want_s = jint8.quantize_int8(w, bn=bn)
    got_q, got_s = int8_dense.quantize_int8(torch.from_numpy(w), bn=bn)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_q.shape) == want_q.shape and want_q.shape[0] % 32 == 0
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert got_s[3] == 0 and not got_q[:, 3].any()
    assert not got_s[n:].any() and not got_q[:, n:].any() and not got_q[k:].any()


def test_quantize_int8_takes_a_transposed_view():
    """The semantic runtime hands nn.Linear's (O, I) weight over as its
    transposed view."""
    w = _kernel(np.random.default_rng(1), 40, 24)
    a_q, a_s = int8_dense.quantize_int8(torch.from_numpy(w))
    b_q, b_s = int8_dense.quantize_int8(torch.from_numpy(np.ascontiguousarray(w.T)).t())
    assert torch.equal(a_q, b_q) and torch.equal(a_s, b_s) and b_q.is_contiguous()


@pytest.mark.parametrize("m", [1, 7, 100])
def test_int8_dense_plain_matches_pallas_kernel(m):
    rng = np.random.default_rng(m)
    k, n = 310, 700
    w_q, scale = jint8.quantize_int8(_kernel(rng, k, n))
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jint8.int8_dense(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale),
                                       jnp.asarray(bias), n))
    args = (torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale),
            torch.from_numpy(bias), n)
    got = int8_dense.int8_dense_plain(*args)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel_max_err(got.numpy(), want) <= INT8_BOUND
    # a CPU tensor takes the plain version through the wrapper, and counts no launch
    before = _build.launches["int8_dense"]
    torch.testing.assert_close(int8_dense.int8_dense(*args), got, rtol=0, atol=0)
    assert _build.launches["int8_dense"] == before


def test_k_splits_fills_the_card_and_respects_small_k():
    # a middle layer: 80 column blocks, 3 splits -> 240 blocks for 132 SMs
    assert int8_dense.k_splits(10240, 10016) == 3
    # the first layer has 5 K steps only
    assert int8_dense.k_splits(10240, 320) == 3
    # the output layer has 464 column blocks already
    assert int8_dense.k_splits(59392, 10016) == 1
    assert int8_dense.k_splits(128, 32) == 1
    assert int8_dense.k_splits(128, 64 * 100) == 8


HIDDEN, OUT_DIM = 64, 77 * 768


@pytest.fixture(scope="module")
def semantic():
    """(flax variables with numpy leaves, features (7, 310), scaler stats)."""
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(lambda: JSemantic(hidden=HIDDEN).init(
        jax.random.key(0), jnp.zeros((1, 310)))["params"])
    params = {}
    for name, leaf in shapes.items():
        k = leaf["kernel"].shape
        params[name] = {
            "kernel": (rng.standard_normal(k) / np.sqrt(k[0])).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)}
    feats = (3.0 * rng.standard_normal((7, 310)) + 1.0).astype(np.float32)
    train = (3.0 * rng.standard_normal((50, 310)) + 1.0).astype(np.float32)
    return {"params": params}, feats, train


def test_semantic_state_dict_keys_and_reference_keys(semantic):
    variables, _, _ = semantic
    sd = semantic_state_dict_from_jax(variables)
    model = SemanticPredictor(hidden=HIDDEN)
    model.load_state_dict(sd, strict=True)
    assert sd["fc0.weight"].shape == (HIDDEN, 310) and sd["out.weight"].shape == (OUT_DIM, HIDDEN)
    # the reference's eeg_text.py checkpoint names the same tensors mlp.0/2/4/6/8
    ref = {}
    for i, name in enumerate(["fc0", "fc1", "fc2", "fc3", "out"]):
        ref[f"mlp.{2 * i}.weight"] = sd[f"{name}.weight"]
        ref[f"mlp.{2 * i}.bias"] = sd[f"{name}.bias"]
    back = semantic_state_dict_from_reference(ref)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    assert semantic_state_dict_from_reference(sd).keys() == sd.keys()


def test_semantic_f32_matches_jax(semantic):
    variables, feats, _ = semantic
    want = np.asarray(JSemantic(hidden=HIDDEN).apply(variables, jnp.asarray(feats)))
    model = SemanticPredictor(hidden=HIDDEN).eval()
    model.load_state_dict(semantic_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    assert got.shape == (7, OUT_DIM)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_semantic_int8_runtime_matches_jax_with_padding_and_scaler(semantic):
    """The serving runtime: z-score, pad 7 rows to the 100-row chunk, five
    int8_dense calls with ReLU between, slice the padding off."""
    variables, feats, train = semantic
    jscaler = JScaler().fit(train)
    want = predict_semantic_int8(variables, jscaler.transform(feats))

    scaler = StandardScaler().fit(train)
    np.testing.assert_array_equal(scaler.transform(feats), jscaler.transform(feats))
    seen = []
    runtime = Int8SemanticPredictor.from_state_dict(semantic_state_dict_from_jax(variables), "cpu")

    def apply(x):
        seen.append(tuple(x.shape))
        return runtime(x)

    predict = runtimes.make_semantic_predict(apply, torch.device("cpu"), scaler)
    got = predict(feats)
    assert seen == [(runtimes.PREDICT_CHUNK, 310)]
    assert got.shape == (7, OUT_DIM) and got.dtype == np.float32
    assert _rel_max_err(got, want) <= INT8_BOUND
    # more rows than one chunk: two dispatches of the one shape
    many = np.concatenate([feats] * 15)
    assert predict(many).shape == (105, OUT_DIM) and seen[1:] == [(100, 310), (100, 310)]
    # a (7, 40, 5, 62, 5)-style stack flattens to rows of 310
    assert predict(feats.reshape(7, 62, 5)).shape == (7, OUT_DIM)


def test_int8_runtime_layers_are_the_jax_quantization(semantic):
    variables, _, _ = semantic
    runtime = Int8SemanticPredictor.from_state_dict(semantic_state_dict_from_jax(variables), "cpu")
    qt = jint8.quantize_dense_tree(variables["params"])
    for (w_q, scale, bias, n_out), name in zip(runtime.layers, ["fc0", "fc1", "fc2", "fc3", "out"]):
        jq, js, jb, jn = qt[name]
        np.testing.assert_array_equal(w_q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
        np.testing.assert_array_equal(bias.numpy(), np.asarray(jb))
        assert n_out == jn
