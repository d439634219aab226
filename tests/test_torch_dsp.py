"""The port's host and DSP stages against the JAX package, on the CPU:
dsp/de_psd.py, dsp/segment.py and diffusion/dana.py.

``de_psd`` windows in float32 and forms its products in float64, the JAX
function is float32 throughout: ``de`` agrees within 1e-4 relative (the JAX
function's own distance from the float64 oracle). The numpy oracle and the
segmentation are copies and must agree exactly. DANA gets JAX's three draws
passed in (1e-6: the same float32 arithmetic in another order); its generator
path is checked for determinism and structure, since torch and jax.random
draw different numbers from the same seed.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg2video_tpu.data import meta as jmeta
from eeg2video_tpu.diffusion import dana as jdana
from eeg2video_tpu.dsp import segment as jsegment
from eeg2video_tpu_torch.cli import add_noise
from eeg2video_tpu_torch.diffusion import dana
from eeg2video_tpu_torch.dsp import segment

from test_torch_models import capped_threads, rand

_threads = capped_threads()

# the modules, not the functions of the same name that the packages export
jde = importlib.import_module("eeg2video_tpu.dsp.de_psd")
tde = importlib.import_module("eeg2video_tpu_torch.dsp.de_psd")


@pytest.mark.parametrize("win_sec,samples", [(2.0, 400), (0.5, 100)])
def test_de_psd_matches_jax_and_the_oracle(win_sec, samples):
    x = 10.0 * rand(np.random.default_rng(41), 3, 4, 62, samples)
    want_de, want_psd = jde.de_psd(x, win_sec=win_sec)
    de, psd = tde.de_psd(x, win_sec=win_sec, device="cpu")
    assert de.shape == psd.shape == (3, 4, 62, 5) and de.dtype == psd.dtype == torch.float32
    np.testing.assert_allclose(de.numpy(), np.asarray(want_de), rtol=1e-4, atol=0)
    np.testing.assert_allclose(psd.numpy(), np.asarray(want_psd), rtol=1e-3, atol=0)
    # against the float64 oracle the float64 products leave float32 rounding only
    ode, opsd = tde.de_psd_numpy(x.astype(np.float64), time_window=win_sec)
    np.testing.assert_allclose(psd.numpy(), opsd, rtol=1e-5, atol=0)
    np.testing.assert_allclose(de.numpy(), ode, rtol=1e-5, atol=1e-5)
    # a tensor is computed where it lies
    de2, _ = tde.de_psd(torch.from_numpy(x), win_sec=win_sec)
    assert torch.equal(de2, de)


@pytest.mark.parametrize("win_sec,samples", [(2.0, 400), (0.5, 100)])
def test_de_psd_numpy_is_the_jax_package_s_oracle(win_sec, samples):
    x = rand(np.random.default_rng(42), 62, samples).astype(np.float64)
    for got, want in zip(tde.de_psd_numpy(x, time_window=win_sec),
                         jde.de_psd_numpy(x, time_window=win_sec)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tde.hann_window_ref(samples), jde.hann_window_ref(samples))
    np.testing.assert_array_equal(tde._band_matrix(200), jde._band_matrix(200, "float64"))


def test_de_psd_does_not_follow_the_global_matmul_precision():
    """The result must not change with torch's float32 matmul precision flag (on the card
    that flag turns TF32 on): the products are float64."""
    x = 10.0 * rand(np.random.default_rng(43), 5, 62, 400)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        a = tde.de_psd(x, device="cpu")[1]
        torch.set_float32_matmul_precision("medium")
        b = tde.de_psd(x, device="cpu")[1]
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="expected last axis 400"):
        tde.de_psd(x[..., :300], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tde.de_psd(x)  # the card by default


def test_segmentation_equals_jax():
    rng = np.random.default_rng(44)
    fs = 20  # a short recording: 40 concepts x (3 s hint + 5 x 2 s clips)
    t = 40 * (3 + 5 * 2) * fs
    data = rand(rng, 7, 62, t)
    np.testing.assert_array_equal(segment.segment_subject(data, fs=fs),
                                  np.asarray(jsegment.segment_subject(data, fs=fs)))
    np.testing.assert_array_equal(segment.segment_block(data[2], fs=fs),
                                  np.asarray(jsegment.segment_block(data[2], fs=fs)))
    assert segment.segment_subject(data, fs=fs).shape == (7, 40, 5, 62, 2 * fs)
    np.testing.assert_array_equal(
        segment.extract_2s_segment(data, 3, 17, 4, fs=fs),
        jsegment.extract_2s_segment(data, 3, 17, 4, fs=fs))
    np.testing.assert_array_equal(segment.extract_2s_segment(data, 3, 17, 4, fs=fs),
                                  segment.segment_subject(data, fs=fs)[3, 17, 4])
    for bad in ((7, 0, 0), (0, 40, 0), (0, 0, 5)):
        with pytest.raises(ValueError):
            segment.extract_2s_segment(data, *bad, fs=fs)
    seg = rand(rng, 2, 3, 62, 400)
    got = segment.sliding_windows(seg)
    np.testing.assert_array_equal(got, np.asarray(jsegment.sliding_windows(seg)))
    assert got.shape == (2, 3, 7, 62, 100)
    np.testing.assert_array_equal(segment.sliding_windows(seg, 1.0, 0.5),
                                  np.asarray(jsegment.sliding_windows(seg, 1.0, 0.5)))


@pytest.mark.parametrize("beta", [0.3, "per_clip"])
def test_dana_add_noise_matches_jax_on_jax_s_draws(beta):
    rng = np.random.default_rng(45)
    x0 = rand(rng, 4, 6, 4, 3, 5)
    betas = (np.asarray([0.3, 0.2, 0.2, 0.3], np.float32) if beta == "per_clip" else beta)
    key = jax.random.key(3407)
    want = jdana.dana_add_noise(key, jnp.asarray(x0), betas)
    # the draws dana_add_noise makes from that key (dana.py:37-40)
    kt, kd, ks = jax.random.split(key, 3)
    t = np.array(jax.random.randint(kt, (4,), 0, 500))
    diverse = np.array(jax.random.normal(kd, x0.shape, jnp.float32))
    same = np.array(jax.random.normal(ks, (4, 1, 4, 3, 5), jnp.float32))
    got = dana.dana_add_noise(None, torch.from_numpy(x0), betas, t=torch.from_numpy(t),
                              diverse=torch.from_numpy(diverse), same=torch.from_numpy(same))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_dana_generator_path_and_flow_to_beta():
    x0 = torch.zeros(3, 6, 4, 3, 5)
    draw = lambda seed, beta: dana.dana_add_noise(
        torch.Generator().manual_seed(seed), x0, beta, time_steps=50)
    a, b = draw(3407, 0.3), draw(3407, 0.3)
    assert torch.equal(a, b) and a.shape == x0.shape and bool(torch.isfinite(a).all())
    assert not torch.equal(a, draw(3408, 0.3))
    # x0 = 0, beta = 1: all of the noise is the shared sample, equal across frames
    shared = draw(1, 1.0)
    assert float(shared.std()) > 0 and torch.equal(shared, shared[:, :1].expand_as(shared))
    # beta = 0: per-frame noise only
    diverse = draw(1, 0.0)
    assert not torch.equal(diverse[:, 0], diverse[:, 1])
    np.testing.assert_array_equal(dana.dana_betas(), jdana.dana_betas())
    scores = np.asarray([0.1, 1.799, 1.7989, 5.0])
    np.testing.assert_allclose(dana.flow_to_beta(scores),  # JAX holds the betas in float32
                               np.asarray(jdana.flow_to_beta(scores)), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(dana.flow_to_beta(scores), [0.2, 0.3, 0.2, 0.3])
    np.testing.assert_array_equal(dana.flow_to_beta(scores, threshold=0.05), [0.3] * 4)
    assert (dana.DANA_TIME_STEPS, dana.FLOW_THRESHOLD, dana.BETA_FAST, dana.BETA_SLOW) == \
        (jdana.DANA_TIME_STEPS, jdana.FLOW_THRESHOLD, jdana.BETA_FAST, jdana.BETA_SLOW)


def test_add_noise_cli_orders_the_labels_and_writes_the_artifact(tmp_path):
    """The betas follow the flow table's block in class order (by the JAX package's
    reorder indices), the noise is the seeded generator's, ``--replicate_label_bug``
    keeps the presentation order, and the .pt artifact reads back."""
    rng = np.random.default_rng(46)
    lat = rand(rng, 200, 2, 4, 3, 3)
    flow = (4.0 * rng.random((7, 200))).astype(np.float32)
    np.save(tmp_path / "lat.npy", lat)
    np.save(tmp_path / "flow.npy", flow)
    common = ["--latents", str(tmp_path / "lat.npy"), "--flow_scores", str(tmp_path / "flow.npy"),
              "--block", "4", "--seed", "11", "--device", "cpu"]
    add_noise.main([*common, "--out", str(tmp_path / "dana.pt")])
    add_noise.main([*common, "--out", str(tmp_path / "bug.npy"), "--replicate_label_bug"])
    got = torch.load(tmp_path / "dana.pt")
    labels = flow[4] >= 1.799
    ordered = labels.reshape(40, 5)[jmeta.block_reorder_indices(4)].reshape(-1)
    for name, lab in (("dana", ordered), ("bug", labels)):
        betas = np.asarray(jdana.flow_to_beta(np.where(lab, 5.0, 0.0)), np.float32)
        want = dana.dana_add_noise(torch.Generator().manual_seed(11), torch.from_numpy(lat), betas)
        out = got if name == "dana" else torch.from_numpy(np.load(tmp_path / "bug.npy"))
        assert torch.equal(out, want), name
    assert got.shape == lat.shape and got.dtype == torch.float32
    assert not np.array_equal(ordered, labels)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            add_noise.main(common[:-2])
