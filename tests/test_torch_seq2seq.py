"""The port's Seq2Seq stage (models/seq2seq.py, train/seq2seq.py) against the
JAX package, on the CPU in float32.

The same weights (random from a numpy seed, BatchNorm running statistics that
are not the initial 0 / 1) go through ``seq2seq_state_dict_from_jax`` and load
with ``strict=True``; the same numpy inputs go through both. Tolerances: 2e-5
absolute for one block (float32 summation order), rtol 1e-3 / atol 1e-4 for
the whole model (six decoder passes of four layers feed each other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import inference_seq2seq_v2 as jcli
from eeg2video_tpu.convert.export_torch import semantic_to_torch as j_semantic_to_torch
from eeg2video_tpu.convert.export_torch import seq2seq_to_torch as j_seq2seq_to_torch
from eeg2video_tpu.models import seq2seq as jseq
from eeg2video_tpu.train import seq2seq as jtrain
from eeg2video_tpu.utils import StandardScaler as JScaler
from eeg2video_tpu_torch.cli import inference_seq2seq_v2 as cli
from eeg2video_tpu_torch.convert.export_torch import semantic_to_torch, seq2seq_to_torch
from eeg2video_tpu_torch.convert.from_jax import seq2seq_state_dict_from_jax
from eeg2video_tpu_torch.models import seq2seq as tseq
from eeg2video_tpu_torch.train import seq2seq as ttrain

from test_torch_models import capped_threads, rand, random_params

_threads = capped_threads()

BLOCK_TOL = dict(rtol=0, atol=2e-5)
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)


def _variables(module, seed, *args):
    """Random params plus BatchNorm running statistics away from (0, 1)."""
    rng = np.random.default_rng(seed + 1000)
    params = random_params(module, seed, *args)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))["batch_stats"]

    def fill(path, leaf):
        if path[-1].key == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return {"params": params,
            "batch_stats": jax.tree_util.tree_map_with_path(fill, shapes)}


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def default_model():
    """The default-size model of both packages on the same weights."""
    jmodel = jseq.Seq2SeqTransformer()
    variables = _variables(jmodel, 31, np.zeros((1, 7, 62, 100), np.float32))
    model = tseq.Seq2SeqTransformer().eval()
    model.load_state_dict(seq2seq_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def test_exporter_copy_equals_the_jax_package_s(default_model):
    _, variables, _ = default_model
    want, got = j_seq2seq_to_torch(variables), seq2seq_to_torch(variables)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = seq2seq_state_dict_from_jax(variables)
    assert sd["eeg_embedding.block_1.2.num_batches_tracked"].dtype == torch.int64
    assert sd["predictor.weight"].dtype == torch.float32


def test_semantic_exporter_copy_equals_the_jax_package_s():
    from eeg2video_tpu.models.semantic import SemanticPredictor

    module = SemanticPredictor(hidden=24, out_dim=7 * 8)
    variables = {"params": random_params(module, 33, np.zeros((1, 310), np.float32))}
    want, got = j_semantic_to_torch(variables), semantic_to_torch(variables)
    assert want.keys() == got.keys() and len(want) == 10
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_eegnet_embedding_matches_jax(default_model):
    jmodel, variables, model = default_model
    x = rand(np.random.default_rng(32), 5, 1, 62, 100)
    want = jseq.EEGNetEmbedding().apply(
        {"params": variables["params"]["eeg_embedding"],
         "batch_stats": variables["batch_stats"]["eeg_embedding"]}, x, train=False)
    with torch.no_grad():
        got = model.eeg_embedding(_t(x))
    assert got.shape == (5, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    # the running statistics matter: the initial ones give another answer
    fresh = tseq.EEGNetEmbedding().eval()
    fresh.load_state_dict({k: v for k, v in model.eeg_embedding.state_dict().items()
                           if "running" not in k}, strict=False)
    with torch.no_grad():
        assert not np.allclose(fresh(_t(x)).numpy(), np.asarray(want), atol=1e-3)


def test_encoder_and_decoder_layer_match_jax(default_model):
    _, variables, model = default_model
    rng = np.random.default_rng(33)
    x, memory = rand(rng, 3, 7, 512), rand(rng, 3, 7, 512)
    want = jseq._EncoderLayer(512).apply({"params": variables["params"]["enc1"]}, x)
    with torch.no_grad():
        got = model.transformer_encoder.layers[1](_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)

    causal = np.triu(np.full((7, 7), -np.inf, np.float32), k=1)
    want = jseq._DecoderLayer(512).apply({"params": variables["params"]["dec2"]}, x, memory,
                                         tgt_mask=jnp.asarray(causal)[None, None])
    with torch.no_grad():
        got = model.transformer_decoder.layers[2](_t(x), _t(memory), _t(causal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_rollout_matches_jax_at_default_size(default_model):
    jmodel, variables, model = default_model
    src = rand(np.random.default_rng(34), 3, 7, 62, 100)
    want_txt, want_lat = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, src)
    with torch.no_grad():
        txt, lat = model(_t(src))
    assert lat.shape == (3, 7, 4, 36, 64) and txt.shape == (3, 13)
    np.testing.assert_allclose(txt.numpy(), np.asarray(want_txt), **MODEL_TOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), **MODEL_TOL)
    # frame 0 is the zero token through the predictor: its bias
    np.testing.assert_allclose(lat[:, 0].reshape(3, -1).numpy(),
                               np.tile(np.asarray(variables["params"]["predictor"]["bias"]), (3, 1)),
                               rtol=0, atol=1e-6)
    assert sorted(tseq.sinusoidal_positions(7, 512).ravel()) == \
        sorted(jseq.sinusoidal_positions(7, 512).ravel())


def test_rollout_matches_jax_at_a_tiny_latent_shape_and_length():
    jmodel = jseq.Seq2SeqTransformer(n_frames=2, latent_shape=(4, 4, 4))
    variables = _variables(jmodel, 35, np.zeros((1, 7, 62, 100), np.float32))
    model = tseq.Seq2SeqTransformer(n_frames=2, latent_shape=(4, 4, 4)).eval()
    model.load_state_dict(seq2seq_state_dict_from_jax(variables), strict=True)
    src = rand(np.random.default_rng(36), 2, 7, 62, 100)
    _, want = jmodel.apply(variables, src, train=False)
    with torch.no_grad():
        _, lat = model(_t(src))
    assert lat.shape == (2, 3, 4, 4, 4)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want), **MODEL_TOL)


def test_windows_from_segments_equals_jax():
    seg = rand(np.random.default_rng(37), 2, 3, 62, 400)
    np.testing.assert_array_equal(ttrain.windows_from_segments(seg),
                                  jtrain.windows_from_segments(seg))
    assert ttrain.windows_from_segments(seg).shape == (2, 3, 7, 62, 100)
    assert ttrain.ROLLOUT_CHUNK == jtrain.ROLLOUT_CHUNK == 50
    with pytest.raises(ValueError, match="400-sample"):
        ttrain.windows_from_segments(seg[..., :399])


def test_rollout_latents_chunks_and_matches_jax():
    """51 rows = 2 dispatches of 50 (the second zero-padded): the same rows as
    one model call, and as the JAX package's rollout_latents."""
    jmodel = jseq.Seq2SeqTransformer(n_frames=2, latent_shape=(4, 2, 2))
    variables = _variables(jmodel, 38, np.zeros((1, 7, 62, 100), np.float32))
    model = tseq.Seq2SeqTransformer(n_frames=2, latent_shape=(4, 2, 2)).eval()
    model.load_state_dict(seq2seq_state_dict_from_jax(variables), strict=True)
    calls = []
    model.register_forward_pre_hook(lambda mod, args: calls.append(tuple(args[0].shape)))
    eeg = rand(np.random.default_rng(39), 51, 7, 62, 100)
    got = ttrain.rollout_latents(model, eeg)
    assert calls == [(50, 7, 62, 100)] * 2 and got.shape == (51, 2, 4, 2, 2)
    with torch.no_grad():
        whole = model(_t(eeg))[1][:, :-1].numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)
    want = jtrain.rollout_latents(variables, eeg, model=jmodel)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.fixture(scope="module")
def subject():
    """One segmented subject, (7, 40, 5, 62, 400)."""
    return rand(np.random.default_rng(40), 7, 40, 5, 62, 400)


def test_prepare_seq2seq_data_equals_jax(subject):
    rng = np.random.default_rng(41)
    tr_lat, te_lat = rand(rng, 1200, 4, 6, 1, 2), rand(rng, 200, 4, 6, 1, 2)
    got = ttrain.prepare_seq2seq_data(subject, tr_lat, te_lat)
    want = jtrain.prepare_seq2seq_data(subject, tr_lat, te_lat)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].shape == (1200, 7, 62, 100) and got[3].shape == (200, 6, 4, 1, 2)
    np.testing.assert_array_equal(got[4].mean, want[4].mean)
    np.testing.assert_array_equal(got[4].std, want[4].std)


def test_inference_seq2seq_cli_matches_jax_cli(default_model, subject, tmp_path):
    """Both CLIs on the same reference-format .pt, the stored EEG scaler and latent stats:
    the (200, 6, 4, 36, 64) artifact of block 7 in class order."""
    _, variables, model = default_model
    torch.save({"state_dict": model.state_dict()}, tmp_path / "seq2seqmodel.pt")
    np.save(tmp_path / "eeg.npy", subject)
    win = ttrain.windows_from_segments(subject[0].reshape(-1, 62, 400))
    JScaler().fit(win.reshape(len(win), -1)).save(str(tmp_path / "eeg_scaler.npz"))
    np.savez(tmp_path / "stats.npz", mean_z=np.float32(-0.2), std_z=np.float32(1.3))
    common = ["--eeg", str(tmp_path / "eeg.npy"), "--eeg_scaler", str(tmp_path / "eeg_scaler.npz"),
              "--torch_ckpt", str(tmp_path / "seq2seqmodel.pt"),
              "--stats_path", str(tmp_path / "stats.npz")]
    jcli.main([*common, "--out", str(tmp_path / "jax.npy")])
    cli.main([*common, "--out", str(tmp_path / "port.npy"), "--device", "cpu"])
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (200, 6, 4, 36, 64)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    with pytest.raises(ValueError, match="convert/from_jax.py"):
        cli.main([*common[:4], "--ckpt", str(tmp_path), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(common)
