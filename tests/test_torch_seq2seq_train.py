"""The port's Seq2Seq transformer in train mode, its trainer
(train/seq2seq.py) and the CLIs train_seq2seq_v2 and generate_video_latents
against the JAX package, on the CPU in float32.

Dropout is switched off on both sides where outputs are compared (JAX's
``flax.linen.Dropout`` made an identity inside the test, the port's dropouts
at p = 0): the two packages draw from different generators (ROADMAP §3).
Tolerances: rtol 1e-3 / atol 1e-4 for the whole model's outputs and the
running statistics (six decoder passes feed each other); gradients within
2e-3 of each tensor's largest entry (tests/test_torch_train.py's rule);
losses rtol 1e-4 after one epoch; 99.9% of the model's parameter entries
within 1e-5 and every entry within what Adam can move a weight in those
steps, a learning rate (5e-4) a step: Adam's first steps move a weight by about the learning
rate whatever its gradient's size, so where a gradient is small against
float32 noise the two sides move it differently.

Some parameters get no gradient in exact arithmetic: the first EEGNet
BatchNorm's scale and shift (each of its channels feeds its own depthwise
convolution, whose outputs the next BatchNorm normalizes) and the key bias of
every attention (it adds q . b to a whole row of logits, which the softmax
removes). Their float32 gradients are rounding noise, of either sign on
either side, and Adam's first steps move a weight by the learning rate
whatever the gradient's size: the BatchNorm's are held to noise-level
gradients, and all of them to a learning rate a step.
"""

import collections
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import generate_video_latents as jgen
from eeg2video_tpu.data import meta as jmeta
from eeg2video_tpu.models import seq2seq as jseq
from eeg2video_tpu.models.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from eeg2video_tpu.train import checkpoint as jckpt
from eeg2video_tpu.train import seq2seq as jtrain
from eeg2video_tpu_torch.cli import generate_video_latents, inference_seq2seq_v2
from eeg2video_tpu_torch.cli import train_seq2seq_v2
from eeg2video_tpu_torch.convert.export_diffusion import save_diffusers_pipeline
from eeg2video_tpu_torch.convert.from_jax import (seq2seq_state_dict_from_jax,
                                                  vae_state_dict_from_jax)
from eeg2video_tpu_torch.data import meta, video
from eeg2video_tpu_torch.models import seq2seq as tseq
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import VAEConfig
from eeg2video_tpu_torch.train import seq2seq as ttrain

from test_torch_models import capped_threads, rand, random_params
from test_torch_seq2seq import _variables

_threads = capped_threads()

MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_RTOL = 2e-3
LOSS_RTOL, PARAM_ATOL, LR = 1e-4, 1e-5, 5e-4
TINY = dict(n_frames=2, latent_shape=(4, 4, 4))
# the parameters whose exact gradient is zero (see above)
NO_GRADIENT = ("eeg_embedding.block_1.2.weight", "eeg_embedding.block_1.2.bias")


def _no_gradient(name, shape):
    """The entries of parameter ``name`` whose exact gradient is zero."""
    mask = np.full(shape, name in NO_GRADIENT)
    if name.endswith("in_proj_bias"):
        mask[shape[0] // 3: 2 * shape[0] // 3] = True  # the key bias
    return mask


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax's Dropout as an identity, for this test only."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, tseq.Dropout):
            m.p = 0.0
    return model


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def tiny():
    """The default transformer with 2 frames of (4, 4, 4) latents, the same
    random weights (and running statistics away from 0 / 1) on both sides."""
    jmodel = jseq.Seq2SeqTransformer(**TINY)
    variables = _variables(jmodel, 41, np.zeros((1, 7, 62, 100), np.float32))
    return jmodel, variables


def _port(variables):
    model = tseq.Seq2SeqTransformer(**TINY)
    model.load_state_dict(seq2seq_state_dict_from_jax(variables), strict=True)
    return model


def test_train_forward_gradients_and_running_stats_match_jax(tiny, no_jax_dropout):
    """One train-mode forward and backward of the loss the trainer takes,
    against ``apply(train=True, mutable=["batch_stats"])``: outputs, every
    parameter's gradient, the updated running statistics."""
    jmodel, variables = tiny
    rng = np.random.default_rng(42)
    src, y = rand(rng, 3, 7, 62, 100), rand(rng, 3, 2, 4, 4, 4)

    def loss_fn(params):
        (txt, lat), mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       src, train=True, mutable=["batch_stats"])
        return jnp.mean((lat[:, :-1] - y) ** 2), (txt, lat, mut["batch_stats"])

    (jloss, (jtxt, jlat, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    model = _no_dropout(_port(variables)).train()
    txt, lat = model(_t(src))
    loss = torch.mean((lat[:, :-1] - _t(y)) ** 2)
    loss.backward()
    np.testing.assert_allclose(txt.detach().numpy(), np.asarray(jtxt), **MODEL_TOL)
    np.testing.assert_allclose(lat.detach().numpy(), np.asarray(jlat), **MODEL_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)

    # the gradient tree and the new statistics in the port's key space
    want = seq2seq_state_dict_from_jax(jax.device_get({"params": jgrads, "batch_stats": jstats}))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads["txtpredictor.weight"] is None and grads["img_embedding.weight"] is None
    largest = max(float(g.abs().max()) for g in grads.values() if g is not None)
    compared = 0
    for name, g in grads.items():
        if g is None:  # unused by the loss: JAX's gradient is zero there
            assert not np.asarray(want[name]).any(), name
            continue
        w = want[name].numpy()
        if name in NO_GRADIENT:
            assert max(float(g.abs().max()), np.abs(w).max()) <= 1e-5 * largest, name
            continue
        assert np.abs(g.numpy() - w).max() <= GRAD_RTOL * np.abs(w).max(), name
        compared += 1
    assert compared > 50
    buffers = dict(model.named_buffers())
    stats = [k for k in buffers if "running" in k]
    assert len(stats) == 6
    for k in stats:
        np.testing.assert_allclose(buffers[k].numpy(), want[k].numpy(), err_msg=k, **MODEL_TOL)
        assert not np.allclose(buffers[k].numpy(),
                               seq2seq_state_dict_from_jax(variables)[k].numpy()), k
    assert int(buffers["eeg_embedding.block_1.2.num_batches_tracked"]) == 1


def test_batchnorm_updates_with_the_biased_variance():
    bn = tseq.BatchNorm2d(3).train()
    x = torch.randn(4, 3, 2, 5, generator=torch.Generator().manual_seed(0))
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))


def test_dropout_sites_and_rates_match_jax(tiny, monkeypatch):
    """Every dropout JAX's train-mode apply calls (by module path) has a
    counterpart in the port at the same rate, and each port dropout runs once
    a call, the decoder's once a rollout step."""
    jmodel, variables = tiny
    sites = {}

    def record(self, x, *a, **k):
        sites[self.scope.path] = self.rate
        return x

    monkeypatch.setattr(fnn.Dropout, "__call__", record)
    src = rand(np.random.default_rng(43), 2, 7, 62, 100)
    jmodel.apply(variables, src, train=True, mutable=["batch_stats"])
    monkeypatch.undo()
    want = collections.Counter(sites.values())
    assert want == {0.5: 2, 0.1: 2 * 4 + 4 * 6}

    model = _port(variables).train()
    ports = {n: m for n, m in model.named_modules() if isinstance(m, tseq.Dropout)}
    assert collections.Counter(m.p for m in ports.values()) == want
    calls = collections.Counter()
    for name, m in ports.items():
        m.register_forward_hook(lambda mod, inp, out, name=name: calls.update([name]))
    model(_t(src))
    assert set(calls) == set(ports)
    assert all(n == (TINY["n_frames"] if ".transformer_decoder." in f".{k}" else 1)
               for k, n in calls.items())
    # cross-subject EEGNet drops a quarter
    assert [m.p for m in tseq.EEGNetEmbedding(cross_subject=True).modules()
            if isinstance(m, tseq.Dropout)] == [0.25, 0.25]


def test_dropout_draws_follow_the_generator_and_eval_is_deterministic(tiny):
    _, variables = tiny
    model = _port(variables)
    src = _t(rand(np.random.default_rng(44), 2, 7, 62, 100))

    def run(seed, epoch):
        model.load_state_dict(seq2seq_state_dict_from_jax(variables))
        model.train().set_dropout_generator(ttrain.step_generator(seed, epoch, "cpu"))
        with torch.no_grad():
            return model(src)[1]

    a, b, c = run(0, 1), run(0, 1), run(0, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(src)[1], model(src)[1])
    drop = tseq.Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(0)
    out = drop(torch.ones(10000))
    assert set(out.unique().tolist()) == {0.0, 2.0} and abs(float(out.mean()) - 1.0) < 0.05


def test_train_seq2seq_matches_jax(tiny, monkeypatch, no_jax_dropout):
    """One epoch of 2 steps (8 windows at batch 4) from JAX's own initial
    weights: the epoch's loss, every parameter and the running statistics."""
    monkeypatch.setattr(jtrain, "Seq2SeqTransformer", lambda: jseq.Seq2SeqTransformer(**TINY))
    rng = np.random.default_rng(45)
    eeg, lat = rand(rng, 8, 7, 62, 100), rand(rng, 8, 2, 4, 4, 4)
    cfg = dict(epochs=1, batch_size=4)
    jvars, jlosses = jtrain.train_seq2seq(eeg, lat, jtrain.Seq2SeqTrainConfig(**cfg), seed=0)
    init = jseq.Seq2SeqTransformer(**TINY).init(
        jax.random.key(0), jnp.zeros((2, 7, 62, 100), jnp.float32), train=False)
    model = _no_dropout(_port(jax.device_get(init)))
    sd, losses = ttrain.train_seq2seq(eeg, lat, ttrain.Seq2SeqTrainConfig(**cfg), seed=0,
                                      model=model, device="cpu")
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want = seq2seq_state_dict_from_jax(jax.device_get(jvars))
    assert sd.keys() == want.keys()
    within, entries = 0, 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):  # the port's own count (JAX keeps none)
            assert int(sd[k]) == 2, k
            continue
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **MODEL_TOL)
            continue
        err = np.abs(sd[k].numpy() - v.numpy())
        assert err.max() <= 2 * LR, (k, err.max())  # two steps
        rest = err[~_no_gradient(k, err.shape)]
        within += int((rest <= PARAM_ATOL).sum())
        entries += rest.size
    assert within >= 0.999 * entries, (within, entries)
    moved = seq2seq_state_dict_from_jax(jax.device_get(init))
    assert not torch.equal(sd["predictor.weight"], moved["predictor.weight"])


def test_train_seq2seq_cli_round_trips_through_inference(tmp_path, monkeypatch):
    """``train_seq2seq_v2 --normalize`` on a subject (tiny latents): the EEG
    scaler, the latent stats, the checkpoint and the de-normalized block-7
    rollout; ``inference_seq2seq_v2 --ckpt`` on the checkpoint gives that
    rollout again."""
    factory = lambda: tseq.Seq2SeqTransformer(**TINY)  # noqa: E731
    for module in (ttrain, train_seq2seq_v2, inference_seq2seq_v2):
        monkeypatch.setattr(module, "Seq2SeqTransformer", factory)
    rng = np.random.default_rng(46)
    np.save(tmp_path / "eeg.npy", rand(rng, 7, 40, 5, 62, 400))
    train_lat = 2.0 + 3.0 * rand(rng, 1200, 4, 2, 4, 4)
    np.save(tmp_path / "train.npy", train_lat)
    np.save(tmp_path / "test.npy", rand(rng, 200, 4, 2, 4, 4))
    out = tmp_path / "s2s"
    common = ["--eeg", str(tmp_path / "eeg.npy"), "--train_latents", str(tmp_path / "train.npy"),
              "--test_latents", str(tmp_path / "test.npy"), "--device", "cpu"]
    assert train_seq2seq_v2.main([*common, "--save_path", str(out), "--epochs", "1",
                                  "--batch_size", "600", "--normalize"]) == 0
    assert sorted(os.listdir(out)) == ["eeg_scaler.npz", "latent_out_block7_40_classes.npy",
                                       "seq2seq.pt", "stats.npz"]
    _, tr_lat, _, _, scaler = jtrain.prepare_seq2seq_data(
        np.load(tmp_path / "eeg.npy"), train_lat, np.load(tmp_path / "test.npy"))
    z = np.load(out / "stats.npz")
    np.testing.assert_array_equal(z["mean_z"], tr_lat.mean(axis=0, keepdims=True))
    np.testing.assert_array_equal(z["std_z"], tr_lat.std(axis=0, keepdims=True) + 1e-8)
    np.testing.assert_array_equal(np.load(out / "eeg_scaler.npz")["std_z"], scaler.std)
    rollout = np.load(out / "latent_out_block7_40_classes.npy")
    assert rollout.shape == (200, 2, 4, 4, 4) and np.isfinite(rollout).all()
    assert abs(float(rollout.mean()) - 2.0) < 1.0  # de-normalized: back near the latents' mean

    inference_seq2seq_v2.main([*common, "--ckpt", str(out / "seq2seq.pt"),
                               "--stats_path", str(out / "stats.npz"),
                               "--out", str(tmp_path / "again.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "again.npy"), rollout)


def test_generate_video_latents_matches_jax(tmp_path, monkeypatch):
    """Two blocks of two 2-frame 32x32 GIFs through ``VAEConfig.tiny()``
    (a diffusers directory): the posterior means in (N, C, F, H, W), against
    the JAX CLI on the same weights and files."""
    for m in (meta, jmeta):
        monkeypatch.setattr(m, "N_CONCEPTS", 1)
        monkeypatch.setattr(m, "N_REPS", 2)
    monkeypatch.setattr(jmeta, "GIF_FRAMES", 2)
    rng = np.random.default_rng(47)
    for blk in (0, 1):
        for i in range(2):
            clip = rng.integers(0, 256, (1, 2, 32, 32, 3)).astype(np.float32) / 255.0
            video.save_videos_grid(clip, str(tmp_path / "gifs" / f"Block{blk}" / f"{i}.gif"),
                                   encoder="fast")
    vparams = random_params(JVAE(JVAEConfig.tiny()), 48, np.zeros((1, 16, 16, 3), np.float32))
    save_diffusers_pipeline(str(tmp_path / "sd"), UNet3DConditionModel(UNet3DConfig.tiny())
                            .state_dict(), UNet3DConfig.tiny(),
                            vae_state_dict_from_jax(vparams, VAEConfig.tiny()), VAEConfig.tiny())
    jckpt.save_checkpoint(str(tmp_path / "vae_jax"), 0, {"params": vparams})
    monkeypatch.setattr(jgen, "VAEConfig", JVAEConfig.tiny)
    jgen.main(["--gif_root", str(tmp_path / "gifs"), "--vae", str(tmp_path / "vae_jax"),
               "--blocks", "0", "1", "--out", str(tmp_path / "jax.npy"), "--batch", "3"])
    assert generate_video_latents.main([
        "--gif_root", str(tmp_path / "gifs"), "--vae", str(tmp_path / "sd"), "--blocks", "0", "1",
        "--out", str(tmp_path / "port.npy"), "--batch", "3", "--device", "cpu"]) == 0
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (4, 4, 2, 4, 4)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
