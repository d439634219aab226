"""Multi-GPU generation in the port (EEG2VideoPipeline.shard and
inference_eeg2video --dp) against the JAX package's sharded pipeline.

The pipeline is JAX's ``_tiny_pipeline`` of tests/test_pipeline_sharded.py
(``UNet3DConfig.tiny()`` with cross_attention_dim 768, ``VAEConfig.tiny()``,
f32) at F = 3 frames, so that the sparse-causal [K0 | K_prev] concat runs
(tests/test_sp_product.py:29), 32x32, 3 DDIM steps, explicit latents. Random
weights made with numpy from a seed in the port's state-dict layout go to the
port's workers at once and to JAX through its own converters
(``eeg2video_tpu.convert.unet_params``).
The port runs in one spawn of two gloo processes
(``tests/_torch_dist_worker.py``; 60 s group timeout, 120 s deadline) at
(dp, sp, tp) = (2,1,1), (1,2,1) and (1,1,2); JAX runs in the pytest process,
once, on a (2, 2, 2) mesh of the 8 virtual CPU devices, which splits every
axis that the port's three meshes split (one trace of JAX's sharded pipeline
in place of three; JAX's own gate holds that pipeline to its unsharded run
within 2e-5, test_pipeline_sharded.py:52). Tolerances: rtol 1e-3 / atol 1e-4
against JAX (whole models), 2e-5 against the port's own run on one process.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg2video_tpu.convert.unet_params import unet3d_params_from_torch_3d, vae_params_from_torch
from eeg2video_tpu.diffusion.pipeline import EEG2VideoPipeline as JPipeline
from eeg2video_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from eeg2video_tpu.models.vae import VAEConfig as JVAEConfig
from eeg2video_tpu.parallel import make_mesh as jmake_mesh
from eeg2video_tpu.train import unet_tp_rules as jrules
from eeg2video_tpu_torch.cli import inference_eeg2video
from eeg2video_tpu_torch.data.video import load_gif
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig

import _torch_dist_worker
from test_torch_models import capped_threads, random_state

_threads = capped_threads()

F = 3
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
SELF_TOL = dict(rtol=2e-5, atol=2e-5)
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2)]
JAX_MESH = (2, 2, 2)  # dp, sp, tp of the JAX oracle
KW = dict(video_length=F, height=32, width=32, num_inference_steps=3, guidance_scale=7.5)


def _jcfg():
    return dataclasses.replace(JUNetConfig.tiny(), cross_attention_dim=768)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The workers, started before JAX's side so that the two overlap."""
    tmp = tmp_path_factory.mktemp("sharded")
    with torch.device("meta"):
        unet = random_state(UNet3DConditionModel(
            dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768)), 10)
        vae = random_state(AutoencoderKL(VAEConfig.tiny()), 8)
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((3, 77 * 768)).astype(np.float32)
    neg = rng.standard_normal(77 * 768).astype(np.float32)
    lat = rng.standard_normal((3, F, 4, 4, 4)).astype(np.float32)
    np.save(tmp / "emb.npy", emb)
    cli = ["--embeddings", str(tmp / "emb.npy"), "--woSeq2Seq", "--device", "cpu",
           "--batch", "2", "--video_length", str(F), "--height", "32", "--width", "32",
           "--num_inference_steps", "2", "--gif_encoder", "fast", "--seed", "7"]
    inputs = {
        "unet": unet, "vae": vae, "emb": emb, "neg": neg, "lat": lat, "kw": KW,
        "cli_args": [*cli, "--out_dir", str(tmp / "dp2")], "cli_out": str(tmp / "dp2")}
    handle = _torch_dist_worker.start("generation_cases", 2, inputs, tmp)
    uparams = unet3d_params_from_torch_3d(unet)["params"]
    vparams = vae_params_from_torch(vae, enc_layers=VAEConfig.tiny().layers_per_block)["params"]
    return uparams, vparams, inputs, handle, tmp


@pytest.fixture(scope="module")
def jax_video(started):
    """JAX's sharded pipeline on the JAX_MESH mesh of 8 devices."""
    uparams, vparams, inputs, _, _ = started
    dp, sp, tp = JAX_MESH
    jpipe = JPipeline.create(uparams, vparams, _jcfg(), JVAEConfig.tiny(), dtype=jnp.float32)
    jpipe = jpipe.shard(jmake_mesh(dp=dp, tp=tp, sp=sp, devices=jax.devices()[:dp * sp * tp]),
                        jrules)
    return np.asarray(jpipe(inputs["emb"][:2], inputs["neg"], latents=inputs["lat"][:2], **KW))


@pytest.fixture(scope="module")
def world(started, jax_video):
    uparams, vparams, inputs, handle, tmp = started
    return uparams, vparams, inputs, handle.join(), tmp


@pytest.fixture(scope="module")
def unsharded(world):
    """The port on one process, the same pipeline and inputs."""
    _, _, inputs, _, _ = world
    pipe = _torch_dist_worker._tiny_pipeline(inputs)
    video = pipe(inputs["emb"][:2], inputs["neg"], latents=inputs["lat"][:2], **KW).numpy()
    drawn = pipe(inputs["emb"][:2], inputs["neg"], generator=torch.Generator().manual_seed(5),
                 **{**KW, "num_inference_steps": 1, "decode": False}).numpy()
    return video, drawn


@pytest.mark.parametrize("dims", MESHES, ids=["dp2", "sp2", "tp2"])
def test_sharded_pipeline_matches_jax_and_the_unsharded_run(world, jax_video, unsharded,
                                                           dims):
    _, _, _, results, _ = world
    want = jax_video
    video, _ = unsharded
    assert video.shape == (2, F, 32, 32, 3)
    for res in results:  # whole on every rank
        got = res["videos"][dims]
        np.testing.assert_allclose(got, want, **MODEL_TOL)
        np.testing.assert_allclose(got, video, **SELF_TOL)


def test_attention_calls_of_one_forward_at_sp_2(world):
    """What one UNet forward launches per rank at sp = 2: a transformer block
    whose L divides by 2 runs 2 hops for frames 0-1, 2 for frames 2.. and 1
    replicated-KV call for cross-attention; one whose L does not (the 1x1
    levels of 32x32 clips) takes the one-GPU path's 3 calls. The tiny UNet
    at 4x4 latents: 10 blocks at L = 16 and 4, 6 at L = 1."""
    _, _, _, results, _ = world
    assert all(res["sp_calls"] == 10 * 5 + 6 * 3 for res in results)


def test_indivisible_batch_is_refused_by_name(world):
    _, _, _, results, _ = world
    assert all(res["batch_error"] == "batch 3 not divisible by dp=2" for res in results)


def test_noise_is_drawn_for_the_whole_batch(world, unsharded):
    """latents=None at dp = 2: every rank draws the global batch from the
    generator and takes its slice, so the clips are the unsharded run's."""
    _, _, _, results, _ = world
    _, drawn = unsharded
    for res in results:
        np.testing.assert_allclose(res["drawn"], drawn, **SELF_TOL)


def test_inference_main_dp_2_writes_from_rank_0_only(world, monkeypatch):
    """inference_eeg2video.main --dp 2 over two processes: 3 clips in batches
    of 2, so the tail clip is padded to a dp multiple and dropped again; rank
    0 makes the out_dir and writes the GIF names of the run on one process,
    rank 1 writes nothing, and every frame is within 2/255 of that run's."""
    _, _, inputs, results, tmp = world
    monkeypatch.setattr(inference_eeg2video, "load_pipeline",
                        lambda *a, **k: _torch_dist_worker._tiny_pipeline(inputs))
    args = [*inputs["cli_args"][:-2], "--out_dir", str(tmp / "one")]
    inference_eeg2video.main(args)
    names = sorted(p.name for p in (tmp / "one").iterdir())
    assert names == ["0.gif", "1.gif", "2.gif"]
    assert results[0]["written"] == names and results[1]["written"] == []
    assert results[0]["dir_made"]
    assert sorted(p.name for p in (tmp / "dp2").iterdir()) == names
    for name in names:
        got = load_gif(str(tmp / "dp2" / name)).astype(np.int16)
        want = load_gif(str(tmp / "one" / name)).astype(np.int16)
        assert got.shape == want.shape == (F, 32, 32, 3)
        assert np.abs(got - want).max() <= 2, name
