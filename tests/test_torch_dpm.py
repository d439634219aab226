"""The port's DPM-Solver++(2M) schedule, sampler plumbing and latent-layout
helpers against the JAX package, on the CPU.

Tolerances: tables and single steps 1e-6 (the same f64 host tables cast to
f32, the same f32 step arithmetic); the analytic cases carry the bounds of
tests/test_dpm_solver.py; the whole pipeline rtol 1e-3 / atol 1e-4 (float32
summation-order noise compounding through the UNet, as for the DDIM
pipeline in tests/test_torch_models.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eeg2video_tpu.convert import export_diffusion as jed
from eeg2video_tpu.diffusion import pipeline as jpipeline
from eeg2video_tpu.diffusion.schedulers import DPMSolverPPSchedule as JDPM
from eeg2video_tpu.models.unet3d import (UNet3DConditionModel as JUNet,
                                         UNet3DConfig as JUNetConfig)
from eeg2video_tpu.models.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from eeg2video_tpu_torch.convert import export_diffusion as ed
from eeg2video_tpu_torch.convert.from_jax import (unet_state_dict_from_jax,
                                                  vae_state_dict_from_jax)
from eeg2video_tpu_torch.diffusion.pipeline import (EEG2VideoPipeline,
                                                    latents_from_torch_layout,
                                                    video_to_torch_layout)
from eeg2video_tpu_torch.diffusion.schedulers import DDIMSchedule, DPMSolverPPSchedule
from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
from eeg2video_tpu_torch.models.vae import VAEConfig

from test_torch_models import MODEL_TOL, rand, random_params

TABLES = ("alphas_cumprod", "alpha_s", "sigma_s", "alpha_t", "sigma_t", "h", "r")


@pytest.mark.parametrize("steps", [1, 2, 20, 50, 999])
def test_dpm_tables_match_jax(steps):
    ours, ref = DPMSolverPPSchedule.create(steps), JDPM.create(steps)
    np.testing.assert_array_equal(ours.timesteps, np.asarray(ref.timesteps))
    for name in TABLES:
        got = getattr(ours, name)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(getattr(ref, name)), rtol=1e-6, atol=1e-6)
    assert ours.init_noise_sigma == ref.init_noise_sigma == 1.0


@pytest.mark.parametrize("steps", [0, 1001])
def test_dpm_rejects_out_of_range_steps(steps):
    with pytest.raises(ValueError, match="num_inference_steps"):
        DPMSolverPPSchedule.create(steps)


def test_dpm_step_matches_jax_over_a_20_step_loop():
    """Both walk the same loop on the same random model outputs, each
    carrying its own state, so a drift would compound."""
    steps = 20
    ours, ref = DPMSolverPPSchedule.create(steps), JDPM.create(steps)
    rng = np.random.default_rng(3)
    x = rand(rng, 2, 3, 4, 4, 4)
    tx, tx0 = torch.from_numpy(x), torch.zeros(x.shape)
    jx, jx0 = jnp.asarray(x), jnp.zeros(x.shape, jnp.float32)
    for i in range(steps):
        eps = rand(rng, *x.shape)
        tx, tx0 = ours.step(torch.from_numpy(eps), i, tx, tx0)
        jx, jx0 = ref.step(jnp.asarray(eps), jnp.asarray(i), jx, jx0)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    # one step from identical state: the bound of a single update
    eps = rand(rng, *x.shape)
    a, a0 = ours.step(torch.from_numpy(eps), 7, torch.from_numpy(x), torch.from_numpy(eps))
    b, b0 = ref.step(jnp.asarray(eps), jnp.asarray(7), jnp.asarray(x), jnp.asarray(eps))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a0.numpy(), np.asarray(b0), rtol=1e-6, atol=1e-6)


def _run_dpm(eps_fn, x, n_steps):
    sched = DPMSolverPPSchedule.create(n_steps)
    x0p = torch.zeros_like(x)
    for i in range(n_steps):
        x, x0p = sched.step(eps_fn(x, int(sched.timesteps[i])), i, x, x0p)
    return x.numpy()


def _run_ddim(eps_fn, x, n_steps):
    sched = DDIMSchedule.create(n_steps)
    for t in sched.timesteps:
        x = sched.step(eps_fn(x, int(t)), t, x)
    return x.numpy()


def test_constant_x0_model_is_exact():
    """eps built so the implied x0 prediction is mu at every t: the
    exponential integrator is exact at any step count, and so is DDIM."""
    ac = torch.from_numpy(DPMSolverPPSchedule.create(10).alphas_cumprod)
    mu = torch.from_numpy(rand(np.random.default_rng(0), 2, 3))

    def eps_fn(x, t):
        return (x - torch.sqrt(ac[t]) * mu) / torch.sqrt(1.0 - ac[t])

    x = torch.from_numpy(rand(np.random.default_rng(1), 2, 3))
    for n in (1, 4, 10):
        np.testing.assert_allclose(_run_dpm(eps_fn, x, n), _run_ddim(eps_fn, x, n),
                                   rtol=2e-4, atol=2e-4)


def test_second_order_beats_ddim_on_gaussian_model():
    """The exact eps-posterior of Gaussian data x0 ~ N(0, S2 I): 20 DPM++
    steps land closer to the 500-step DDIM solution than 20 DDIM steps."""
    s2 = 4.0
    ac = DPMSolverPPSchedule.create(10).alphas_cumprod

    def eps_fn(x, t):
        a = float(ac[min(int(t), len(ac) - 1)])
        return np.float32(np.sqrt(1.0 - a) / (a * s2 + (1.0 - a))) * x

    x = torch.from_numpy(rand(np.random.default_rng(2), 4, 5))
    ref = _run_ddim(eps_fn, x, 500)
    dpm_err = np.abs(_run_dpm(eps_fn, x, 20) - ref).max()
    ddim_err = np.abs(_run_ddim(eps_fn, x, 20) - ref).max()
    scale = np.abs(ref).max()
    assert dpm_err < 0.03 * scale, (dpm_err, scale)
    assert dpm_err < 0.4 * ddim_err, (dpm_err, ddim_err)


@pytest.fixture(scope="module")
def tiny_pipelines():
    """The JAX pipeline and the port's, tiny configs, the same weights."""
    jcfg = dataclasses.replace(JUNetConfig.tiny(), cross_attention_dim=768)
    cfg = dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768)
    uparams = random_params(JUNet(jcfg), 10, np.zeros((1, 2, 4, 4, 4), np.float32),
                            jnp.asarray([3]), np.zeros((1, 7, 768), np.float32))
    vparams = random_params(JVAE(JVAEConfig.tiny()), 8, np.zeros((1, 16, 16, 3), np.float32))
    jpipe = jpipeline.EEG2VideoPipeline.create(uparams, vparams, jcfg, JVAEConfig.tiny(),
                                               dtype=jnp.float32)
    pipe = EEG2VideoPipeline.create(
        unet_state_dict_from_jax(uparams, cfg),
        vae_state_dict_from_jax(vparams, VAEConfig.tiny()), cfg, VAEConfig.tiny(),
        dtype=torch.float32, device="cpu")
    return jpipe, pipe, uparams, vparams, jcfg


@pytest.mark.parametrize("decode", [True, False])
def test_pipeline_dpm_parity(tiny_pipelines, decode):
    """CFG pair with per-clip negatives, 4 DPM++ steps (first-order first
    and last, second-order between), latents injected."""
    jpipe, pipe = tiny_pipelines[:2]
    rng = np.random.default_rng(12)
    emb, neg = rand(rng, 2, 77 * 768), rand(rng, 2, 77 * 768)
    lat = rand(rng, 2, 2, 4, 4, 4)
    kw = dict(latents=lat, video_length=2, height=32, width=32, num_inference_steps=4,
              guidance_scale=7.5, sampler="dpm++", decode=decode)
    ref = np.asarray(jpipe(emb, neg, **kw))
    out = pipe(emb, neg, **kw)
    assert out.shape == ((2, 2, 32, 32, 3) if decode else (2, 2, 4, 4, 4))
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def test_export_copy_equals_the_jax_package_exporter(tiny_pipelines):
    """The port keeps its own copy of the Flax -> diffusers key mapping: on
    one tree both write the same keys and arrays."""
    _, _, uparams, vparams, jcfg = tiny_pipelines
    for ours, theirs in ((ed.unet3d_to_torch(uparams), jed.unet3d_to_torch(uparams)),
                         (ed.vae_to_torch(vparams, enc_layers=1),
                          jed.vae_to_torch(vparams, enc_layers=1))):
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
    assert len(ed.unet3d_to_torch(uparams)) > 100 and jcfg.layers_per_block == 2


def test_latents_from_torch_layout_disambiguation():
    """The cases of the JAX package's test (tests/test_pipeline.py), against
    the port and against the JAX function itself."""
    b, h, w = 2, 6, 8
    ch_first = np.arange(b * 4 * 6 * h * w, dtype=np.float32).reshape(b, 4, 6, h, w)
    fr_first = np.transpose(ch_first, (0, 2, 1, 3, 4))  # (B, 6, 4, H, W)
    out_a = latents_from_torch_layout(ch_first, frames=6)
    out_b = latents_from_torch_layout(fr_first, frames=6)
    assert out_a.shape == (b, 6, h, w, 4)
    np.testing.assert_array_equal(out_a, out_b)
    np.testing.assert_array_equal(out_a, jpipeline.latents_from_torch_layout(ch_first, frames=6))
    np.testing.assert_array_equal(latents_from_torch_layout(torch.from_numpy(ch_first)),
                                  jpipeline.latents_from_torch_layout(ch_first))

    amb = np.zeros((b, 4, 4, h, w), np.float32)
    with pytest.raises(ValueError, match="ambiguous"):
        latents_from_torch_layout(amb)
    with pytest.raises(ValueError, match="ambiguous"):
        latents_from_torch_layout(amb, frames=4)
    with pytest.raises(ValueError, match="does not match"):
        latents_from_torch_layout(ch_first, frames=5)
    with pytest.raises(ValueError, match="unrecognized"):
        latents_from_torch_layout(np.zeros((2, 4, 6, 8), np.float32))


def test_video_to_torch_layout():
    v = rand(np.random.default_rng(0), 2, 3, 4, 5, 3)
    want = jpipeline.video_to_torch_layout(v)
    np.testing.assert_array_equal(video_to_torch_layout(v), want)
    np.testing.assert_array_equal(video_to_torch_layout(torch.from_numpy(v)), want)
    assert want.shape == (2, 3, 3, 4, 5)
