"""The plain reference held to the port at the tiny configurations, on the
CPU, in float32 on both sides (the port's CPU path runs its kernels' plain
versions). Each tolerance says what it allows for."""

import dataclasses

import numpy as np
import pytest
import torch

from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
from eeg2video_tpu_torch.diffusion.schedulers import DPMSolverPPSchedule
from eeg2video_tpu_torch.models.semantic import Int8SemanticPredictor
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from eeg2video_tpu_torch.serving.batching import _noise_batch
from eeg2video_tpu_torch.train.videodiffusion import (TrainState, VideoDiffusionTrainConfig,
                                                      train_epoch)
from perfbench.harness.context import rel_gap
from perfbench.harness.weights import make_state
from perfbench.reference import sampler, semantic, train, unet3d, vae
from perfbench.reference.numerics import Numerics

UCFG = {**{k: (list(v) if isinstance(v, tuple) else v)
           for k, v in dataclasses.asdict(UNet3DConfig.tiny()).items()},
        "cross_attention_dim": 768}
VCFG = {k: (list(v) if isinstance(v, tuple) else v)
        for k, v in dataclasses.asdict(VAEConfig.tiny()).items()}
SCFG = {"in_dim": 310, "hidden": 64, "n_hidden": 4, "out_dim": 77 * 768}
F32 = Numerics("f32")
# float32 round-off over some sixty layers, and the port's GroupNorm variance
# E[x^2] - E[x]^2 against the reference's E[(x - mean)^2]
MODEL_TOL = 1e-4


@pytest.fixture(scope="module")
def port_unet():
    cfg = UNet3DConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in UCFG.items()})
    weights = make_state(unet3d.param_shapes(UCFG), 5, "unet", "cpu")
    model = UNet3DConditionModel(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval(), weights


@pytest.fixture(scope="module")
def port_vae():
    weights = make_state(vae.param_shapes(VCFG), 5, "vae", "cpu")
    model = AutoencoderKL(VAEConfig.tiny())
    model.load_state_dict(weights, strict=True)
    return model.eval(), weights


@pytest.mark.parametrize("frames", [1, 2, 5])
def test_unet_forward(port_unet, frames):
    model, weights = port_unet
    g = torch.Generator().manual_seed(frames)
    x = torch.randn(2, frames, 9, 16, 4, generator=g)
    t = torch.tensor([10, 900])
    ctx = torch.randn(2, 77, 768, generator=g)
    with torch.no_grad():
        want = model(x, t, ctx)
        got = unet3d.UNet3D(weights, UCFG, F32)(x, t, ctx)
    assert rel_gap(got, want) < MODEL_TOL


def test_vae_decode(port_vae):
    model, weights = port_vae
    z = torch.randn(2, 5, 8, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.decode(z)
        got = vae.Decoder(weights, VCFG, F32)(z)
    assert rel_gap(got, want) < MODEL_TOL


def test_dpm_solver_tables_and_noise():
    ts, c = sampler.dpm_solver_pp(20)
    s = DPMSolverPPSchedule.create(20)
    assert np.array_equal(ts, s.timesteps)
    for mine, theirs in (("al_s", "alpha_s"), ("si_s", "sigma_s"), ("al_t", "alpha_t"),
                         ("si_t", "sigma_t"), ("h", "h"), ("r", "r")):
        assert np.array_equal(c[mine], getattr(s, theirs))
    want = _noise_batch([123], [7], (3, 4, 5, 4), "cpu")[0]
    assert torch.equal(sampler.clip_noise(123, 7, (3, 4, 5, 4), "cpu"), want)


def test_served_clip(port_unet, port_vae):
    """Embedding -> 20 DPM-Solver++ steps -> decode, through the port's
    pipeline in float32 and through the reference. Guidance 12.5 scales the
    two passes' differences, hence 1e-3."""
    (unet, uw), (model_vae, vw) = port_unet, port_vae
    pipe = EEG2VideoPipeline(unet=unet, vae=model_vae, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    emb, neg = torch.randn(77 * 768, generator=g), torch.randn(77 * 768, generator=g)
    noise = sampler.clip_noise(9, 2, (3, 16, 16, 4), "cpu")
    with torch.no_grad():
        want = pipe(emb[None].numpy(), neg.numpy(), latents=noise[None], video_length=3,
                    height=128, width=128, num_inference_steps=20, guidance_scale=12.5,
                    sampler="dpm++")[0]
        lat = sampler.denoise(unet3d.UNet3D(uw, UCFG, F32), emb.reshape(77, 768),
                              neg.reshape(77, 768), noise, 20, 12.5)
        got = sampler.decode(vae.Decoder(vw, VCFG, F32), lat)
    assert rel_gap(got, want) < 1e-3


def test_int8_semantic_predictor():
    """The port rounds each layer's input to bf16 before the int8 product;
    the reference keeps it in float32: 1e-2 covers bf16's 2^-9 over five
    layers."""
    weights = make_state(semantic.param_shapes(SCFG), 5, "semantic", "cpu")
    x = torch.randn(7, 310, generator=torch.Generator().manual_seed(2))
    want = Int8SemanticPredictor.from_state_dict(weights, "cpu")(x)
    got = semantic.predict(weights, SCFG, x)
    assert rel_gap(got, want) < 1e-2
    # int4 is no rounding of the same: it reads far off
    assert rel_gap(semantic.predict(weights, SCFG, x, "int4"), want) > 10 * rel_gap(got, want)


def test_train_steps(port_unet):
    """Three fine-tune steps in float32: each step's loss, the first step's
    clipped gradient (from AdamW's first moment) and the change after three
    steps, leaf by leaf. 1e-4 covers float32 round-off and the first moment's
    division by 1 - beta1."""
    _, weights = port_unet
    cfg = UNet3DConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in UCFG.items()})
    model = UNet3DConditionModel(cfg)
    model.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    state = TrainState(model, VideoDiffusionTrainConfig(compute_dtype="float32"), "cpu")
    g = torch.Generator().manual_seed(4)
    post = torch.cat([4 * torch.randn(6, 3, 8, 8, 4, generator=g),
                      -6 + torch.randn(6, 3, 8, 8, 4, generator=g)], dim=-1)
    ctxs = torch.randn(6, 77, 768, generator=g)
    rows = np.array([[0, 1], [2, 3], [4, 5]])
    start = {n: m.detach().clone() for n, m in state.masters.items()}
    losses, grads = [], {}

    def on_step(st, loss):
        losses.append(float(loss))
        if st.step == 1:
            for n, m in st.masters.items():
                grads[n] = float(torch.linalg.vector_norm(st.optimizer.state[m]["exp_avg"] / 0.1))

    train_epoch(state, None, post, ctxs, rows, 77, on_step=on_step)
    hp = {"learning_rate": 3e-5, "adam_beta1": 0.9, "adam_beta2": 0.999, "adam_epsilon": 1e-8,
          "adam_weight_decay": 1e-2, "max_grad_norm": 1.0}
    ref = train.follow({k: v.clone() for k, v in weights.items()}, UCFG, hp, F32,
                       [post[r] for r in rows], [ctxs[r] for r in rows], 77, micro=1)
    assert np.allclose(losses, ref["loss"], rtol=1e-4)
    for n in grads:
        assert grads[n] == pytest.approx(ref["grad_norm"][n], rel=1e-4, abs=1e-9)
        change = float(torch.linalg.vector_norm(state.masters[n].detach() - start[n]))
        assert change == pytest.approx(ref["change_norm"][n], rel=1e-4, abs=1e-9)
