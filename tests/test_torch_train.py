"""The port's fine-tune path (eeg2video_tpu_torch.train, cli.train_tuneavideo)
against the JAX package, on the CPU, in float32 at a micro size.

The same weights (random, made with numpy from a seed, carried through
convert.from_jax) and the same inputs go through both. The random draws of a
step (timesteps, noise, the posterior's eps) are made in the test exactly as
the JAX step makes them (``fold_in(key, step)`` then ``split(., 3)``) and
handed to the port, whose own generator draws different numbers.

Tolerances: 2e-5 for one transformer block; rtol 1e-3 / atol 1e-4 for whole
models (float32 summation order compounding through tens of layers, as in
tests/test_torch_models.py); trainable gradients 2e-3 of each tensor's
largest entry; parameters after two optimizer steps within 1e-5 of JAX's
at every entry and within 3e-7 on average (each step moves a weight by about
the learning rate, 3e-5: Adam's first updates are g / (|g| + eps), so
float32 noise in g reaches the update only at the few entries whose |g| is
small against that noise; optax clips by max(norm, 1) and
``clip_grad_norm_`` by norm + 1e-6).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg2video_tpu.diffusion.schedulers import DDPMSchedule as JDDPM
from eeg2video_tpu.models import attention3d as ja
from eeg2video_tpu.models.unet3d import (UNet3DConditionModel as JUNet,
                                         UNet3DConfig as JUNetConfig)
from eeg2video_tpu.models.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from eeg2video_tpu.train import videodiffusion as jvd
from eeg2video_tpu_torch.cli import train_tuneavideo as cli
from eeg2video_tpu_torch.convert import export_diffusion as ed
from eeg2video_tpu_torch.convert.from_jax import (grads_state_dict_from_jax,
                                                  unet_state_dict_from_jax,
                                                  vae_state_dict_from_jax)
from eeg2video_tpu_torch.data import video
from eeg2video_tpu_torch.diffusion.schedulers import DDPMSchedule
from eeg2video_tpu_torch.models import attention3d
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from eeg2video_tpu_torch.train import checkpoint as ckpt
from eeg2video_tpu_torch.train import videodiffusion as vd

from test_torch_models import capped_threads

_threads = capped_threads()

BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_RTOL = 2e-3
STEP_ATOL, STEP_MEAN_ATOL = 1e-5, 3e-7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's smallest structurally complete UNet: two levels, one
# layer each, every block class, four transformer blocks
JCFG = JUNetConfig.micro()
CFG = UNet3DConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(UNet3DConfig)})
N_BLOCKS = 4
B, F, HW, S = 2, 3, 8, 5  # batch, frames, latent side, context tokens
# float32, recompute on for every block with >= 16 tokens per frame (levels 0, 1)
JTCFG = jvd.VideoDiffusionTrainConfig(compute_dtype="float32", remat=True, remat_min_hw=16)
TCFG = vd.VideoDiffusionTrainConfig(compute_dtype="float32", remat=True, remat_min_hw=16)


def random_params(module, seed, *args, **kwargs):
    """Random float32 values for ``module``'s flax parameter tree: matrices
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *args, **kwargs)["params"])

    def fill(path, leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            r = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif path[-1].key == "scale":
            r = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            r = 0.1 * rng.standard_normal(shape)
        return r.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def tt(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def unet_params():
    return random_params(JUNet(JCFG), 1, np.zeros((1, F, HW, HW, 4), np.float32),
                         jnp.asarray([3]), np.zeros((1, S, JCFG.cross_attention_dim), np.float32))


def port_unet(params, cfg=CFG):
    mod = UNet3DConditionModel(cfg)
    mod.load_state_dict(unet_state_dict_from_jax(params, cfg), strict=True)
    return mod


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    post = np.concatenate([rand(rng, B, F, HW, HW, 4), 0.3 * rand(rng, B, F, HW, HW, 4)], axis=-1)
    return post, rand(rng, B, S, JCFG.cross_attention_dim)


def jax_draws(key, step, post_shape):
    """(t, noise, eps) as the JAX loss draws them at ``step``."""
    b, f = post_shape[:2]
    lat = post_shape[2:4] + (4,)
    k_t, k_eps, k_lat = jax.random.split(jax.random.fold_in(key, step), 3)
    eps = jax.random.normal(k_lat, (b * f,) + lat, jnp.float32)
    t = jax.random.randint(k_t, (b,), 0, 1000)
    noise = jax.random.normal(k_eps, (b, f) + lat, jnp.float32)
    return tt(t), tt(noise), tt(eps)


# --- models with train=True ------------------------------------------------------

def _block_state(tree):
    sd = {}
    for name in ("attn1", "attn2", "attn_temp"):
        ed._attention(sd, name, tree[name])
    for name in ("norm1", "norm2", "norm3", "norm_temp"):
        ed._norm(sd, name, tree[name])
    ed._dense(sd, "ff.net.0.proj", tree["ff"]["proj"])
    ed._dense(sd, "ff.net.2", tree["ff"]["out"])
    return {k: tt(v) for k, v in sd.items()}


@pytest.mark.parametrize("frames", [1, 2, 4])
def test_basic_transformer_block_train_parity(frames):
    rng = np.random.default_rng(3)
    x, ctx = rand(rng, 2, frames, 16, 16), rand(rng, 2, 5, 12)
    jmod = ja.BasicTransformerBlock(heads=2, head_dim=8)
    params = random_params(jmod, 4, x, ctx)
    ref = jax.jit(lambda p: jmod.apply({"params": p}, x, ctx, train=True))(params)
    mod = attention3d.BasicTransformerBlock(16, 2, 8, 12)
    mod.load_state_dict(_block_state(params), strict=True)
    out = mod(tt(x), tt(ctx), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **BLOCK_TOL)
    with torch.no_grad():  # the inference layouts compute the same function
        np.testing.assert_allclose(mod(tt(x), tt(ctx)).numpy(), np.asarray(ref), **BLOCK_TOL)


def test_micro_unet_train_parity(unet_params):
    rng = np.random.default_rng(5)
    sample, ctx = rand(rng, B, F, HW, HW, 4), rand(rng, B, S, JCFG.cross_attention_dim)
    t = np.asarray([1, 999], np.int32)
    junet = JUNet(JCFG, remat=True, remat_min_hw=16)
    ref = jax.jit(lambda p: junet.apply({"params": p}, sample, t, ctx, train=True))(unet_params)
    mod = port_unet(unet_params)
    out = mod(tt(sample), tt(t), tt(ctx), train=True, remat=True, remat_min_hw=16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MODEL_TOL)


# --- the freeze rule ---------------------------------------------------------------

def test_trainable_selects_what_the_jax_rule_selects(unet_params):
    """Mark every JAX leaf with its rule's verdict, carry the marks through
    the weight converter, and compare with the port's rule name by name."""
    marks = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, float(jvd.trainable(p)), np.float32), unet_params)
    sd = unet_state_dict_from_jax(marks, CFG)
    assert set(sd) == set(UNet3DConditionModel(CFG).state_dict())
    chosen = {n for n in sd if vd.trainable(n)}
    assert chosen == {n for n, v in sd.items() if bool(v.all())}
    assert all(float(v.min()) == float(v.max()) for v in sd.values())
    n_jax = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map_with_path(
        lambda p, x: int(jvd.trainable(p)), unet_params)))
    # per transformer block: attn_temp (to_q, to_k, to_v, to_out.0 weight and
    # bias) + attn1.to_q + attn2.to_q = 7 tensors
    assert len(chosen) == n_jax == 7 * N_BLOCKS
    full = [n for n in UNet3DConditionModel(UNet3DConfig.tiny()).state_dict() if vd.trainable(n)]
    assert len(full) == 7 * 16  # the four-level layout has 16 blocks
    assert vd.trainable("mid_block.attentions.0.transformer_blocks.0.attn_temp.to_out.0.bias")
    assert not vd.trainable("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k.weight")
    assert not vd.trainable("down_blocks.0.attentions.0.transformer_blocks.0.norm_temp.weight")


# --- one step: loss and gradients ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_and_grads(unet_params, batch):
    post, ctx = batch
    key = jax.random.key(7)
    loss_fn = jvd._make_loss_fn(JCFG, JVAEConfig.tiny(), JTCFG)
    k = jax.random.fold_in(key, 0)
    return jax.jit(jax.value_and_grad(loss_fn))(unet_params, None, post, ctx, k)


def _port_loss_and_grads(unet_params, batch, tcfg):
    post, ctx = batch
    state = vd.init_video_train_state(port_unet(unet_params), tcfg, "cpu")
    t, noise, eps = jax_draws(jax.random.key(7), 0, post.shape)
    loss = vd.video_loss(state.unet, None, tt(post), tt(ctx), tcfg, t=t, noise=noise, eps=eps)
    loss.backward()
    return state, float(loss.detach())


def test_loss_and_trainable_gradients_match_jax(unet_params, batch, jax_loss_and_grads):
    jloss, jgrads = jax_loss_and_grads
    state, loss = _port_loss_and_grads(unet_params, batch, TCFG)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = grads_state_dict_from_jax(jgrads, CFG)
    for name, p in state.unet.named_parameters():
        if vd.trainable(name):
            g, w = p.grad.numpy(), want[name].numpy()
            assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max(), name
        else:
            assert p.grad is None and not p.requires_grad
            assert float(want[name].abs().max()) == 0.0  # stop_gradient on the JAX side


def test_twelve_heads_over_ten_frames_match_jax():
    """The micro UNet at attention_heads=12 (head dims 2 and 5: not a multiple of 8,
    nor of 32 / heads, 12 not dividing 32) on clips of 10 frames: the loss and the
    trainable gradients against ``jax.value_and_grad`` of the JAX loss, whose
    temporal attention is its Pallas kernel (interpret mode) at these counts."""
    jcfg = dataclasses.replace(JCFG, attention_heads=12)
    cfg = UNet3DConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(UNet3DConfig)})
    frames, key = 10, jax.random.key(8)
    params = random_params(JUNet(jcfg), 9, np.zeros((1, frames, HW, HW, 4), np.float32),
                           jnp.asarray([3]), np.zeros((1, S, jcfg.cross_attention_dim), np.float32))
    rng = np.random.default_rng(10)
    post = np.concatenate([rand(rng, 1, frames, HW, HW, 4),
                           0.3 * rand(rng, 1, frames, HW, HW, 4)], axis=-1)
    ctx = rand(rng, 1, S, jcfg.cross_attention_dim)
    loss_fn = jvd._make_loss_fn(jcfg, JVAEConfig.tiny(), JTCFG)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, None, post, ctx,
                                                         jax.random.fold_in(key, 0))
    state = vd.init_video_train_state(port_unet(params, cfg), TCFG, "cpu")
    t, noise, eps = jax_draws(key, 0, post.shape)
    loss = vd.video_loss(state.unet, None, tt(post), tt(ctx), TCFG, t=t, noise=noise, eps=eps)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = grads_state_dict_from_jax(jgrads, cfg)
    for name, p in state.unet.named_parameters():
        if vd.trainable(name):
            g, w = p.grad.numpy(), want[name].numpy()
            assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max(), name


def test_gradients_are_equal_with_and_without_checkpointing(unet_params, batch):
    with_remat, l1 = _port_loss_and_grads(unet_params, batch, TCFG)
    without, l2 = _port_loss_and_grads(unet_params, batch,
                                       dataclasses.replace(TCFG, remat=False))
    assert l1 == l2
    for (n, p), (_, q) in zip(with_remat.unet.named_parameters(),
                              without.unet.named_parameters()):
        if p.requires_grad:
            assert torch.equal(p.grad, q.grad), n


def test_train_all_gives_every_parameter_a_gradient(unet_params, batch):
    state, _ = _port_loss_and_grads(unet_params, batch,
                                    dataclasses.replace(TCFG, train_all=True))
    assert len(state.masters) == len(list(state.unet.parameters()))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in state.unet.parameters())


# --- optimizer steps ---------------------------------------------------------------

def test_two_optimizer_steps_match_make_video_train_step(unet_params, batch):
    post, ctx = batch
    key = jax.random.key(7)
    jstate = jvd.init_video_train_state(jax.tree.map(jnp.asarray, unet_params), JTCFG)
    jstep = jvd.make_video_train_step(JCFG, JVAEConfig.tiny(), JTCFG)
    state = vd.init_video_train_state(port_unet(unet_params), TCFG, "cpu")
    before = {n: p.detach().clone() for n, p in state.unet.named_parameters()}
    for step in range(2):
        jstate, jloss = jstep(jstate, None, jnp.asarray(post), jnp.asarray(ctx), key)
        t, noise, eps = jax_draws(key, step, post.shape)
        loss = vd.train_step(state, None, tt(post), tt(ctx), seed=0, t=t, noise=noise, eps=eps)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert state.step == int(jstate.step) == 2
    want = unet_state_dict_from_jax(jax.device_get(jstate.params), CFG)
    moved = 0.0
    for name, p in state.unet.named_parameters():
        if vd.trainable(name):
            diff = (p.detach() - want[name]).abs()
            assert diff.max().item() <= STEP_ATOL and diff.mean().item() <= STEP_MEAN_ATOL, name
            moved = max(moved, (p.detach() - before[name]).abs().max().item())
            assert name in {n for n in state.masters}
            assert len(state.optimizer.state[state.masters[name]]) > 0
        else:
            assert torch.equal(p.detach(), before[name]), name  # bit-equal
            assert torch.equal(p.detach(), want[name]), name
            assert p.grad is None
    assert 2e-5 < moved < 1e-4  # two steps of about the learning rate each
    held = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    assert held == {id(p) for p in state.masters.values()}  # no moments for frozen weights


def test_bf16_state_keeps_f32_masters_and_frozen_truth(unet_params, batch):
    """compute_dtype bfloat16 on the CPU (plain versions): the model is a
    bf16 working copy, the trainable masters are f32 and move, the frozen
    f32 originals are handed back bit-equal."""
    post, ctx = batch
    unet = port_unet(unet_params)
    loaded = {n: p.detach().clone() for n, p in unet.named_parameters()}
    state = vd.init_video_train_state(unet, dataclasses.replace(TCFG, compute_dtype="bfloat16"),
                                      "cpu")
    loss = vd.train_step(state, None, tt(post), tt(ctx), seed=3)
    assert np.isfinite(float(loss))
    assert all(p.dtype == torch.bfloat16 for p in state.unet.parameters())
    params = state.params_f32()
    assert list(params) == list(loaded) and all(v.dtype == torch.float32 for v in params.values())
    for name, v in params.items():
        if vd.trainable(name):
            assert not torch.equal(v, loaded[name]), name
            assert torch.equal(dict(state.unet.named_parameters())[name].detach(),
                               v.to(torch.bfloat16)), name
        else:
            assert torch.equal(v, loaded[name]), name


def test_save_restore_resume_is_exact(unet_params, batch, tmp_path):
    post, ctx = tt(batch[0]), tt(batch[1])
    state = vd.init_video_train_state(port_unet(unet_params), TCFG, "cpu")
    vd.train_step(state, None, post, ctx, seed=5)
    path = ckpt.save_train_state(str(tmp_path / "ckpt"), 1, state)
    assert os.path.basename(path) == "train_state_1.pt"
    vd.train_step(state, None, post, ctx, seed=5)
    straight = state.params_f32()

    resumed = vd.init_video_train_state(port_unet(unet_params), TCFG, "cpu")
    assert ckpt.restore_train_state(str(tmp_path / "ckpt"), resumed) == 1
    vd.train_step(resumed, None, post, ctx, seed=5)
    assert resumed.step == state.step == 2
    for name, v in resumed.params_f32().items():
        assert torch.equal(v, straight[name]), name

    saved = torch.load(path, weights_only=False)
    assert list(saved["params"]) == list(state.unet.state_dict())
    assert all(v.dtype == torch.float32 for v in saved["params"].values())
    other = vd.init_video_train_state(port_unet(unet_params),
                                      dataclasses.replace(TCFG, train_all=True), "cpu")
    with pytest.raises(ValueError, match="freeze rule"):
        ckpt.restore_train_state(path, other)
    shifted = random_params(JUNet(JCFG), 99, np.zeros((1, F, HW, HW, 4), np.float32),
                            jnp.asarray([3]), np.zeros((1, S, JCFG.cross_attention_dim), np.float32))
    with pytest.raises(ValueError, match="frozen weight differs"):
        ckpt.restore_train_state(path, vd.init_video_train_state(port_unet(shifted), TCFG, "cpu"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "nothing"), state)


# --- VAE encoder, posteriors, DDPM -----------------------------------------------

@pytest.fixture(scope="module")
def tiny_vae():
    return random_params(JVAE(JVAEConfig.tiny()), 8, np.zeros((1, 16, 16, 3), np.float32))


def test_vae_encode_and_posteriors_match_jax(tiny_vae):
    rng = np.random.default_rng(9)
    pixels = np.tanh(rand(rng, 2, 3, 16, 24, 3))
    jvae = JVAE(JVAEConfig.tiny())
    mean, logvar = jax.jit(lambda p, x: jvae.apply({"params": p}, x, method=JVAE.encode))(
        tiny_vae, pixels.reshape(6, 16, 24, 3))
    mod = AutoencoderKL(VAEConfig.tiny())
    mod.load_state_dict(vae_state_dict_from_jax(tiny_vae, VAEConfig.tiny()), strict=True)
    with torch.no_grad():
        got_mean, got_logvar = mod.encode(tt(pixels.reshape(6, 16, 24, 3)))
    assert got_mean.shape == (6, 2, 3, 4)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), **MODEL_TOL)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(logvar), **MODEL_TOL)
    ref = jvd.encode_posteriors(tiny_vae, pixels, JVAEConfig.tiny(), compute_dtype="float32")
    post = vd.encode_posteriors(mod, pixels, batch=4)
    assert post.shape == (2, 3, 2, 3, 8) and post.dtype == torch.float32
    np.testing.assert_allclose(post.numpy(), ref, **MODEL_TOL)


def test_loss_on_pixels_encodes_them_first(unet_params, tiny_vae):
    """Pixels and their precomputed posteriors give the same loss."""
    rng = np.random.default_rng(10)
    pixels = tt(np.tanh(rand(rng, B, F, 64, 64, 3)))
    ctx = tt(rand(rng, B, S, CFG.cross_attention_dim))
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(vae_state_dict_from_jax(tiny_vae, VAEConfig.tiny()), strict=True)
    unet = port_unet(unet_params).requires_grad_(False)
    t, noise, eps = jax_draws(jax.random.key(1), 0, (B, F, HW, HW, 8))
    with torch.no_grad():
        a = vd.video_loss(unet, vae, pixels, ctx, TCFG, t=t, noise=noise, eps=eps)
        b = vd.video_loss(unet, None, vd.encode_posteriors(vae, pixels), ctx, TCFG, t=t,
                          noise=noise, eps=eps)
    assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))


def test_ddpm_schedule_matches_jax():
    ours, ref = DDPMSchedule.create(), JDDPM.create()
    np.testing.assert_array_equal(ours.alphas_cumprod, np.asarray(ref.alphas_cumprod))
    assert ours.num_train_timesteps == ref.num_train_timesteps == 1000
    rng = np.random.default_rng(11)
    x0, noise = rand(rng, 3, 2, 4, 4, 4), rand(rng, 3, 2, 4, 4, 4)
    t = np.asarray([0, 500, 999], np.int32)
    np.testing.assert_allclose(ours.add_noise(tt(x0), tt(noise), tt(t)).numpy(),
                               np.asarray(ref.add_noise(x0, noise, t)), rtol=1e-6, atol=1e-6)


def test_step_generator_depends_on_seed_and_step_only():
    a = torch.randn(4, generator=vd.step_generator(3, 7, "cpu"))
    assert torch.equal(a, torch.randn(4, generator=vd.step_generator(3, 7, "cpu")))
    assert not torch.equal(a, torch.randn(4, generator=vd.step_generator(3, 8, "cpu")))
    assert not torch.equal(a, torch.randn(4, generator=vd.step_generator(4, 7, "cpu")))


# --- convert -----------------------------------------------------------------------

def test_unet3d_from_torch_2d_inflates_as_the_jax_converter_does(unet_params):
    """A 2-D checkpoint (the 3-D one minus its temporal keys) inflates to the
    same non-temporal weights; the temporal ones get the fresh-init values:
    LayerNorm (1, 0), to_out zero, to_q/k/v of lecun-normal scale."""
    sd3 = unet_state_dict_from_jax(unet_params, CFG)
    sd2 = {k: v for k, v in sd3.items() if "_temp." not in k}
    model = UNet3DConditionModel(CFG)
    out = ed.unet3d_from_torch_2d(sd2, model, torch.Generator().manual_seed(0))
    model.load_state_dict(out, strict=True)
    for k, v in out.items():
        if k in sd2:
            assert torch.equal(v, sd2[k]), k
        elif ".norm_temp." in k:
            assert torch.equal(v, torch.ones_like(v) if k.endswith("weight") else torch.zeros_like(v))
        elif ".to_out." in k:
            assert not v.any(), k
        else:
            fan_in = v.shape[1]
            assert abs(float(v.std()) * fan_in ** 0.5 - 1.0) < 0.15, k
            assert float(v.abs().max()) <= 2.0 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
    with pytest.raises(KeyError, match="conv_in.weight"):
        ed.unet3d_from_torch_2d({k: v for k, v in sd2.items() if k != "conv_in.weight"}, model)


# --- the CLI -----------------------------------------------------------------------

def test_apply_reference_config_reads_the_shipped_yaml():
    import yaml

    args = cli.build_parser().parse_args([])
    with open(os.path.join(REPO, "configs", "all_40_video.yaml")) as f:
        remat = cli.apply_reference_config(args, yaml.safe_load(f))
    assert remat is True
    assert args.learning_rate == 3e-5 and args.train_batch_size == 10 and args.seed == 33
    assert args.epochs == 200 and args.checkpointing_epochs == 100
    assert args.validation_epochs == 100 and args.validation_steps == 50
    assert args.output_dir == "./outputs/40_classes_200_epoch/"
    assert args.video_dir == "./data/Video_mp4/Block0"
    with pytest.raises(SystemExit, match="trainable_modules"):
        cli.apply_reference_config(args, {"trainable_modules": ["attn1"]})


def test_a_jax_command_line_with_captions_parses():
    """``--captions`` is defined, with its default, and never read by the JAX
    CLI (eeg2video_tpu/cli/train_tuneavideo.py:105); the port takes it too."""
    line = ["--captions", "./data/BLIP/other.txt", "--video_dir", "v", "--epochs", "3"]
    args = cli.build_parser().parse_args(line)
    assert args.captions == "./data/BLIP/other.txt" and args.epochs == 3
    assert cli.build_parser().parse_args([]).captions == "./data/BLIP/1st_10min.txt"
    # it parses: the mesh that follows, before anything is read, does not fit a world of one
    with pytest.raises(ValueError, match=r"dp\*sp\*tp = 2 != 1 devices"):
        cli.main(line + ["--dp=2", "--device", "cpu"])


class _MeshReached(Exception):
    pass


@pytest.mark.parametrize("flag", ["--dp=2", "--tp=2", "--sp=2", "--fsdp"])
def test_flags_that_wait_are_refused_by_name(flag, monkeypatch):
    """Each mesh flag of the JAX trainer reaches ``make_mesh`` (in ``main``
    before anything is read, and in ``train``) with JAX's sizes: a mesh of 2
    does not fit a world of one and raises make_mesh's error; ``--fsdp``
    alone asks for a mesh of one (stopped here, so that no process group is
    left behind)."""
    name = flag.split("=")[0].lstrip("-")
    want = {"dp": 2 if name == "dp" else 1, "tp": 2 if name == "tp" else 1,
            "sp": 2 if name == "sp" else 1}
    seen = []
    real = cli.make_mesh

    def spy(**kw):
        seen.append({k: kw[k] for k in want})
        if name == "fsdp":
            raise _MeshReached
        return real(**kw)

    monkeypatch.setattr(cli, "make_mesh", spy)
    err = _MeshReached if name == "fsdp" else ValueError
    match = None if name == "fsdp" else r"dp\*sp\*tp = 2 != 1 devices"
    with pytest.raises(err, match=match):
        cli.main([flag, "--device", "cpu"])
    with pytest.raises(err, match=match):
        cli.train(None, None, None, None, cli.build_parser().parse_args([flag, "--device", "cpu"]))
    assert seen == [want, want]
    assert not torch.distributed.is_initialized()


def test_entry_points_default_to_the_card_and_raise_without_one(unet_params):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        vd.init_video_train_state(port_unet(unet_params))


def test_train_on_the_cpu_writes_checkpoints_and_a_validation_gif(unet_params, tiny_vae, tmp_path):
    """Two epochs of two steps on a micro model through ``cli.train`` with
    ``--device cpu``: losses finite, trainable weights moved, a train-state
    file, the diffusers layout (which loads back) and a validation GIF."""
    jcfg = dataclasses.replace(JCFG, cross_attention_dim=768)
    cfg = dataclasses.replace(CFG, cross_attention_dim=768)
    params = random_params(JUNet(jcfg), 12, np.zeros((1, F, HW, HW, 4), np.float32),
                           jnp.asarray([3]), np.zeros((1, 7, 768), np.float32))
    unet = port_unet(params, cfg)
    loaded = {n: p.detach().clone() for n, p in unet.named_parameters()}
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(vae_state_dict_from_jax(tiny_vae, VAEConfig.tiny()), strict=True)
    rng = np.random.default_rng(13)
    pixels = np.tanh(rand(rng, 4, F, 8 * HW, 8 * HW, 3))
    contexts = rand(rng, 4, 77, 768)
    out = tmp_path / "run"
    args = cli.build_parser().parse_args([
        "--device", "cpu", "--epochs", "2", "--train_batch_size", "2", "--validation_epochs", "2",
        "--validation_steps", "2", "--checkpointing_epochs", "1", "--output_dir", str(out)])
    steps = []
    state, losses = cli.train(unet, vae, pixels, contexts, args, cfg=TCFG,
                              on_step=lambda st, loss: steps.append((st.step, float(loss))))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [s for s, _ in steps] == [1, 2, 3, 4]
    assert sorted(os.listdir(out / "ckpt")) == ["train_state_1.pt", "train_state_2.pt"]
    frames = video.load_gif(str(out / "samples" / "sample-2.gif"))
    assert frames.shape == (F, 8 * HW, 2 * 8 * HW, 3) and frames.std() > 0
    with open(out / "tuneavideo_metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [1.0, 2.0]

    ucfg, sd = ed.load_diffusers_unet(str(out))
    assert ucfg == cfg
    vcfg, vae_sd = ed.load_diffusers_vae(str(out))
    AutoencoderKL(vcfg).load_state_dict(vae_sd, strict=True)
    for name, v in sd.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, loaded[name]) != vd.trainable(name), name

    # resume: the newest file of the directory, into a model built afresh
    args2 = cli.build_parser().parse_args([
        "--device", "cpu", "--epochs", "1", "--train_batch_size", "2", "--validation_epochs", "9",
        "--checkpointing_epochs", "9", "--output_dir", str(tmp_path / "run2"),
        "--unet_ckpt", str(out / "ckpt")])
    state2, _ = cli.train(UNet3DConditionModel(cfg), vae, pixels, contexts, args2, cfg=TCFG)
    assert state2.step == 6


def test_main_reads_clips_inflates_a_2d_unet_and_trains(unet_params, tiny_vae, tmp_path,
                                                        monkeypatch):
    """``main`` end to end on the CPU with the model configs swapped for
    micro ones: clips from mp4 files, caption embeddings from a .pt, the UNet
    inflated from a 2-D state dict, the VAE from a diffusers directory."""
    cv2 = pytest.importorskip("cv2")
    cfg = dataclasses.replace(CFG, cross_attention_dim=768)
    monkeypatch.setattr(cli, "UNet3DConfig", lambda: cfg)
    clips = tmp_path / "clips"
    clips.mkdir()
    rng = np.random.default_rng(14)
    for i in range(2):
        writer = cv2.VideoWriter(str(clips / f"{i + 1}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                                 24, (64, 64))
        if not writer.isOpened():
            pytest.skip("this cv2 build cannot write mp4v video")
        for _ in range(48):
            writer.write(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        writer.release()
    monkeypatch.setattr(cli, "VideoClipDataset",
                        lambda paths, ids: video.VideoClipDataset(paths, ids, width=64, height=64))
    torch.save(tt(rand(rng, 2, 77, 768)), tmp_path / "emb.pt")
    model = UNet3DConditionModel(cfg)
    sd2 = {k: v for k, v in model.state_dict().items() if "_temp." not in k}
    torch.save(sd2, tmp_path / "unet2d.pt")
    ed.save_diffusers_pipeline(str(tmp_path / "sd"), model.state_dict(), cfg,
                               vae_state_dict_from_jax(tiny_vae, VAEConfig.tiny()),
                               VAEConfig.tiny())
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", "--video_dir", str(clips), "--text_embeddings",
                     str(tmp_path / "emb.pt"), "--unet_torch", str(tmp_path / "unet2d.pt"),
                     "--vae", str(tmp_path / "sd"), "--output_dir", str(out), "--epochs", "1",
                     "--train_batch_size", "2", "--validation_epochs", "9"]) == 0
    saved = torch.load(out / "ckpt" / "train_state_1.pt", weights_only=False)
    assert saved["step"] == 1
    for name, v in saved["params"].items():
        if name in sd2:
            assert torch.equal(v, sd2[name]) != vd.trainable(name), name
    with pytest.raises(SystemExit, match="no clips"):
        cli.main(["--device", "cpu", "--video_dir", str(tmp_path / "none"),
                  "--text_embeddings", str(tmp_path / "emb.pt")])


def test_reading_video_needs_cv2_and_says_so(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        video.read_video_frames(str(tmp_path / "x.mp4"))


def test_video_clip_dataset_samples_frames(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24, (64, 48))
    if not writer.isOpened():
        pytest.skip("this cv2 build cannot write MJPG video")
    for i in range(20):
        writer.write(np.full((48, 64, 3), 10 * i, np.uint8))
    writer.release()
    ds = video.VideoClipDataset([path], [5], width=32, height=24, n_sample_frames=3,
                                sample_frame_rate=8)
    item = ds[0]
    assert item["pixel_values"].shape == (3, 24, 32, 3) and item["prompt_ids"] == 5
    assert -1.0 <= item["pixel_values"].min() and item["pixel_values"].max() <= 1.0
    means = item["pixel_values"].mean(axis=(1, 2, 3))
    assert means[0] < means[1] < means[2]  # frames 0, 8, 16
    pixels, ids = ds.load_all()
    assert pixels.shape == (1, 3, 24, 32, 3) and list(ids) == [5]
    with pytest.raises(ValueError, match="decoded 20 frames"):
        video.VideoClipDataset([path], [0], n_sample_frames=6)[0]
