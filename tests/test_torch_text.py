"""The port's text path (eeg2video_tpu_torch) against the JAX package, on the
CPU: DDIM's ``inverse_step``, the CLIP text tower, ``TextToVideoPipeline``,
``ddim_inversion`` and the ``generate_text_emb`` CLI.

Inputs and weights are made with numpy from a seed and carried into the port
(``convert.from_jax.clip_text_state_dict_from_jax`` for CLIP). Tolerances, as
in tests/test_torch_models.py: 2e-5 for single blocks and the scheduler step,
rtol 1e-3 / atol 1e-4 for whole models. A tokenizer stand-in maps words to ids
with a stable function (crc32), so files written in one process compare in
another.
"""

import dataclasses
import functools
import sys
import types
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg2video_tpu.cli import generate_text_emb as jgen
from eeg2video_tpu.diffusion.pipeline import EEG2VideoPipeline as JPipeline
from eeg2video_tpu.diffusion.schedulers import DDIMSchedule as JDDIM
from eeg2video_tpu.diffusion.text_pipeline import (TextToVideoPipeline as JTextPipeline,
                                                   ddim_inversion as jddim_inversion)
from eeg2video_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                            CLIPTextModel as JCLIP)
from eeg2video_tpu.models.unet3d import (UNet3DConditionModel as JUNet,
                                         UNet3DConfig as JUNetConfig)
from eeg2video_tpu.models.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from eeg2video_tpu_torch.cli import generate_text_emb as gen
from eeg2video_tpu_torch.convert.from_jax import (clip_text_state_dict_from_jax,
                                                  unet_state_dict_from_jax,
                                                  vae_state_dict_from_jax)
from eeg2video_tpu_torch.data.io import load_array
from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
from eeg2video_tpu_torch.diffusion.schedulers import DDIMSchedule
from eeg2video_tpu_torch.diffusion.text_pipeline import TextToVideoPipeline, ddim_inversion
from eeg2video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, encode_ids
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import VAEConfig
from test_torch_models import capped_threads, rand, random_params

BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)

_threads = capped_threads()


class HashTokenizer:
    """CLIPTokenizer stand-in: bos, one id a word (crc32 of the word), eos,
    then eos as padding to ``max_length``; ids below ``vocab_size``."""

    def __init__(self, vocab_size):
        self.bos, self.eos = vocab_size - 2, vocab_size - 1

    def __call__(self, prompts, max_length=77, padding=None, truncation=None,
                 return_tensors=None):
        ids = np.full((len(prompts), max_length), self.eos, np.int64)
        for i, p in enumerate(prompts):
            toks = [self.bos] + [zlib.crc32(w.encode()) % self.bos for w in p.split()]
            toks = (toks + [self.eos])[:max_length]
            ids[i, :len(toks)] = toks
        return types.SimpleNamespace(input_ids=ids)


def _port_config(jcfg, cls):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _clip_params(jcfg, seed):
    return random_params(JCLIP(jcfg), seed, np.zeros((1, 77), np.int32))


def _port_clip(params, jcfg):
    model = CLIPTextModel(_port_config(jcfg, CLIPTextConfig))
    model.load_state_dict(clip_text_state_dict_from_jax(params, jcfg.layers), strict=True)
    return model.eval()


# --- DDIM inverse step -------------------------------------------------------------

def test_inverse_step_matches_jax_on_every_timestep_and_undoes_step():
    """Every t of a 50-step grid, the first (t = 1, whose start is
    final_alpha_cumprod) included: against JAX's inverse_step within 2e-5, and
    inverse_step(eps, t, step(eps, t, x)) == x within 2e-5 (f32 rounding)."""
    rng = np.random.default_rng(0)
    eps, x = rand(rng, 2, 3, 4, 5, 4), rand(rng, 2, 3, 4, 5, 4)
    sched, jsched = DDIMSchedule.create(50), JDDIM.create(50)
    assert sorted(sched.timesteps)[0] - 20 < 0
    for t in sched.timesteps:
        got = sched.inverse_step(torch.from_numpy(eps), t, torch.from_numpy(x))
        want = np.asarray(jsched.inverse_step(jnp.asarray(eps), jnp.int32(t), jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)
        back = sched.inverse_step(torch.from_numpy(eps), t,
                                  sched.step(torch.from_numpy(eps), t, torch.from_numpy(x)))
        np.testing.assert_allclose(back.numpy(), x, **BLOCK_TOL)


# --- CLIP text tower ---------------------------------------------------------------

# the tiny config, and one layer at full width (768 wide, 12 heads, 3072)
CLIP_CASES = {"tiny": JCLIPConfig.tiny(), "full_width_layer": JCLIPConfig(layers=1)}


@pytest.mark.parametrize("case", list(CLIP_CASES))
@pytest.mark.parametrize("padded", [True, False])
def test_clip_matches_jax(case, padded):
    """Ids padded with eos after a few words (the tokenizer's output), or 77
    word ids with no padding; no padding mask on either side."""
    jcfg = CLIP_CASES[case]
    params = _clip_params(jcfg, 1)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, jcfg.vocab_size, (3, 77))
    if padded:
        ids[:, 9:] = jcfg.vocab_size - 1
    want = np.asarray(jax.jit(JCLIP(jcfg).apply)({"params": params}, jnp.asarray(ids)))
    got = encode_ids(_port_clip(params, jcfg), ids)
    assert got.shape == (3, 77, jcfg.hidden) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **(BLOCK_TOL if case == "full_width_layer"
                                                     else MODEL_TOL))


def test_clip_loads_a_transformers_state_dict_strictly():
    """A transformers CLIPTextModel's state dict loads with strict=True, no
    converter; so does one that also holds the fixed ``position_ids`` (older
    files); the last hidden state is transformers' within the model tolerance."""
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel as HFModel

    hf_cfg = HFConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=77, hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf = HFModel(hf_cfg).eval()
    ids = np.random.default_rng(3).integers(0, 100, (2, 77))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).last_hidden_state.numpy()
    sd = hf.state_dict()
    for extra in ({}, {"text_model.embeddings.position_ids": torch.arange(77)[None]}):
        model = CLIPTextModel(CLIPTextConfig.tiny())
        model.load_state_dict({**sd, **extra}, strict=True)
        np.testing.assert_allclose(encode_ids(model.eval(), ids).numpy(), want, **MODEL_TOL)


# --- TextToVideoPipeline and ddim_inversion ------------------------------------------

# a narrow text tower that still gives the pipeline's 768-wide context
TEXT_CFG = JCLIPConfig(vocab_size=1000, hidden=768, layers=1, heads=12, intermediate=64)


def test_text_pipeline_matches_jax():
    """encode_prompts (ids padded to 77, truncated) and a 2-step call on a tiny
    UNet and VAE, against JAX's TextToVideoPipeline with the same weights and
    initial latents (JAX's key= draws are not used: latents are given)."""
    jcfg = dataclasses.replace(JUNetConfig.tiny(), cross_attention_dim=768)
    uparams = random_params(JUNet(jcfg), 10, np.zeros((1, 2, 4, 4, 4), np.float32),
                            jnp.asarray([3]), np.zeros((1, 7, 768), np.float32))
    vparams = random_params(JVAE(JVAEConfig.tiny()), 8, np.zeros((1, 16, 16, 3), np.float32))
    tparams = _clip_params(TEXT_CFG, 4)
    tok = HashTokenizer(TEXT_CFG.vocab_size)
    long_prompt = " ".join(f"w{i}" for i in range(90))  # truncated at 77 ids
    prompts = ["a cat is sleeping on the sofa", long_prompt]

    jpipe = JTextPipeline.create(JPipeline.create(uparams, vparams, jcfg, JVAEConfig.tiny(),
                                                  dtype=jnp.float32),
                                 {"params": tparams}, tok, TEXT_CFG)
    cfg = _port_config(jcfg, UNet3DConfig)
    base = EEG2VideoPipeline.create(unet_state_dict_from_jax(uparams, cfg),
                                    vae_state_dict_from_jax(vparams, VAEConfig.tiny()), cfg,
                                    VAEConfig.tiny(), dtype=torch.float32, device="cpu")
    pipe = TextToVideoPipeline.create(base, clip_text_state_dict_from_jax(tparams, 1), tok,
                                      _port_config(TEXT_CFG, CLIPTextConfig))

    emb = pipe.encode_prompts(prompts)
    assert emb.shape == (2, 77, 768)
    np.testing.assert_allclose(emb.numpy(), jpipe.encode_prompts(prompts), **MODEL_TOL)
    lat = rand(np.random.default_rng(5), 2, 2, 4, 4, 4)
    kw = dict(latents=lat, video_length=2, height=32, width=32, num_inference_steps=2,
              guidance_scale=12.5)
    want = np.asarray(jpipe(prompts, key=jax.random.key(0), **kw))
    got = pipe(prompts, generator=torch.Generator().manual_seed(0), **kw)
    assert got.shape == (2, 2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_ddim_inversion_matches_jax():
    """Three inverse steps of the micro UNet (every block class) in f32 on
    (1, 3, 8, 8, 4) latents and a 7-token context, against JAX's jitted scan."""
    jcfg = JUNetConfig.micro()
    rng = np.random.default_rng(6)
    lat, ctx = rand(rng, 1, 3, 8, 8, 4), rand(rng, 1, 7, jcfg.cross_attention_dim)
    params = random_params(JUNet(jcfg), 7, lat, jnp.asarray([3]), ctx)
    want = np.asarray(jddim_inversion(JUNet(jcfg), jnp.float32, params, jnp.asarray(lat),
                                      jnp.asarray(ctx), num_inv_steps=3))
    cfg = _port_config(jcfg, UNet3DConfig)
    unet = UNet3DConditionModel(cfg)
    unet.load_state_dict(unet_state_dict_from_jax(params, cfg), strict=True)
    got = ddim_inversion(unet.eval(), lat, ctx, num_inv_steps=3)
    assert got.dtype == torch.float32 and got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


# --- the generate_text_emb CLI ------------------------------------------------------

def test_generate_text_emb_matches_jax(tmp_path, monkeypatch):
    """Both CLIs' main on the same caption files and the same state-dict file:
    the tiny config patched into both namespaces (and the converter's layers
    into JAX's), the tokenizer stand-in in place of transformers'
    CLIPTokenizer. block{i}.pt and negative.npy (float16: one step of its
    rounding is at most 2^-11 relative, inside rtol) within the model
    tolerance of JAX's."""
    jcfg = JCLIPConfig.tiny()
    params = _clip_params(jcfg, 9)
    torch.save(clip_text_state_dict_from_jax(params, jcfg.layers), tmp_path / "clip.pt")
    caps = tmp_path / "BLIP"
    caps.mkdir()
    (caps / "1st_10min.txt").write_text("a dog runs\n\nthe sea at night\n")
    (caps / "2nd_10min.txt").write_text("a red car\n")

    fake = types.ModuleType("transformers")
    fake.CLIPTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path: HashTokenizer(jcfg.vocab_size))
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.setattr(jgen, "CLIPTextConfig", JCLIPConfig.tiny)
    monkeypatch.setattr(jgen, "clip_text_params_from_torch",
                        functools.partial(jgen.clip_text_params_from_torch, layers=jcfg.layers))
    monkeypatch.setattr(jgen, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(gen, "CLIPTextConfig", CLIPTextConfig.tiny)

    common = ["--captions_dir", str(caps), "--torch_clip", str(tmp_path / "clip.pt"),
              "--tokenizer", "unused"]
    jgen.main(common + ["--out_dir", str(tmp_path / "j"),
                        "--negative_out", str(tmp_path / "j" / "negative.npy")])
    written = gen.main(common + ["--out_dir", str(tmp_path / "p"), "--device", "cpu",
                                 "--negative_out", str(tmp_path / "p" / "negative.npy")])
    assert [p.rsplit("/", 1)[-1] for p in written] == ["block0.pt", "block1.pt"]
    for i, rows in ((0, 2), (1, 1)):
        got, want = (load_array(tmp_path / d / f"block{i}.pt") for d in ("p", "j"))
        assert got.shape == (rows, 77, jcfg.hidden) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **MODEL_TOL)
    got, want = (np.load(tmp_path / d / "negative.npy") for d in ("p", "j"))
    assert got.shape == (1, 77, jcfg.hidden) and got.dtype == np.float16 == want.dtype
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), **MODEL_TOL)


def test_generate_text_emb_refuses_the_card_where_there_is_none(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        gen.main(["--torch_clip", str(tmp_path / "none.pt"), "--tokenizer", "x"])
