"""Pipeline loading for the generation entry points.

Counterpart of ``load_pipeline`` in ``eeg2video_tpu/cli/inference_eeg2video.py``
(:35-70). The one-shot generation script there (``main``) is not ported yet;
``cli.serve`` is the port's entry point.
"""

import os

import torch

from ..convert.export_diffusion import (VAE_ENCODER_PREFIXES, load_diffusers_unet,
                                        load_diffusers_vae, load_torch_state_dict)
from ..diffusion.pipeline import EEG2VideoPipeline
from ..models.unet3d import UNet3DConfig
from ..models.vae import VAEConfig
from ..utils import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _is_diffusers_dir(path, sub):
    return (os.path.exists(os.path.join(path, sub, "config.json"))
            or os.path.exists(os.path.join(path, "config.json")))


def _load_component(path, sub, default_config, load_dir):
    """(config, state dict) of one model: a diffusers ``save_pretrained``
    directory (read from its torch ``.bin``, by sub-folder as the reference's
    inference does), or a torch file holding a state dict in the port's key
    space at the default config."""
    if os.path.isdir(path):
        if _is_diffusers_dir(path, sub):
            return load_dir(path)
        raise ValueError(
            f"{path} is a directory without a diffusers config.json (an orbax "
            "checkpoint of the JAX package?): the port reads diffusers "
            "directories and torch state-dict files; carry a JAX tree across "
            "with eeg2video_tpu_torch/convert/from_jax.py and torch.save the result")
    if os.path.isfile(path):
        return default_config, load_torch_state_dict(path)
    raise FileNotFoundError(f"{sub} checkpoint not found: {path}")


def load_pipeline(unet_dir, vae_ckpt, dtype="bfloat16", device="cuda"):
    """Build the pipeline on ``device`` (the card unless the caller names the
    CPU) from checkpoints. Each of ``unet_dir`` and ``vae_ckpt`` may be a
    diffusers directory (the reference fine-tune's output,
    train_finetune_videodiffusion.py:376-382, or the JAX package's export) or
    a ``.pt`` state dict written from the port's own modules."""
    device = resolve_device(device)  # fail before reading anything
    ucfg, unet_sd = _load_component(unet_dir, "unet", UNet3DConfig(), load_diffusers_unet)
    vcfg, vae_sd = _load_component(vae_ckpt, "vae", VAEConfig(), load_diffusers_vae)
    # the port has the decoding half only
    vae_sd = {k: v for k, v in vae_sd.items() if not k.startswith(VAE_ENCODER_PREFIXES)}
    return EEG2VideoPipeline.create(unet_sd, vae_sd, ucfg, vcfg,
                                    dtype=_DTYPES.get(dtype, dtype), device=device)
