"""JAX parameter trees -> the port's state dicts.

The port's modules carry the diffusers / reference key names, so the
numpy-only exporters of the JAX package (``eeg2video_tpu.convert.
export_diffusion.unet3d_to_torch`` :99 and ``vae_to_torch`` :155, which
import no jax) give the mapping; this module turns their arrays into
tensors. Flax trees may be nested dicts of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from eeg2video_tpu.convert.export_diffusion import unet3d_to_torch, vae_to_torch

# keys of the VAE's encoding half, which the port does not have yet
_VAE_ENCODER_PREFIXES = ("encoder.", "quant_conv.")


def _tensors(sd, dtype):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dtype)
            for k, v in sd.items()}


def unet_state_dict_from_jax(params, config, dtype=torch.float32):
    """Flax UNet3DConditionModel params -> ``UNet3DConditionModel`` state dict."""
    sd = unet3d_to_torch(params, n_down=len(config.block_out_channels),
                         layers_per_block=config.layers_per_block)
    return _tensors(sd, dtype)


def vae_state_dict_from_jax(params, config, dtype=torch.float32):
    """Flax AutoencoderKL params -> ``AutoencoderKL`` (decoder) state dict;
    the encoder's keys are dropped."""
    sd = vae_to_torch(params, n_blocks=len(config.block_out_channels),
                      enc_layers=config.layers_per_block)
    return _tensors({k: v for k, v in sd.items()
                     if not k.startswith(_VAE_ENCODER_PREFIXES)}, dtype)
