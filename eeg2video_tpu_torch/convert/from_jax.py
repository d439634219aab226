"""JAX parameter trees -> the port's state dicts.

The port's modules carry the diffusers / reference key names, so the
numpy-only exporters in ``convert.export_diffusion`` give the mapping; this
module turns their arrays into tensors. Flax trees arrive as nested dicts of
numpy arrays (``jax.device_get`` of the parameters, or a restored orbax
checkpoint converted by the caller): nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .export_diffusion import VAE_ENCODER_PREFIXES, unet3d_to_torch, vae_to_torch


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
                     if not k.startswith(VAE_ENCODER_PREFIXES)}, dtype)


def semantic_state_dict_from_jax(params, dtype=torch.float32):
    """Flax SemanticPredictor params (``{fcN: {kernel, bias}, out: {...}}``,
    with or without the ``params`` wrapper) -> ``SemanticPredictor`` state
    dict: kernels (I, O) transpose to ``nn.Linear``'s (O, I)."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, leaf in params.items():
        sd[f"{name}.weight"] = np.transpose(np.asarray(leaf["kernel"]))
        sd[f"{name}.bias"] = np.asarray(leaf["bias"])
    return _tensors(sd, dtype)
