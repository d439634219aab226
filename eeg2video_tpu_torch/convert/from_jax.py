"""JAX parameter trees -> the port's state dicts.

The port's modules carry the diffusers / reference key names, so the
numpy-only exporters in ``convert.export_diffusion`` and
``convert.export_torch`` give the mapping; this
module turns their arrays into tensors. Flax trees arrive as nested dicts of
numpy arrays (``jax.device_get`` of the parameters, or a restored orbax
checkpoint converted by the caller): nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .export_diffusion import unet3d_to_torch, vae_to_torch
from .export_torch import encoder_to_torch, seq2seq_to_torch


def _tensors(sd, dtype):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dtype)
            for k, v in sd.items()}


def unet_state_dict_from_jax(params, config, dtype=torch.float32):
    """Flax UNet3DConditionModel params -> ``UNet3DConditionModel`` state dict.

    The mapping is a relabelling plus transposes, so it carries a gradient
    tree (``jax.grad`` of a loss with respect to the params) into the port's
    key space exactly as it carries weights: ``grads_state_dict_from_jax``."""
    sd = unet3d_to_torch(params, n_down=len(config.block_out_channels),
                         layers_per_block=config.layers_per_block)
    return _tensors(sd, dtype)


grads_state_dict_from_jax = unet_state_dict_from_jax


def vae_state_dict_from_jax(params, config, dtype=torch.float32):
    """Flax AutoencoderKL params -> ``AutoencoderKL`` state dict (encoder,
    decoder and both quant convs)."""
    return _tensors(vae_to_torch(params, n_blocks=len(config.block_out_channels),
                                 enc_layers=config.layers_per_block), dtype)


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


def _with_int_counts(sd):
    """numpy state dict -> tensors: float32, integers (``num_batches_tracked``)
    int64."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if v.dtype.kind == "i"
                                         else np.float32))
            for k, v in sd.items()}


def encoder_state_dict_from_jax(name: str, variables):
    """Flax EEG-encoder variables (``params`` and, for the encoders with
    BatchNorms, ``batch_stats``; numpy arrays) -> the state dict of
    ``models.make_encoder(name, ...)`` in the reference's keys (the ones
    ``eeg2video_tpu/convert/torch_params.py`` ``encoder_params_from_torch``
    reads), float32, ``num_batches_tracked`` 0."""
    return _with_int_counts(encoder_to_torch(name, variables))


def seq2seq_state_dict_from_jax(variables):
    """Flax Seq2SeqTransformer variables (``params`` and ``batch_stats``: the
    EEGNet embedding's BatchNorm running statistics) -> ``Seq2SeqTransformer``
    state dict in the reference's keys, float32 (``num_batches_tracked`` stays
    an integer)."""
    return _with_int_counts(seq2seq_to_torch(variables))
