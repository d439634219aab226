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


def clip_text_state_dict_from_jax(params, layers=12, dtype=torch.float32):
    """Flax CLIPTextModel params (numpy, with or without the ``params``
    wrapper) -> ``models.clip_text.CLIPTextModel`` state dict, in the keys of
    ``transformers.CLIPTextModel``: Dense kernels (I, O) transpose to
    ``nn.Linear``'s (O, I), LayerNorm ``scale`` becomes ``weight``. The inverse
    of the JAX package's ``clip_text_params_from_torch`` (clip_text.py:88)."""
    if "params" in params:
        params = params["params"]
    sd = {}

    def dense(key, leaf):
        sd[f"{key}.weight"] = np.transpose(np.asarray(leaf["kernel"]))
        sd[f"{key}.bias"] = np.asarray(leaf["bias"])

    def ln(key, leaf):
        sd[f"{key}.weight"] = np.asarray(leaf["scale"])
        sd[f"{key}.bias"] = np.asarray(leaf["bias"])

    emb = "text_model.embeddings"
    sd[f"{emb}.token_embedding.weight"] = np.asarray(params["token_embedding"]["embedding"])
    sd[f"{emb}.position_embedding.weight"] = np.asarray(params["position_embedding"]["embedding"])
    for i in range(layers):
        p = f"text_model.encoder.layers.{i}"
        ln(f"{p}.layer_norm1", params[f"l{i}_ln1"])
        ln(f"{p}.layer_norm2", params[f"l{i}_ln2"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{p}.self_attn.{name}", params[f"l{i}_attn"][name])
        dense(f"{p}.mlp.fc1", params[f"l{i}_fc1"])
        dense(f"{p}.mlp.fc2", params[f"l{i}_fc2"])
    ln("text_model.final_layer_norm", params["final_ln"])
    return _tensors(sd, dtype)
