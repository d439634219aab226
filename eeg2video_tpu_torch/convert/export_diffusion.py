"""Flax parameter trees -> the diffusers key space, and diffusers directories
-> the port's configs and state dicts. numpy and torch only.

The port's own copy of what it needs from the JAX package's
``eeg2video_tpu/convert/export_diffusion.py`` (the port imports nothing of
that package):

- ``unet3d_to_torch`` / ``vae_to_torch``: Flax param trees (nested dicts of
  arrays) -> the diffusers-0.11.1 torch key space, which is the key space of
  the port's ``UNet3DConditionModel`` and ``AutoencoderKL``. Layout rules:
  conv (kh, kw, I, O) -> (O, I, kh, kw), dense (I, O) -> (O, I).
- ``load_diffusers_unet`` / ``load_diffusers_vae``: a ``save_pretrained``
  sub-folder (``config.json`` + ``diffusion_pytorch_model.bin``) -> the
  port's config and a state dict of tensors, for ``cli.inference_eeg2video.
  load_pipeline``.
- ``save_diffusers_pipeline``: the ``pipeline.save_pretrained(output_dir)``
  layout the reference fine-tune emits
  (train_finetune_videodiffusion.py:376-382) from the port's state dicts,
  which are in that key space already.
- ``unet3d_from_torch_2d``: the reference's ``from_pretrained_2d`` inflation
  (models/unet.py:415-449) in the port's key space.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

WEIGHTS_NAME = "diffusion_pytorch_model.bin"


def _t(x):
    return np.asarray(x)


def _conv(sd, p, tree):
    sd[f"{p}.weight"] = np.transpose(_t(tree["kernel"]), (3, 2, 0, 1))
    if "bias" in tree:
        sd[f"{p}.bias"] = _t(tree["bias"])


def _pconv(sd, p, tree):
    # the JAX PseudoConv3d wraps an nn.Conv named "conv"
    _conv(sd, p, tree["conv"])


def _dense(sd, p, tree):
    sd[f"{p}.weight"] = np.transpose(_t(tree["kernel"]))
    if "bias" in tree:
        sd[f"{p}.bias"] = _t(tree["bias"])


def _norm(sd, p, tree):
    sd[f"{p}.weight"] = _t(tree["scale"])
    sd[f"{p}.bias"] = _t(tree["bias"])


def _resnet3d(sd, p, tree):
    _norm(sd, f"{p}.norm1", tree["norm1"])
    _pconv(sd, f"{p}.conv1", tree["conv1"])
    _dense(sd, f"{p}.time_emb_proj", tree["time_emb_proj"])
    _norm(sd, f"{p}.norm2", tree["norm2"])
    _pconv(sd, f"{p}.conv2", tree["conv2"])
    if "conv_shortcut" in tree:
        _pconv(sd, f"{p}.conv_shortcut", tree["conv_shortcut"])


def _attention(sd, p, tree):
    # CrossAttention / SparseCausalAttention: to_q/k/v no-bias, to_out.0
    # (reference attention.py:151-201; diffusers CrossAttention keyspace)
    _dense(sd, f"{p}.to_q", tree["to_q"])
    _dense(sd, f"{p}.to_k", tree["to_k"])
    _dense(sd, f"{p}.to_v", tree["to_v"])
    _dense(sd, f"{p}.to_out.0", tree["to_out"])


def _transformer3d(sd, p, tree):
    _norm(sd, f"{p}.norm", tree["norm"])
    _conv(sd, f"{p}.proj_in", tree["proj_in"])
    _conv(sd, f"{p}.proj_out", tree["proj_out"])
    i = 0
    while f"block{i}" in tree:
        b, tb = tree[f"block{i}"], f"{p}.transformer_blocks.{i}"
        _attention(sd, f"{tb}.attn1", b["attn1"])
        _norm(sd, f"{tb}.norm1", b["norm1"])
        _attention(sd, f"{tb}.attn2", b["attn2"])
        _norm(sd, f"{tb}.norm2", b["norm2"])
        _dense(sd, f"{tb}.ff.net.0.proj", b["ff"]["proj"])
        _dense(sd, f"{tb}.ff.net.2", b["ff"]["out"])
        _norm(sd, f"{tb}.norm3", b["norm3"])
        _attention(sd, f"{tb}.attn_temp", b["attn_temp"])
        _norm(sd, f"{tb}.norm_temp", b["norm_temp"])
        i += 1


def unet3d_to_torch(params, n_down=4, layers_per_block=2) -> Dict[str, np.ndarray]:
    """Flax UNet3DConditionModel params -> reference 3-D state dict (the key
    space ``pipeline.save_pretrained`` writes for the fine-tuned UNet,
    unet.py:80-207)."""
    if "params" in params and "conv_in" in params["params"]:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}
    _pconv(sd, "conv_in", params["conv_in"])
    _dense(sd, "time_embedding.linear_1", params["time_embed_1"])
    _dense(sd, "time_embedding.linear_2", params["time_embed_2"])
    _norm(sd, "conv_norm_out", params["conv_norm_out"])
    _pconv(sd, "conv_out", params["conv_out"])

    for i in range(n_down):
        blk, t = params[f"down{i}"], f"down_blocks.{i}"
        for j in range(layers_per_block):
            _resnet3d(sd, f"{t}.resnets.{j}", blk[f"resnet{j}"])
            if f"attn{j}" in blk:
                _transformer3d(sd, f"{t}.attentions.{j}", blk[f"attn{j}"])
        if "downsample" in blk:
            _pconv(sd, f"{t}.downsamplers.0.conv", blk["downsample"]["conv"])

    _resnet3d(sd, "mid_block.resnets.0", params["mid"]["resnet0"])
    _resnet3d(sd, "mid_block.resnets.1", params["mid"]["resnet1"])
    _transformer3d(sd, "mid_block.attentions.0", params["mid"]["attn0"])

    for i in range(n_down):
        blk, t = params[f"up{i}"], f"up_blocks.{i}"
        for j in range(layers_per_block + 1):
            _resnet3d(sd, f"{t}.resnets.{j}", blk[f"resnet{j}"])
            if f"attn{j}" in blk:
                _transformer3d(sd, f"{t}.attentions.{j}", blk[f"attn{j}"])
        if "upsample" in blk:
            _pconv(sd, f"{t}.upsamplers.0.conv", blk["upsample"]["conv"])
    return sd


# --- VAE ---------------------------------------------------------------------

def _vae_resnet(sd, p, tree):
    _norm(sd, f"{p}.norm1", tree["norm1"])
    _conv(sd, f"{p}.conv1", tree["conv1"])
    _norm(sd, f"{p}.norm2", tree["norm2"])
    _conv(sd, f"{p}.conv2", tree["conv2"])
    if "conv_shortcut" in tree:
        _conv(sd, f"{p}.conv_shortcut", tree["conv_shortcut"])


def _vae_attn(sd, p, tree):
    _norm(sd, f"{p}.group_norm", tree["group_norm"])
    _dense(sd, f"{p}.query", tree["query"])
    _dense(sd, f"{p}.key", tree["key"])
    _dense(sd, f"{p}.value", tree["value"])
    _dense(sd, f"{p}.proj_attn", tree["proj_attn"])


def vae_to_torch(params, n_blocks=4, enc_layers=2) -> Dict[str, np.ndarray]:
    """Flax AutoencoderKL params -> diffusers-0.11.1 AutoencoderKL state
    dict."""
    if "params" in params and "encoder" in params["params"]:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for i in range(n_blocks):
        for j in range(enc_layers):
            _vae_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down{i}_res{j}"])
        if f"down{i}_downsample" in enc:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", enc[f"down{i}_downsample"])
    _vae_resnet(sd, "encoder.mid_block.resnets.0", enc["mid_res0"])
    _vae_attn(sd, "encoder.mid_block.attentions.0", enc["mid_attn"])
    _vae_resnet(sd, "encoder.mid_block.resnets.1", enc["mid_res1"])
    _norm(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])

    dec = params["decoder"]
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_resnet(sd, "decoder.mid_block.resnets.0", dec["mid_res0"])
    _vae_attn(sd, "decoder.mid_block.attentions.0", dec["mid_attn"])
    _vae_resnet(sd, "decoder.mid_block.resnets.1", dec["mid_res1"])
    for i in range(n_blocks):
        for j in range(enc_layers + 1):
            _vae_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up{i}_res{j}"])
        if f"up{i}_upsample" in dec:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dec[f"up{i}_upsample"])
    _norm(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


# --- reading a diffusers directory -------------------------------------------

def load_torch_state_dict(path):
    """A torch checkpoint file -> ``{name: tensor}`` on the CPU. Unwraps the
    ``{'state_dict': ...}`` wrapper the reference uses (eeg_text.py:175) and a
    whole pickled module."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        obj = obj.state_dict()
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def _component_dir(path, name):
    return path if os.path.exists(os.path.join(path, "config.json")) \
        else os.path.join(path, name)


def load_diffusers_unet(path):
    """Read ``<path>/unet/{config.json,diffusion_pytorch_model.bin}`` (or
    ``path`` itself as the sub-folder) -> (UNet3DConfig, state dict). Takes
    the JAX package's exported directories and the reference's
    ``save_pretrained`` output alike."""
    from ..models.unet3d import UNet3DConfig

    sub = _component_dir(path, "unet")
    with open(os.path.join(sub, "config.json")) as f:
        c = json.load(f)
    cfg = UNet3DConfig(
        in_channels=c.get("in_channels", 4),
        out_channels=c.get("out_channels", 4),
        block_out_channels=tuple(c["block_out_channels"]),
        layers_per_block=c.get("layers_per_block", 2),
        attention_heads=c.get("attention_head_dim", 8),
        cross_attention_dim=c.get("cross_attention_dim", 768),
        norm_num_groups=c.get("norm_num_groups", 32),
        norm_eps=c.get("norm_eps", 1e-5),
        freq_shift=c.get("freq_shift", 0),
        flip_sin_to_cos=c.get("flip_sin_to_cos", True),
    )
    return cfg, load_torch_state_dict(os.path.join(sub, WEIGHTS_NAME))


def load_diffusers_vae(path):
    """Read a ``vae/`` sub-folder (or ``path`` itself) -> (VAEConfig, state
    dict, the encoder's keys included)."""
    from ..models.vae import VAEConfig

    sub = _component_dir(path, "vae")
    with open(os.path.join(sub, "config.json")) as f:
        c = json.load(f)
    cfg = VAEConfig(
        block_out_channels=tuple(c["block_out_channels"]),
        layers_per_block=c.get("layers_per_block", 2),
        latent_channels=c.get("latent_channels", 4),
        norm_num_groups=c.get("norm_num_groups", 32),
        sample_channels=c.get("in_channels", 3),
    )
    return cfg, load_torch_state_dict(os.path.join(sub, WEIGHTS_NAME))


# --- writing a diffusers directory ---------------------------------------------

_DIFFUSERS_VERSION = "0.11.1"


def unet_config_dict(cfg, sample_size=None) -> dict:
    """diffusers ``unet/config.json`` for a UNet3DConfig; keys follow the
    reference ``__init__`` signature (unet.py:40-78). ``attention_head_dim``
    is the head count in diffusers 0.11.1."""
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "UNet3DConditionModel",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "act_fn": "silu",
        "attention_head_dim": cfg.attention_heads,
        "block_out_channels": list(cfg.block_out_channels),
        "center_input_sample": False,
        "cross_attention_dim": cfg.cross_attention_dim,
        "down_block_types": ["CrossAttnDownBlock3D"] * (n - 1) + ["DownBlock3D"],
        "downsample_padding": 1,
        "dual_cross_attention": False,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "freq_shift": cfg.freq_shift,
        "in_channels": cfg.in_channels,
        "layers_per_block": cfg.layers_per_block,
        "mid_block_scale_factor": 1,
        "mid_block_type": "UNetMidBlock3DCrossAttn",
        "norm_eps": cfg.norm_eps,
        "norm_num_groups": cfg.norm_num_groups,
        "num_class_embeds": None,
        "only_cross_attention": False,
        "out_channels": cfg.out_channels,
        "sample_size": sample_size,
        "up_block_types": ["UpBlock3D"] + ["CrossAttnUpBlock3D"] * (n - 1),
        "use_linear_projection": False,
    }


def vae_config_dict(cfg, sample_size: int = 512) -> dict:
    """diffusers ``vae/config.json`` for a VAEConfig (AutoencoderKL schema)."""
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "act_fn": "silu",
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "in_channels": cfg.sample_channels,
        "latent_channels": cfg.latent_channels,
        "layers_per_block": cfg.layers_per_block,
        "norm_num_groups": cfg.norm_num_groups,
        "out_channels": cfg.sample_channels,
        "sample_size": sample_size,
        "up_block_types": ["UpDecoderBlock2D"] * n,
    }


def scheduler_config_dict() -> dict:
    """``scheduler/scheduler_config.json`` with the SD-1.4 schedule the
    reference trains and samples with
    (train_finetune_videodiffusion.py:132, 222-228)."""
    return {
        "_class_name": "DDIMScheduler",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "beta_end": 0.012,
        "beta_schedule": "scaled_linear",
        "beta_start": 0.00085,
        "clip_sample": False,
        "num_train_timesteps": 1000,
        "prediction_type": "epsilon",
        "set_alpha_to_one": False,
        "steps_offset": 1,
    }


def _save_component(out_dir, name, config, sd):
    import torch

    sub = os.path.join(out_dir, name)
    os.makedirs(sub, exist_ok=True)
    with open(os.path.join(sub, "config.json"), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)
    torch.save({k: torch.as_tensor(v).detach().float().cpu().contiguous()
                for k, v in sd.items()}, os.path.join(sub, WEIGHTS_NAME))


def save_diffusers_pipeline(out_dir, unet_sd, unet_cfg, vae_sd=None, vae_cfg=None,
                            sample_size=None):
    """Write the reference fine-tune's checkpoint directory:
    ``model_index.json`` + ``unet/`` (+ ``vae/`` when given) + ``scheduler/``,
    weights in f32. ``unet_sd`` / ``vae_sd`` are state dicts of the port's
    modules. The reference inference reloads only the ``unet`` sub-folder
    from it (inference_eeg2video.py:50); the CLIP components are named by the
    index only."""
    os.makedirs(out_dir, exist_ok=True)
    index = {
        "_class_name": "TuneAVideoPipeline",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "scheduler": ["diffusers", "DDIMScheduler"],
        "text_encoder": ["transformers", "CLIPTextModel"],
        "tokenizer": ["transformers", "CLIPTokenizer"],
        "unet": ["models.unet", "UNet3DConditionModel"],
        "vae": ["diffusers", "AutoencoderKL"],
    }
    with open(os.path.join(out_dir, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)
    _save_component(out_dir, "unet", unet_config_dict(unet_cfg, sample_size), unet_sd)
    if vae_sd is not None:
        _save_component(out_dir, "vae", vae_config_dict(vae_cfg), vae_sd)
    sub = os.path.join(out_dir, "scheduler")
    os.makedirs(sub, exist_ok=True)
    with open(os.path.join(sub, "scheduler_config.json"), "w") as f:
        json.dump(scheduler_config_dict(), f, indent=2, sort_keys=True)


# --- inflating a 2-D checkpoint ---------------------------------------------------

def unet3d_from_torch_2d(sd_2d, model, generator=None):
    """diffusers UNet2DConditionModel state dict -> state dict of ``model``
    (a ``UNet3DConditionModel``): every 2-D weight lands on the key of the
    same name, and what a 2-D checkpoint lacks (``attn_temp``, ``norm_temp``)
    gets the initial values the JAX package's
    ``unet3d_params_from_torch_2d`` takes from a fresh Flax init: LayerNorm
    scale 1 and bias 0, ``to_q/k/v`` lecun-normal (N(0, 1/fan_in) truncated
    at two standard deviations, drawn here from ``generator``), ``to_out``
    zero, so that the inflated model reproduces the 2-D UNet on each frame."""
    import torch

    out = {}
    for name, p in model.state_dict().items():
        if name in sd_2d:
            w = torch.as_tensor(sd_2d[name]).float()
            if w.shape != p.shape:
                raise ValueError(f"{name}: checkpoint {tuple(w.shape)} != model {tuple(p.shape)}")
        elif ".attn_temp." not in name and ".norm_temp." not in name:
            raise KeyError(f"the 2-D checkpoint lacks {name}")
        elif ".norm_temp." in name:
            w = torch.ones(p.shape) if name.endswith("weight") else torch.zeros(p.shape)
        elif ".to_out." in name:
            w = torch.zeros(p.shape)
        else:
            # flax lecun_normal: stddev sqrt(1/fan_in) of the untruncated
            # normal, corrected for the truncation at +-2 sigma
            w = torch.empty(p.shape)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w *= (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
        out[name] = w
    return out
