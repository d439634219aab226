"""AutoencoderKL decoder (Stable-Diffusion VAE), channels-last, plain PyTorch.

Counterpart of ``eeg2video_tpu/models/vae.py``: ``post_quant_conv`` and the
decoder. The encoder is not ported yet, so ``vae_state_dict_from_jax``
leaves out its keys. All convs run on cuDNN, as the JAX package leaves the
VAE to XLA. Latents (N, h, w, 4) -> images (N, 8h, 8w, 3) in about [-1, 1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import conv2d_nhwc, group_norm

SD_VAE_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    sample_channels: int = 3

    @classmethod
    def tiny(cls):
        return cls(block_out_channels=(32, 32, 64, 64), layers_per_block=1,
                   norm_num_groups=8)


def _gn_silu(x, norm, groups):
    return F.silu(group_norm(x, groups, norm.weight, norm.bias, 1e-6))


def _conv(conv, x):
    return conv2d_nhwc(x, conv.weight, conv.bias, conv.stride[0], conv.padding[0])


class VAEResnet(nn.Module):
    def __init__(self, in_ch, out_ch, groups):
        super().__init__()
        self.groups = groups
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = _conv(self.conv1, _gn_silu(x, self.norm1, self.groups))
        h = _conv(self.conv2, _gn_silu(h, self.norm2, self.groups))
        if self.conv_shortcut is not None:
            x = _conv(self.conv_shortcut, x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention of the mid block: f32 logits and softmax,
    probabilities rounded to the activation dtype (vae.py:59-80)."""

    def __init__(self, ch, groups):
        super().__init__()
        self.groups = groups
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x):
        n, h, w, c = x.shape
        flat = group_norm(x, self.groups, self.group_norm.weight,
                          self.group_norm.bias, 1e-6).reshape(n, h * w, c)
        q, k, v = self.query(flat), self.key(flat), self.value(flat)
        logits = q.float() @ k.float().transpose(1, 2) / math.sqrt(c)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = self.proj_attn(probs @ v)
        return x + out.reshape(n, h, w, c)


class MidBlock(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, groups), VAEResnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Upsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(self.conv, x)


class UpDecoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, n_layers, groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnet(in_ch if j == 0 else out_ch, out_ch, groups)
             for j in range(n_layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)] if add_upsample else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for u in self.upsamplers:
            x = u(x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = self.groups = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList(
            [UpDecoderBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g,
                            i < len(rev) - 1) for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.sample_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(_conv(self.conv_in, z))
        for blk in self.up_blocks:
            h = blk(h)
        return _conv(self.conv_out, _gn_silu(h, self.conv_norm_out, self.groups))


class AutoencoderKL(nn.Module):
    """The VAE's decoding half: ``post_quant_conv`` + decoder."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def decode(self, z):
        return self.decoder(_conv(self.post_quant_conv, z))
