"""UNet3DConditionModel: the SD-1.4 UNet inflated to pseudo-3D, in PyTorch.

Counterpart of ``eeg2video_tpu/models/unet3d.py``. I/O contract
(channels-last, as the JAX package): sample (B, F, H, W, C_in), timesteps
(B,) or scalar, context (B, S, cross_attention_dim) -> (B, F, H, W, C_out).
Parameter names are the diffusers / reference key space.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import PseudoConv3d, group_norm
from .unet_blocks import (CrossAttnDownBlock3D, CrossAttnUpBlock3D,
                          DownBlock3D, UNetMidBlock3DCrossAttn, UpBlock3D)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    freq_shift: int = 0
    flip_sin_to_cos: bool = True

    @classmethod
    def tiny(cls):
        """Small config for tests (the JAX package's UNet3DConfig.tiny)."""
        return cls(block_out_channels=(32, 64, 64, 64), attention_heads=4,
                   cross_attention_dim=16, norm_num_groups=8)


def timestep_embedding(timesteps, dim, flip_sin_to_cos=True, freq_shift=0,
                       max_period=10000.0):
    """diffusers get_timestep_embedding semantics, f32 (unet3d.py:71-82)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNet3DConfig = UNet3DConfig()):
        super().__init__()
        cfg = self.config = config
        chs = cfg.block_out_channels
        n = len(chs)
        temb_ch = chs[0] * 4
        g, eps, heads = cfg.norm_num_groups, cfg.norm_eps, cfg.attention_heads
        ctx = cfg.cross_attention_dim
        self.conv_in = PseudoConv3d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb_ch)

        skip_chs = [chs[0]]  # channels of each down-path state, in order
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chs):
            prev = chs[max(i - 1, 0)]
            if i < n - 1:
                blk = CrossAttnDownBlock3D(prev, ch, temb_ch, g, eps,
                                           cfg.layers_per_block, heads, ctx)
            else:
                blk = DownBlock3D(prev, ch, temb_ch, g, eps, cfg.layers_per_block)
            self.down_blocks.append(blk)
            skip_chs += [ch] * (cfg.layers_per_block + (i < n - 1))

        self.mid_block = UNetMidBlock3DCrossAttn(chs[-1], temb_ch, g, eps, heads, ctx)

        n_up = cfg.layers_per_block + 1
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        prev = chs[-1]
        for i, ch in enumerate(rev):
            res = skip_chs[-n_up:]
            skip_chs = skip_chs[:-n_up]
            skips = list(reversed(res))  # resnet j pops the last state first
            add_up = i < n - 1
            if i == 0:
                blk = UpBlock3D(prev, ch, skips, temb_ch, g, eps, add_up)
            else:
                blk = CrossAttnUpBlock3D(prev, ch, skips, temb_ch, g, eps, heads,
                                         ctx, add_up)
            self.up_blocks.append(blk)
            prev = ch

        self.conv_norm_out = nn.GroupNorm(g, chs[0], eps)
        self.conv_out = PseudoConv3d(chs[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, attention_mask=None):
        cfg = self.config
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)
        n = len(cfg.block_out_channels)

        # attention_mask (B, H, W) or (B, H*W) at latent resolution -> an
        # additive (1 - m) * -1e4 bias per level, stride-2 resampled to follow
        # the downsamplers (unet3d.py:115-129)
        level_bias = [None] * n
        if attention_mask is not None:
            m = attention_mask.float().reshape(b, sample.shape[2], sample.shape[3])
            for i in range(n):
                level_bias[i] = (1.0 - m.reshape(b, 1, -1)) * -10000.0
                m = m[:, ::2, ::2]

        dtype = self.conv_in.weight.dtype
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dtype)
        temb = self.time_embedding(t_emb)

        x = self.conv_in(sample)
        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            if isinstance(blk, CrossAttnDownBlock3D):
                x, states = blk(x, temb, context, level_bias[i])
            else:
                x, states = blk(x, temb)
            skips += states

        x = self.mid_block(x, temb, context, level_bias[-1])

        n_up = cfg.layers_per_block + 1
        for i, blk in enumerate(self.up_blocks):
            res = skips[-n_up:]
            skips = skips[:-n_up]
            # the next level's skip fixes the upsampled size (36x64 latents do
            # not halve evenly: 5 -> 9 -> 18 -> 36)
            size = tuple(skips[-1].shape[2:4]) if i < n - 1 else None
            if isinstance(blk, CrossAttnUpBlock3D):
                x = blk(x, res, temb, context, level_bias[n - 1 - i], size)
            else:
                x = blk(x, res, temb, size)

        x = F.silu(group_norm(x, cfg.norm_num_groups, self.conv_norm_out.weight,
                              self.conv_norm_out.bias, cfg.norm_eps))
        return self.conv_out(x)
