"""Down/mid/up blocks of the video UNet.

Counterpart of ``eeg2video_tpu/models/unet_blocks.py``, with diffusers
module names (``resnets``, ``attentions``, ``downsamplers``,
``upsamplers``). Up-block resnets take their skip as a separate operand
(see ``ResnetBlock3D``), as the JAX package does.
"""

from __future__ import annotations

from torch import nn

from .attention3d import Transformer3DModel
from .resnet3d import Downsample3D, ResnetBlock3D, Upsample3D


def _transformer(ch, heads, context_dim, groups):
    return Transformer3DModel(ch, heads, ch // heads, context_dim, groups=groups)


class CrossAttnDownBlock3D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups, eps, n_layers, heads,
                 context_dim, add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock3D(in_ch if i == 0 else out_ch, out_ch, temb_ch,
                           groups, eps) for i in range(n_layers)])
        self.attentions = nn.ModuleList(
            [_transformer(out_ch, heads, context_dim, groups)
             for _ in range(n_layers)])
        self.downsamplers = nn.ModuleList(
            [Downsample3D(out_ch)] if add_downsample else [])

    def forward(self, x, temb, context, attention_bias=None):
        states = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb), context, attention_bias)
            states.append(x)
        for down in self.downsamplers:
            x = down(x)
            states.append(x)
        return x, states


class DownBlock3D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups, eps, n_layers,
                 add_downsample=False):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock3D(in_ch if i == 0 else out_ch, out_ch, temb_ch,
                           groups, eps) for i in range(n_layers)])
        self.downsamplers = nn.ModuleList(
            [Downsample3D(out_ch)] if add_downsample else [])

    def forward(self, x, temb):
        states = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            states.append(x)
        for down in self.downsamplers:
            x = down(x)
            states.append(x)
        return x, states


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, ch, temb_ch, groups, eps, heads, context_dim):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock3D(ch, ch, temb_ch, groups, eps) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [_transformer(ch, heads, context_dim, groups)])

    def forward(self, x, temb, context, attention_bias=None):
        x = self.resnets[0](x, temb)
        return self.resnets[1](self.attentions[0](x, context, attention_bias),
                               temb)


def _up_resnets(prev_ch, out_ch, skip_chs, temb_ch, groups, eps):
    """Resnet i takes (prev_ch or out_ch) + skip_chs[i] input channels."""
    return nn.ModuleList(
        [ResnetBlock3D((prev_ch if i == 0 else out_ch) + s, out_ch, temb_ch,
                       groups, eps) for i, s in enumerate(skip_chs)])


class CrossAttnUpBlock3D(nn.Module):
    def __init__(self, prev_ch, out_ch, skip_chs, temb_ch, groups, eps, heads,
                 context_dim, add_upsample=True):
        super().__init__()
        self.resnets = _up_resnets(prev_ch, out_ch, skip_chs, temb_ch, groups, eps)
        self.attentions = nn.ModuleList(
            [_transformer(out_ch, heads, context_dim, groups) for _ in skip_chs])
        self.upsamplers = nn.ModuleList([Upsample3D(out_ch)] if add_upsample else [])

    def forward(self, x, skips, temb, context, attention_bias=None,
                upsample_size=None):
        skips = list(skips)
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb, skip=skips.pop()), context, attention_bias)
        for up in self.upsamplers:
            x = up(x, upsample_size)
        return x


class UpBlock3D(nn.Module):
    def __init__(self, prev_ch, out_ch, skip_chs, temb_ch, groups, eps,
                 add_upsample=True):
        super().__init__()
        self.resnets = _up_resnets(prev_ch, out_ch, skip_chs, temb_ch, groups, eps)
        self.upsamplers = nn.ModuleList([Upsample3D(out_ch)] if add_upsample else [])

    def forward(self, x, skips, temb, upsample_size=None):
        skips = list(skips)
        for resnet in self.resnets:
            x = resnet(x, temb, skip=skips.pop())
        for up in self.upsamplers:
            x = up(x, upsample_size)
        return x
