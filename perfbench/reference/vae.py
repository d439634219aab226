"""Plain float32 reference of the Stable Diffusion 1.4 VAE decoder.

AutoencoderKL's ``post_quant_conv`` and decoder (diffusers' vae.py Decoder,
CompVis/stable-diffusion-v1-4 vae/config.json) over a state dict in the
diffusers key space, channels-last (N, H, W, C): conv_in, a mid block of
resnet -> single-head attention -> resnet, four up blocks of
``layers_per_block + 1`` resnets with nearest 2x upsampling and a conv
between them, GroupNorm(eps 1e-6) -> SiLU -> conv_out. ``param_shapes``
lists the encoder too, so that the whole model's state can be made.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .unet3d import group_norm

SD_VAE_SCALE = 0.18215


def param_shapes(cfg):
    chs = list(cfg["block_out_channels"])
    layers = cfg["layers_per_block"]
    lat, img = cfg["latent_channels"], cfg["sample_channels"]
    out = {}

    def conv(name, o, i, k=3):
        out[f"{name}.weight"] = (o, i, k, k)
        out[f"{name}.bias"] = (o,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cout, cin)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cout, cin, 1)

    def mid(name, c):
        resnet(f"{name}.resnets.0", c, c)
        norm(f"{name}.attentions.0.group_norm", c)
        for k in ("query", "key", "value", "proj_attn"):
            out[f"{name}.attentions.0.{k}.weight"] = (c, c)
            out[f"{name}.attentions.0.{k}.bias"] = (c,)
        resnet(f"{name}.resnets.1", c, c)

    conv("encoder.conv_in", chs[0], img)
    for i, ch in enumerate(chs):
        for j in range(layers):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", chs[max(i - 1, 0)] if j == 0 else ch, ch)
        if i < len(chs) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch)
    mid("encoder.mid_block", chs[-1])
    norm("encoder.conv_norm_out", chs[-1])
    conv("encoder.conv_out", 2 * lat, chs[-1])
    rev = list(reversed(chs))
    conv("decoder.conv_in", rev[0], lat)
    mid("decoder.mid_block", rev[0])
    for i, ch in enumerate(rev):
        for j in range(layers + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", rev[max(i - 1, 0)] if j == 0 else ch, ch)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch)
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", img, rev[-1])
    conv("quant_conv", 2 * lat, 2 * lat, 1)
    conv("post_quant_conv", lat, lat, 1)
    return out


class Decoder:
    """latents (N, h, w, 4), already divided by the SD scale -> images (N,
    8h, 8w, 3) in about [-1, 1]."""

    def __init__(self, p, cfg, num):
        self.p, self.cfg, self.num = p, cfg, num
        self.groups = cfg["norm_num_groups"]

    def _conv(self, name, x):
        w = self.p[f"{name}.weight"]
        return self.num.conv(x, w, self.p[f"{name}.bias"], 1, w.shape[-1] // 2)

    def _gn_silu(self, name, x):
        return F.silu(group_norm(x, self.groups, self.p[f"{name}.weight"],
                                 self.p[f"{name}.bias"], 1e-6))

    def resnet(self, name, x):
        h = self._conv(f"{name}.conv1", self._gn_silu(f"{name}.norm1", x))
        h = self._conv(f"{name}.conv2", self._gn_silu(f"{name}.norm2", h))
        if f"{name}.conv_shortcut.weight" in self.p:
            x = self._conv(f"{name}.conv_shortcut", x)
        return x + h

    def attention(self, name, x):
        n, hh, ww, c = x.shape
        a = group_norm(x, self.groups, self.p[f"{name}.group_norm.weight"],
                       self.p[f"{name}.group_norm.bias"], 1e-6).reshape(n, hh * ww, c)
        q, k, v = (self.num.linear(a, self.p[f"{name}.{t}.weight"], self.p[f"{name}.{t}.bias"])
                   for t in ("query", "key", "value"))
        probs = torch.softmax(self.num.matmul(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        out = self.num.linear(self.num.matmul(probs, v), self.p[f"{name}.proj_attn.weight"],
                              self.p[f"{name}.proj_attn.bias"])
        return x + out.reshape(x.shape)

    def __call__(self, z):
        layers = self.cfg["layers_per_block"]
        n_up = len(self.cfg["block_out_channels"])
        h = self._conv("decoder.conv_in", self._conv("post_quant_conv", z))
        h = self.resnet("decoder.mid_block.resnets.0", h)
        h = self.attention("decoder.mid_block.attentions.0", h)
        h = self.resnet("decoder.mid_block.resnets.1", h)
        for i in range(n_up):
            for j in range(layers + 1):
                h = self.resnet(f"decoder.up_blocks.{i}.resnets.{j}", h)
            if i < n_up - 1:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = self._conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", h)
        return self._conv("decoder.conv_out", self._gn_silu("decoder.conv_norm_out", h))
