"""Pseudo-3D conv building blocks of the video UNet, channels-last.

Counterpart of ``eeg2video_tpu/models/resnet3d.py``. Activations are
(B, F, H, W, C); spatial convs fold frames into the batch axis. Convs that
the JAX package leaves to XLA run on cuDNN here: the NHWC activation is
handed over as an NCHW view with channels-last strides, so no copy is made.
At inference the level-0 GroupNorm -> SiLU -> conv chains go through the
``conv3x3_gn_silu`` kernel, exactly where the JAX package's ``eligible``
routes them (bf16 only: an f32 model takes the library convs, as JAX sends
f32 to XLA's). With ``train=True`` every
conv is the library's (resnet3d.py:227-238 there: ``use1/use2 = not train
and ...``), one call over all B*F frames, and autograd differentiates it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import residuals
from ..ops.conv2d import conv3x3_gn_silu, eligible as conv_eligible


def conv2d_nhwc(x, weight, bias, stride=1, padding=1):
    """(N, H, W, Cin) conv with a PyTorch (Cout, Cin, kh, kw) weight ->
    (N, H', W', Cout). 1x1 stride-1 convs are a channel matmul."""
    if weight.shape[-2:] == (1, 1) and stride == 1:
        return F.linear(x, weight.flatten(1), bias)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_frames(x, weight, bias, stride=1, padding=1, train=False):
    """Per-frame conv of (B, F, H, W, Cin) -> (B, F, H', W', Cout), one
    library call per batch element. Within one call cuDNN may sum an image's
    reduction in an order that depends on the image's place in the batch
    (seen on the H100 at the 1280-channel 3x3 convs on 9x16 and 5x8 frames:
    equal inputs at two batch positions, outputs one bf16 ulp apart), and a
    served clip must not depend on what shares its dispatch. Equal calls on
    equal frames give equal bits, wherever the clip stands. A train step
    serves no clip: with ``train`` all B*F frames go into one call."""
    if weight.shape[-2:] == (1, 1) and stride == 1:
        return conv2d_nhwc(x, weight, bias)  # a channel matmul: row-wise already
    if train:
        return conv2d_nhwc(x.flatten(0, 1), weight, bias, stride, padding).unflatten(
            0, x.shape[:2])
    return torch.stack([conv2d_nhwc(xi, weight, bias, stride, padding) for xi in x])


def group_norm(x, groups, weight, bias, eps):
    """GroupNorm of channels-last x (N, ..., C): statistics pooled over every
    axis but N within each channel group, in f32 (flax nn.GroupNorm
    semantics, E[x^2] - E[x]^2 variance); output in x's dtype."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)
    return (y.reshape(x.shape) * weight.float() + bias.float()).to(x.dtype)


def _affine(s1, s2, cnt, gamma, beta, groups, eps):
    """(B, G, C/G) channel sums -> per-(image, channel) (scale, shift), f32,
    such that x * scale + shift == GroupNorm(x)."""
    b = s1.shape[0]
    mean = s1.sum(dim=-1) / cnt  # (B, G)
    var = s2.sum(dim=-1) / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    gpc = s1.shape[-1]
    scale = gamma.float().reshape(groups, gpc)[None] * rstd[:, :, None]
    shift = beta.float().reshape(groups, gpc)[None] - mean[:, :, None] * scale
    return scale.reshape(b, -1), shift.reshape(b, -1)


def _chan_sums(t):
    """(B, F, H, W, C) -> per-channel (sum, sum of squares), (B, C) f32."""
    tf = t.float()
    return tf.sum(dim=(1, 2, 3)), (tf * tf).sum(dim=(1, 2, 3))


def gn_affine(x, gamma, beta, groups, eps):
    """(scale, shift) of the GroupNorm pooled over (F, H, W, group channels)
    (JAX ``_gn_affine``, resnet3d.py:185-200)."""
    b, f, hh, ww, c = x.shape
    s1, s2 = _chan_sums(x)
    return _affine(s1.reshape(b, groups, -1), s2.reshape(b, groups, -1),
                   f * hh * ww * (c // groups), gamma, beta, groups, eps)


def gn_affine_from_stats(stats, b, f, hw, gamma, beta, groups, eps):
    """The same affine from the conv kernel's per-image (N, 2, C) output
    stats (JAX ``_gn_affine_from_stats``, resnet3d.py:135-150)."""
    c = stats.shape[-1]
    s = stats.float().reshape(b, f, 2, groups, c // groups).sum(dim=1)
    return _affine(s[:, 0], s[:, 1], f * hw * (c // groups), gamma, beta,
                   groups, eps)


def gn_affine_pair(x, skip, gamma, beta, groups, eps):
    """GroupNorm affine of concat([x, skip], channels) without building the
    concat (JAX ``_gn_affine_pair``, resnet3d.py:153-182); returns the
    (scale, shift) of each half."""
    b, f, hh, ww, cx = x.shape
    c = cx + skip.shape[-1]
    sx, sx2 = _chan_sums(x)
    ss, ss2 = _chan_sums(skip)
    s1 = torch.cat([sx, ss], dim=-1).reshape(b, groups, c // groups)
    s2 = torch.cat([sx2, ss2], dim=-1).reshape(b, groups, c // groups)
    scale, shift = _affine(s1, s2, f * hh * ww * (c // groups), gamma, beta,
                           groups, eps)
    return (scale[:, :cx], shift[:, :cx]), (scale[:, cx:], shift[:, cx:])


class PseudoConv3d(nn.Conv2d):
    """Per-frame 2-D convolution (InflatedConv3d) on (B, F, H, W, C)."""

    def forward(self, x, train=False):
        return conv2d_frames(x, self.weight, self.bias, self.stride[0], self.padding[0],
                             train)


class Upsample3D(nn.Module):
    """Nearest upsample per frame to ``output_size`` (2x by default) + 3x3
    conv. The explicit floor-index gather of resnet3d.py:73-75 handles the
    non-power-of-two sizes (5 -> 9, 9 -> 18)."""

    def __init__(self, channels):
        super().__init__()
        self.conv = PseudoConv3d(channels, channels, 3, padding=1)

    def forward(self, x, output_size=None, train=False):
        h, w = x.shape[2], x.shape[3]
        oh, ow = output_size if output_size is not None else (2 * h, 2 * w)
        rows = torch.arange(oh, device=x.device) * h // oh
        cols = torch.arange(ow, device=x.device) * w // ow
        x = x.index_select(2, rows).index_select(3, cols)
        return self.conv(x, train)


class Downsample3D(nn.Module):
    """Stride-2 3x3 conv per frame."""

    def __init__(self, channels):
        super().__init__()
        self.conv = PseudoConv3d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x, train=False):
        return self.conv(x, train)


def _per_frame(t, f):
    """(B, C) per-video rows -> (B*F, C) per-image f32 rows."""
    return t.float().repeat_interleave(f, dim=0)


class ResnetBlock3D(nn.Module):
    """GN -> SiLU -> conv -> (+time) -> GN -> SiLU -> conv -> +shortcut.

    ``skip`` is an up-block's lateral input, logically concat([x, skip],
    channels): norm1's affine comes from per-half channel sums and conv1 /
    conv_shortcut run as per-half convs summed, so the concat never exists
    (resnet3d.py:243-279). Where conv1 and conv2 both take the kernel, conv1
    also emits the output statistics that feed norm2 (resnet3d.py:297-321).
    On the library path conv1 (with the time embedding added) and conv2 are
    ``resnet_conv`` regions (``ops.residuals``): a recomputed block that keeps
    them does not run them again (resnet3d.py:296, :336, :356).
    """

    def __init__(self, in_channels, out_channels, temb_channels, groups=32,
                 eps=1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.out_channels = out_channels
        self.norm1 = nn.GroupNorm(groups, in_channels, eps)
        self.conv1 = PseudoConv3d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps)
        self.conv2 = PseudoConv3d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (PseudoConv3d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _gn_silu(self, x, norm):
        return F.silu(group_norm(x, self.groups, norm.weight, norm.bias, self.eps))

    def forward(self, x, temb, skip=None, train=False):
        b, f, hh, ww, cx = x.shape
        cout = self.out_channels
        g, eps = self.groups, self.eps
        t = self.time_emb_proj(F.silu(temb))  # (B, Cout)
        use2 = not train and conv_eligible(hh, ww, cout, cout, x.dtype)
        w1, b1 = self.conv1.weight, self.conv1.bias
        conv1_stats = None
        if skip is not None:
            cs = skip.shape[-1]
            (s1x, sh1x), (s1s, sh1s) = gn_affine_pair(
                x, skip, self.norm1.weight, self.norm1.bias, g, eps)
            if (not train and conv_eligible(hh, ww, cx, cout, x.dtype)
                    and conv_eligible(hh, ww, cs, cout, skip.dtype)):
                ha = conv3x3_gn_silu(x.flatten(0, 1), w1[:, :cx], b1,
                                     _per_frame(s1x, f), _per_frame(sh1x, f),
                                     _per_frame(t, f))
                hb = conv3x3_gn_silu(skip.flatten(0, 1), w1[:, cx:],
                                     torch.zeros_like(b1), _per_frame(s1s, f),
                                     _per_frame(sh1s, f))
                h = (ha + hb).unflatten(0, (b, f))
            else:
                def act(tens, sc, sh):
                    return F.silu(tens.float() * sc[:, None, None, None, :]
                                  + sh[:, None, None, None, :]).to(x.dtype)

                ax, askip = act(x, s1x, sh1x), act(skip, s1s, sh1s)
                with residuals.region(residuals.RESNET_CONV, "resnet_conv"):
                    h = (conv2d_frames(ax, w1[:, :cx], None, train=train).flatten(0, 1)
                         + conv2d_frames(askip, w1[:, cx:], None, train=train).flatten(0, 1))
                    h = (h.float() + b1.float()).to(x.dtype).unflatten(0, (b, f))
                    h = h + t[:, None, None, None, :].to(h.dtype)
        elif not train and conv_eligible(hh, ww, cx, cout, x.dtype):
            s1, sh1 = gn_affine(x, self.norm1.weight, self.norm1.bias, g, eps)
            res = conv3x3_gn_silu(x.flatten(0, 1), w1, b1, _per_frame(s1, f),
                                  _per_frame(sh1, f), _per_frame(t, f),
                                  with_stats=use2)
            h, conv1_stats = res if use2 else (res, None)
            h = h.unflatten(0, (b, f))
        else:
            a = self._gn_silu(x, self.norm1)
            with residuals.region(residuals.RESNET_CONV, "resnet_conv"):
                h = self.conv1(a, train) + t[:, None, None, None, :]

        if use2:
            if conv1_stats is not None:
                s2, sh2 = gn_affine_from_stats(conv1_stats, b, f, hh * ww,
                                               self.norm2.weight,
                                               self.norm2.bias, g, eps)
            else:
                s2, sh2 = gn_affine(h, self.norm2.weight, self.norm2.bias, g, eps)
            h = conv3x3_gn_silu(h.flatten(0, 1), self.conv2.weight,
                                self.conv2.bias, _per_frame(s2, f),
                                _per_frame(sh2, f)).unflatten(0, (b, f))
        else:
            a = self._gn_silu(h, self.norm2)
            with residuals.region(residuals.RESNET_CONV, "resnet_conv"):
                h = self.conv2(a, train)

        if skip is not None:
            ws = self.conv_shortcut.weight.flatten(1)
            x = (F.linear(x, ws[:, :cx]) + F.linear(skip, ws[:, cx:])
                 + self.conv_shortcut.bias)
        elif self.conv_shortcut is not None:
            x = self.conv_shortcut(x, train)
        return x + h
