"""Pseudo-3D transformer blocks of the video UNet.

Counterpart of ``eeg2video_tpu/models/attention3d.py`` (inference paths).
Activations are (B, F, L, C), L = H*W spatial tokens. Spatial and cross
attention go through ``flash_attention_fwd`` with the JAX package's
inference folds, which decide the kernel calls:

- sparse-causal self-attention: frames 0 and 1 both attend [K0, K0], which
  is K0 alone, so they fold into the query axis as one (B, 2L) x (B, L) call
  (attention3d.py:222-242); frames 2..F-1 attend [K0 | K_{f-1}] in one
  two-segment call with K0 shared per batch element (:248-258);
- cross-attention folds the frames into the query axis, (B, F*L) x (B, S)
  (:491-503);
- temporal attention is plain PyTorch, as JAX keeps it in XLA at inference.

Module and parameter names follow the diffusers key space that
``eeg2video_tpu.convert.export_diffusion.unet3d_to_torch`` emits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention_fwd
from ..ops.geglu import feed_forward
from .resnet3d import group_norm


def _to_out(inner, out_features):
    # diffusers CrossAttention.to_out = [Linear, Dropout]: key "to_out.0"
    return nn.ModuleList([nn.Linear(inner, out_features), nn.Dropout(0.0)])


class Attention(nn.Module):
    """CrossAttention: to_q/k/v without bias, to_out. (N, L, C) -> (N, L, C);
    ``context`` (N, S, Dc) defaults to self-attention."""

    def __init__(self, query_dim, heads, head_dim, context_dim=None):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = _to_out(inner, query_dim)

    def forward(self, x, context=None):
        src = x if context is None else context
        out = flash_attention_fwd(self.to_q(x), self.to_k(src), self.to_v(src),
                                  self.heads)
        return self.to_out[0](out)


class SparseCausalAttention(Attention):
    """Self-attention whose keys are frame 0 and the previous frame. Input
    (B, F, L, C); ``bias`` optional (B, 1, L), applied to the frame-0 keys
    only (the reference's F.pad quirk, attention3d.py:161-165)."""

    def forward(self, x, bias=None):
        b, f = x.shape[:2]
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)  # (B, F, L, inner)
        out = torch.empty_like(q)
        if f == 1:
            flash_attention_fwd(q[:, 0], k[:, 0], v[:, 0], self.heads,
                                bias0=bias, out=out[:, 0])
        else:
            flash_attention_fwd(q[:, :2].flatten(1, 2), k[:, 0], v[:, 0],
                                self.heads, bias0=bias,
                                out=out[:, :2].flatten(1, 2))
        if f > 2:
            flash_attention_fwd(q[:, 2:], k[:, 0], v[:, 0], self.heads,
                                k1=k[:, 1:-1], v1=v[:, 1:-1], bias0=bias,
                                out=out[:, 2:])
        return self.to_out[0](out)


class TemporalAttentionUnrolled(Attention):
    """Self-attention over the frame axis at each token (F x F per head),
    plain PyTorch: f32 logits and softmax, probabilities rounded to v's dtype
    (JAX ``_temporal_core``, attention3d.py:277-301)."""

    def forward(self, x):
        b, f, l, _ = x.shape
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        d = q.shape[-1] // self.heads

        def split(t):
            return t.reshape(b, f, l, self.heads, d).float()

        logits = torch.einsum("bflhd,bglhd->blhfg", split(q), split(k))
        probs = torch.softmax(logits / math.sqrt(d), dim=-1).to(v.dtype)
        out = torch.einsum("blhfg,bglhd->bflhd", probs.float(), split(v))
        return self.to_out[0](out.reshape(b, f, l, -1).to(v.dtype))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """Parameter holder of diffusers' geglu FeedForward (keys net.0.proj,
    net.2); its math runs in ``ops.geglu.feed_forward``."""

    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  nn.Linear(dim * mult, dim)])


class BasicTransformerBlock(nn.Module):
    """SparseCausal -> Cross -> FF -> Temporal, each pre-LN with residual.
    Input (B, F, L, C), context (B, S, Dc)."""

    def __init__(self, dim, heads, head_dim, context_dim):
        super().__init__()
        self.attn1 = SparseCausalAttention(dim, heads, head_dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, context_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.attn_temp = TemporalAttentionUnrolled(dim, heads, head_dim)
        self.norm_temp = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context, attention_bias=None):
        b, f, l, c = x.shape
        x = x + self.attn1(self.norm1(x), attention_bias)
        h = self.norm2(x).reshape(b, f * l, c)
        x = x + self.attn2(h, context).reshape(b, f, l, c)
        proj, out = self.ff.net[0].proj, self.ff.net[2]
        x = feed_forward(x, self.norm3.weight, self.norm3.bias, proj.weight,
                         proj.bias, out.weight, out.bias, eps=1e-5)
        return x + self.attn_temp(self.norm_temp(x))


class Transformer3DModel(nn.Module):
    """GroupNorm -> 1x1 proj_in -> blocks -> 1x1 proj_out -> +residual. The
    GroupNorm runs on the frame-folded tensor, so its statistics are per
    frame (attention3d.py:558-563), unlike the resnets'."""

    def __init__(self, channels, heads, head_dim, context_dim, groups=32):
        super().__init__()
        inner = heads * head_dim
        self.groups = groups
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, context_dim)])
        self.proj_out = nn.Conv2d(inner, channels, 1)

    def forward(self, x, context, attention_bias=None):
        b, f, hh, ww, c = x.shape
        h = group_norm(x.flatten(0, 1), self.groups, self.norm.weight,
                       self.norm.bias, self.norm.eps)
        h = F.linear(h, self.proj_in.weight.flatten(1), self.proj_in.bias)
        tokens = h.reshape(b, f, hh * ww, -1)
        for blk in self.transformer_blocks:
            tokens = blk(tokens, context, attention_bias)
        h = F.linear(tokens, self.proj_out.weight.flatten(1), self.proj_out.bias)
        return x + h.reshape(b, f, hh, ww, c)
