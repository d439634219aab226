"""Plain float32 reference of the inflated Stable Diffusion 1.4 UNet.

The Tune-A-Video / EEG2Video UNet3DConditionModel written out from its
published description (showlab/Tune-A-Video tuneavideo/models/unet.py,
attention.py, resnet.py; EEG2Video_New/Generation/models/), in plain torch
over a state dict in the diffusers key space. Activations are channels-last,
(B, F, H, W, C):

- every 2-D convolution runs per frame (InflatedConv3d);
- a resnet's GroupNorm pools over frames, rows, columns and the group's
  channels of one video; a transformer's GroupNorm pools over one frame;
- attn1 is sparse-causal: frame f attends to [frame 0 | frame f-1] (frames
  0 and 1 attend to frame 0 alone, which is what [K0 | K0] gives), attn2 is
  cross-attention to the context, the feed-forward is GEGLU (exact erf
  GELU) and attn_temp attends over the frames at each token;
- up-block resnets take concat([x, skip]) with the skips popped last first.

Attention materialises its probabilities in blocks of rows (``ATTN_BYTES``),
each block recomputed in the backward when gradients are asked for, so that
a full-width step fits on one card. ``num`` (``numerics.Numerics``) rounds
the operands of every product; the f32 reference keeps them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTN_BYTES = 1 << 30  # f32 logits of one attention block


def param_shapes(cfg):
    """{name: shape} of every parameter, in a fixed order."""
    chs = list(cfg["block_out_channels"])
    n, layers = len(chs), cfg["layers_per_block"]
    temb, ctx = 4 * chs[0], cfg["cross_attention_dim"]
    out = {}

    def lin(name, o, i, bias=True):
        out[f"{name}.weight"] = (o, i)
        if bias:
            out[f"{name}.bias"] = (o,)

    def conv(name, o, i, k=3):
        out[f"{name}.weight"] = (o, i, k, k)
        out[f"{name}.bias"] = (o,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cout, cin)
        lin(f"{name}.time_emb_proj", cout, temb)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cout, cin, 1)

    def attention(name, c, kv):
        lin(f"{name}.to_q", c, c, bias=False)
        lin(f"{name}.to_k", c, kv, bias=False)
        lin(f"{name}.to_v", c, kv, bias=False)
        lin(f"{name}.to_out.0", c, c)

    def transformer(name, c):
        norm(f"{name}.norm", c)
        conv(f"{name}.proj_in", c, c, 1)
        blk = f"{name}.transformer_blocks.0"
        attention(f"{blk}.attn1", c, c)
        norm(f"{blk}.norm1", c)
        attention(f"{blk}.attn2", c, ctx)
        norm(f"{blk}.norm2", c)
        lin(f"{blk}.ff.net.0.proj", 8 * c, c)
        lin(f"{blk}.ff.net.2", c, 4 * c)
        norm(f"{blk}.norm3", c)
        attention(f"{blk}.attn_temp", c, c)
        norm(f"{blk}.norm_temp", c)
        conv(f"{name}.proj_out", c, c, 1)

    conv("conv_in", chs[0], cfg["in_channels"])
    lin("time_embedding.linear_1", temb, chs[0])
    lin("time_embedding.linear_2", temb, temb)
    skips = [chs[0]]
    for i, ch in enumerate(chs):
        cin = chs[max(i - 1, 0)]
        for j in range(layers):
            resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else ch, ch)
            if i < n - 1:
                transformer(f"down_blocks.{i}.attentions.{j}", ch)
            skips.append(ch)
        if i < n - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch)
            skips.append(ch)
    resnet("mid_block.resnets.0", chs[-1], chs[-1])
    transformer("mid_block.attentions.0", chs[-1])
    resnet("mid_block.resnets.1", chs[-1], chs[-1])
    prev = chs[-1]
    for i, ch in enumerate(reversed(chs)):
        res = skips[-(layers + 1):]
        skips = skips[:-(layers + 1)]
        for j in range(layers + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", (prev if j == 0 else ch) + res.pop(), ch)
            if i > 0:
                transformer(f"up_blocks.{i}.attentions.{j}", ch)
        if i < n - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv", ch, ch)
        prev = ch
    norm("conv_norm_out", chs[0])
    conv("conv_out", cfg["out_channels"], chs[0])
    return out


def trainable(name: str) -> bool:
    """The fine-tune's freeze rule: every attn_temp parameter, and to_q of
    attn1 and attn2 (train_finetune_videodiffusion.py, trainable_modules)."""
    parts = name.split(".")
    return "attn_temp" in parts or (("attn1" in parts or "attn2" in parts) and "to_q" in parts)


def timestep_embedding(t, dim, flip_sin_to_cos=True, freq_shift=0):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * torch.exp(exponent / (half - freq_shift))[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def group_norm(x, groups, w, b, eps):
    """Statistics of each leading row over every other axis and the group's
    channels."""
    n, c = x.shape[0], x.shape[-1]
    xr = x.reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xr, dim=(1, 3), keepdim=True, unbiased=False)
    return ((xr - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * w + b


def _attend_block(num, q, k, v, heads):
    n, lq, c = q.shape
    d = c // heads
    qh = num(q).reshape(n, lq, heads, d).transpose(1, 2)
    kh = num(k).reshape(n, -1, heads, d).transpose(1, 2)
    vh = num(v).reshape(n, -1, heads, d).transpose(1, 2)
    p = torch.softmax((qh @ kh.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return (num(p) @ vh).transpose(1, 2).reshape(n, lq, c)


def attend(num, q, k, v, heads):
    """softmax(q k^T / sqrt(d)) v per head: q (N, Lq, C), k and v (N, Lkv, C).
    Rows of N in blocks whose logits stay under ATTN_BYTES."""
    n, lq, _ = q.shape
    per_row = heads * lq * k.shape[1] * 4
    step = max(1, min(n, ATTN_BYTES // per_row))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for s in range(0, n, step):
        args = (num, q[s:s + step], k[s:s + step], v[s:s + step], heads)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False) if grad
                    else _attend_block(*args))
    return torch.cat(outs)


class UNet3D:
    """The forward of one inflated UNet over state dict ``p`` (f32 tensors
    on one device). ``checkpointed`` recomputes each resnet and transformer
    in the backward."""

    def __init__(self, p, cfg, num, checkpointed=False):
        self.p, self.cfg, self.num, self.checkpointed = p, cfg, num, checkpointed
        self.heads = cfg["attention_heads"]
        self.groups = cfg["norm_num_groups"]
        self.eps = cfg["norm_eps"]

    def _run(self, fn, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _lin(self, name, x, bias=True):
        return self.num.linear(x, self.p[f"{name}.weight"],
                               self.p[f"{name}.bias"] if bias else None)

    def _conv(self, name, x, stride=1):
        """Per-frame convolution of (B, F, H, W, C)."""
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        pad = w.shape[-1] // 2
        return self.num.conv(x.flatten(0, 1), w, b, stride, pad).unflatten(0, x.shape[:2])

    def _gn(self, name, x, eps, per_frame=False):
        xs = x.flatten(0, 1) if per_frame else x
        y = group_norm(xs, self.groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"], eps)
        return y.reshape(x.shape)

    def resnet(self, name, x, temb):
        h = F.silu(self._gn(f"{name}.norm1", x, self.eps))
        h = self._conv(f"{name}.conv1", h)
        h = h + self._lin(f"{name}.time_emb_proj", F.silu(temb))[:, None, None, None, :]
        h = self._conv(f"{name}.conv2", F.silu(self._gn(f"{name}.norm2", h, self.eps)))
        if f"{name}.conv_shortcut.weight" in self.p:
            x = self._conv(f"{name}.conv_shortcut", x)
        return x + h

    def _ln(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            1e-5)

    def _proj(self, name, x, ctx=None):
        src = x if ctx is None else ctx
        return (self._lin(f"{name}.to_q", x, False), self._lin(f"{name}.to_k", src, False),
                self._lin(f"{name}.to_v", src, False))

    def sparse_causal(self, name, x):
        b, f, l, c = x.shape
        q, k, v = self._proj(name, x)
        h = self.heads
        outs = [attend(self.num, q[:, :min(f, 2)].reshape(b, -1, c), k[:, 0], v[:, 0], h)
                .reshape(b, min(f, 2), l, c)]
        if f > 2:
            m = f - 2
            kk, vv = (torch.cat([t[:, :1].expand(b, m, l, c), t[:, 1:-1]], dim=2)
                      .reshape(b * m, 2 * l, c) for t in (k, v))
            outs.append(attend(self.num, q[:, 2:].reshape(b * m, l, c), kk, vv, h)
                        .reshape(b, m, l, c))
        return self._lin(f"{name}.to_out.0", torch.cat(outs, dim=1))

    def cross(self, name, x, ctx):
        b, f, l, c = x.shape
        q, k, v = self._proj(name, x.reshape(b, f * l, c), ctx)
        return self._lin(f"{name}.to_out.0", attend(self.num, q, k, v, self.heads)).reshape(x.shape)

    def temporal(self, name, x):
        b, f, l, c = x.shape
        q, k, v = (t.transpose(1, 2).reshape(b * l, f, c) for t in self._proj(name, x))
        out = attend(self.num, q, k, v, self.heads).reshape(b, l, f, c).transpose(1, 2)
        return self._lin(f"{name}.to_out.0", out)

    def feed_forward(self, name, x):
        h2 = self._lin(f"{name}.net.0.proj", x)
        h, g = h2.chunk(2, dim=-1)
        return self._lin(f"{name}.net.2", h * F.gelu(g))

    def transformer(self, name, x, ctx):
        b, f, hh, ww, c = x.shape
        h = self._gn(f"{name}.norm", x, 1e-6, per_frame=True)
        t = self._conv(f"{name}.proj_in", h).reshape(b, f, hh * ww, c)
        blk = f"{name}.transformer_blocks.0"
        t = t + self.sparse_causal(f"{blk}.attn1", self._ln(f"{blk}.norm1", t))
        t = t + self.cross(f"{blk}.attn2", self._ln(f"{blk}.norm2", t), ctx)
        t = t + self.feed_forward(f"{blk}.ff", self._ln(f"{blk}.norm3", t))
        t = t + self.temporal(f"{blk}.attn_temp", self._ln(f"{blk}.norm_temp", t))
        return x + self._conv(f"{name}.proj_out", t.reshape(b, f, hh, ww, c))

    def __call__(self, sample, t, ctx):
        """sample (B, F, H, W, C_in), t (B,) integer timesteps, ctx (B, S, D)
        -> (B, F, H, W, C_out)."""
        cfg, p = self.cfg, self.p
        chs = list(cfg["block_out_channels"])
        n, layers = len(chs), cfg["layers_per_block"]
        temb = timestep_embedding(t, chs[0], cfg.get("flip_sin_to_cos", True),
                                  cfg.get("freq_shift", 0))
        temb = self._lin("time_embedding.linear_2",
                         F.silu(self._lin("time_embedding.linear_1", temb)))
        x = self._conv("conv_in", sample)
        skips = [x]
        for i in range(n):
            for j in range(layers):
                x = self._run(self.resnet, f"down_blocks.{i}.resnets.{j}", x, temb)
                if i < n - 1:
                    x = self._run(self.transformer, f"down_blocks.{i}.attentions.{j}", x, ctx)
                skips.append(x)
            if i < n - 1:
                x = self._conv(f"down_blocks.{i}.downsamplers.0.conv", x, stride=2)
                skips.append(x)
        x = self._run(self.resnet, "mid_block.resnets.0", x, temb)
        x = self._run(self.transformer, "mid_block.attentions.0", x, ctx)
        x = self._run(self.resnet, "mid_block.resnets.1", x, temb)
        for i in range(n):
            res = skips[-(layers + 1):]
            skips = skips[:-(layers + 1)]
            for j in range(layers + 1):
                x = torch.cat([x, res.pop()], dim=-1)
                x = self._run(self.resnet, f"up_blocks.{i}.resnets.{j}", x, temb)
                if i > 0:
                    x = self._run(self.transformer, f"up_blocks.{i}.attentions.{j}", x, ctx)
            if i < n - 1:
                oh, ow = skips[-1].shape[2:4]
                hh, ww = x.shape[2:4]
                rows = torch.arange(oh, device=x.device) * hh // oh
                cols = torch.arange(ow, device=x.device) * ww // ow
                x = x.index_select(2, rows).index_select(3, cols)
                x = self._conv(f"up_blocks.{i}.upsamplers.0.conv", x)
        x = F.silu(self._gn("conv_norm_out", x, self.eps))
        return self._conv("conv_out", x)
