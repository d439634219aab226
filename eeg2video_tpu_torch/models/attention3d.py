"""Pseudo-3D transformer blocks of the video UNet.

Counterpart of ``eeg2video_tpu/models/attention3d.py``. Activations are
(B, F, L, C), L = H*W spatial tokens. Spatial and cross attention go through
``ops.attention.flash_attention`` with the JAX package's layouts, which
decide the kernel calls. At inference (``train=False``):

- sparse-causal self-attention: frames 0 and 1 both attend [K0, K0], which
  is K0 alone, so they fold into the query axis as one (B, 2L) x (B, L) call
  (attention3d.py:222-242); frames 2..F-1 attend [K0 | K_{f-1}] in one
  two-segment call with K0 shared per batch element (:248-258);
- cross-attention folds the frames into the query axis, (B, F*L) x (B, S)
  (:491-503);
- temporal attention is plain PyTorch, as JAX keeps it in XLA at inference.

With ``train=True`` (the fine-tune step; every call is differentiable, with
the backward kernels behind it):

- frames 0 and 1 stay unfolded: (B, 2, L) query groups against the K0 of
  their batch element (:236-241; the kernel reads K0 per group, so the
  broadcast is never built and dk0 is summed over the two groups);
- frames 2..F-1 take the same two-segment call and its backward (:249-258);
- cross-attention stays per frame, (B*F, L) x (B*F, S) with the context
  repeated per frame (:504-511);
- temporal attention takes ``ops.temporal.temporal_attention`` (:375-385).

Across GPUs, forward and backward:

- sp: under ``sp_scope(mesh)`` spatial and cross attention go through ring
  attention (``ops.ring``, attention3d.py:60-119), in ``train=True`` as at
  inference (JAX's train route, :186-219); only the attention internals
  split over sp, the activations around them stay whole on every sp rank,
  and so do their gradients (the ring's backward gathers them). Temporal
  attention never splits over sp. The ring's output is no ``flash_out``
  residual (JAX's ring names none), so a recomputed block runs its hops
  again in the backward, every rank the same blocks in the same order;
- tp: after ``parallel.shard_params`` with ``train.unet_tp_rules`` every
  attention (attn1, attn2, attn_temp) runs this rank's ``heads // tp`` heads
  of the column-split to_q/k/v, and to_out's partial products are summed
  over the tp group (``reduce_from``) before its bias is added once; the
  feed-forward runs its GEGLU halves' shards without residual or bias, and x
  + bias is added once after the sum (``BasicTransformerBlock``). Each input
  of a column-split projection (x, the context, the feed-forward's
  LayerNorm input and weights, the attention bias) enters through ``copy_to``, whose
  backward sums the ranks' partial gradients of it over tp (Megatron's f and
  g, which GSPMD inserts in JAX).

Module and parameter names follow the diffusers key space that
``eeg2video_tpu.convert.export_diffusion.unet3d_to_torch`` emits.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, flash_attention_fwd
from ..ops.geglu import feed_forward
from ..ops.temporal import temporal_attention
from ..parallel.mesh import copy_to, reduce_from
from .resnet3d import group_norm


def _to_out(inner, out_features):
    # diffusers CrossAttention.to_out = [Linear, Dropout]: key "to_out.0"
    return nn.ModuleList([nn.Linear(inner, out_features), nn.Dropout(0.0)])


# --- sp: ring attention over the mesh's sp axis (attention3d.py:60-119) -------
_SP = {"mesh": None}


@contextlib.contextmanager
def sp_scope(mesh):
    """Route spatial and cross attention through ring attention while inside
    this scope. ``mesh`` None, or one whose sp axis has size 1, is a no-op."""
    old = _SP["mesh"]
    _SP["mesh"] = mesh
    try:
        yield
    finally:
        _SP["mesh"] = old


def _sp_size() -> int:
    mesh = _SP["mesh"]
    return 1 if mesh is None else mesh.size("sp")


def _sp_attention(q, k, v, heads, bias=None):
    """One (N, Lq, H*D) x (N, Lkv, H*D) attention: ring attention over the sp
    axis when a scope is open and the query tokens divide, else the one-GPU
    path. The operands are whole (replicated over sp) and so is the output.
    Under tp the projections are sharded already: q holds this rank's heads."""
    sp = _sp_size()
    if sp > 1 and q.shape[1] % sp == 0:
        from ..ops.ring import ring_attention_packed

        return ring_attention_packed(q, k, v, heads, _SP["mesh"], bias=bias, head_axis=None)
    return flash_attention(q, k, v, heads, bias0=bias)


# --- tp: row-split output projections ------------------------------------------

def check_tp_heads(model, tp: int, tp_rules):
    """Raise, naming the module, where tp would cut an attention's heads (a
    rank's shard of to_q/k/v must hold whole heads); call it before slicing."""
    if tp_rules is None or tp <= 1:
        return
    for name, m in model.named_modules():
        if (isinstance(m, Attention) and m.heads % tp
                and tp_rules(f"{name}.to_q.weight") is not None):
            raise ValueError(f"{name}: heads={m.heads} not divisible by tp={tp}")


def _tp_group(linear):
    """The group over which ``linear``'s input features are split
    (``parallel.shard_params``' split of dim 1 of its weight), or None."""
    spec = getattr(linear, "shard_specs", {}).get("weight")
    return None if spec is None or spec[0] != 1 else linear.mesh.group(spec[1])


def _col_group(linear):
    """The group over which ``linear``'s output features are split (dim 0 of
    its weight), or None: its input's gradient is partial on each rank."""
    spec = getattr(linear, "shard_specs", {}).get("weight")
    return None if spec is None or spec[0] != 0 else linear.mesh.group(spec[1])


def _row_parallel(linear, x):
    """``linear(x)``; where its input features are split over tp, the
    partial products are summed over the group before the bias is added once."""
    group = _tp_group(linear)
    if group is None:
        return linear(x)
    return reduce_from(F.linear(x, linear.weight), group) + linear.bias


class Attention(nn.Module):
    """CrossAttention: to_q/k/v without bias, to_out. (N, L, C) -> (N, L, C);
    ``context`` (N, S, Dc) defaults to self-attention."""

    def __init__(self, query_dim, heads, head_dim, context_dim=None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = _to_out(inner, query_dim)

    def local_heads(self):
        """The heads of this rank's shard of to_q/k/v: all of them unless
        ``parallel.shard_params`` split the projections over tp."""
        return self.to_q.weight.shape[0] // self.head_dim

    def forward(self, x, context=None):
        group = _col_group(self.to_q)
        x = copy_to(x, group)
        src = x if context is None else copy_to(context, group)
        heads = self.local_heads()
        out = _sp_attention(self.to_q(x), self.to_k(src), self.to_v(src), heads)
        return _row_parallel(self.to_out[0], out)


class SparseCausalAttention(Attention):
    """Self-attention whose keys are frame 0 and the previous frame. Input
    (B, F, L, C); ``bias`` optional (B, 1, L), applied to the frame-0 keys
    only (the reference's F.pad quirk, attention3d.py:161-165)."""

    def forward(self, x, bias=None, train=False):
        b, f, l = x.shape[:3]
        group = _col_group(self.to_q)
        x = copy_to(x, group)
        if bias is not None:  # each rank's heads give part of its gradient
            bias = copy_to(bias, group)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)  # (B, F, L, inner)
        heads = self.local_heads()
        sp = _sp_size()
        if sp > 1 and l % sp == 0:
            return _row_parallel(self.to_out[0],
                                 self._sp_forward(q, k, v, bias, heads))
        if train:
            if f == 1:
                out = flash_attention(q[:, 0], k[:, 0], v[:, 0], heads,
                                      bias0=bias)[:, None]
            else:
                out = flash_attention(q[:, :2], k[:, 0], v[:, 0], heads,
                                      bias0=bias)
            if f > 2:
                rest = flash_attention(q[:, 2:], k[:, 0], v[:, 0], heads,
                                       k1=k[:, 1:-1], v1=v[:, 1:-1], bias0=bias)
                out = torch.cat([out, rest], dim=1)
            return _row_parallel(self.to_out[0], out)
        out = torch.empty_like(q)
        if f == 1:
            flash_attention_fwd(q[:, 0], k[:, 0], v[:, 0], heads,
                                bias0=bias, out=out[:, 0])
        else:
            flash_attention_fwd(q[:, :2].flatten(1, 2), k[:, 0], v[:, 0],
                                heads, bias0=bias,
                                out=out[:, :2].flatten(1, 2))
        if f > 2:
            flash_attention_fwd(q[:, 2:], k[:, 0], v[:, 0], heads,
                                k1=k[:, 1:-1], v1=v[:, 1:-1], bias0=bias,
                                out=out[:, 2:])
        return _row_parallel(self.to_out[0], out)

    @staticmethod
    def _sp_forward(q, k, v, bias, heads):
        """The sp route (attention3d.py:188-219): frames 0-1 as one (B, 2L)
        query against K0; frames >= 2 against the [K0 | K_prev] concat of
        length 2L with the bias [bias, 0] per frame, which the ring splits
        (at sp = 2, rank 0's block is K0 and rank 1's K_prev)."""
        b, f, l, inner = q.shape

        def attend(qq, kk, vv, bb):
            return _sp_attention(qq, kk, vv, heads, bias=bb)

        if f == 1:
            return attend(q[:, 0], k[:, 0], v[:, 0], bias)[:, None]
        out01 = attend(q[:, :2].reshape(b, 2 * l, inner), k[:, 0], v[:, 0], bias)
        out01 = out01.reshape(b, 2, l, inner)
        m = f - 2
        if m == 0:
            return out01
        kg, vg = (torch.cat([t[:, :1].expand(b, m, l, inner), t[:, 1:-1]], dim=2)
                  .reshape(b * m, 2 * l, inner) for t in (k, v))
        bias2 = None
        if bias is not None:
            bias2 = torch.cat([bias, torch.zeros_like(bias)], dim=-1).repeat_interleave(m, dim=0)
        outr = attend(q[:, 2:].reshape(b * m, l, inner), kg, vg, bias2)
        return torch.cat([out01, outr.reshape(b, m, l, inner)], dim=1)


class TemporalAttentionUnrolled(Attention):
    """Self-attention over the frame axis at each token (F x F per head).
    At inference plain PyTorch: f32 logits and softmax, probabilities rounded
    to v's dtype (JAX ``_temporal_core``, attention3d.py:277-301). With
    ``train`` the ``temporal_attention`` kernel pair, as JAX takes its Pallas
    pair there."""

    def forward(self, x, train=False):
        b, f, l, _ = x.shape
        x = copy_to(x, _col_group(self.to_q))
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        heads = self.local_heads()
        if train:
            return _row_parallel(self.to_out[0], temporal_attention(q, k, v, heads))
        d = self.head_dim

        def split(t):
            return t.reshape(b, f, l, heads, d).float()

        logits = torch.einsum("bflhd,bglhd->blhfg", split(q), split(k))
        probs = torch.softmax(logits / math.sqrt(d), dim=-1).to(v.dtype)
        out = torch.einsum("blhfg,bglhd->bflhd", probs.float(), split(v))
        return _row_parallel(self.to_out[0], out.reshape(b, f, l, -1).to(v.dtype))


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

    def forward(self, x, context, attention_bias=None, train=False):
        b, f, l, c = x.shape
        x = x + self.attn1(self.norm1(x), attention_bias, train)
        if train:
            h = self.norm2(x).reshape(b * f, l, c)
            ctx = context.repeat_interleave(f, dim=0)  # (B*F, S, Dc)
        else:
            h, ctx = self.norm2(x).reshape(b, f * l, c), context
        x = x + self.attn2(h, ctx).reshape(b, f, l, c)
        proj, out = self.ff.net[0].proj, self.ff.net[2]
        group = _tp_group(out)
        if group is None:
            x = feed_forward(x, self.norm3.weight, self.norm3.bias, proj.weight,
                             proj.bias, out.weight, out.bias, eps=1e-5)
        else:
            # this rank's GEGLU halves: the partial product without residual
            # or bias, summed over tp, then x + bias once; the LayerNorm's
            # weights, whole on every rank, get partial gradients too
            part = feed_forward(copy_to(x, group), copy_to(self.norm3.weight, group),
                                copy_to(self.norm3.bias, group), proj.weight, proj.bias,
                                out.weight, torch.zeros_like(out.bias), eps=1e-5,
                                residual=False)
            x = x + (reduce_from(part, group) + out.bias)
        return x + self.attn_temp(self.norm_temp(x), train)


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

    def forward(self, x, context, attention_bias=None, train=False):
        b, f, hh, ww, c = x.shape
        h = group_norm(x.flatten(0, 1), self.groups, self.norm.weight,
                       self.norm.bias, self.norm.eps)
        h = F.linear(h, self.proj_in.weight.flatten(1), self.proj_in.bias)
        tokens = h.reshape(b, f, hh * ww, -1)
        for blk in self.transformer_blocks:
            tokens = blk(tokens, context, attention_bias, train)
        h = F.linear(tokens, self.proj_out.weight.flatten(1), self.proj_out.bias)
        return x + h.reshape(b, f, hh, ww, c)
