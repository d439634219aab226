"""Time the attention kernels (or another kernel's cases, ``--cases``) of one or more checkouts on one GPU.

    python -m eeg2video_tpu_torch.utils.attention_ab --tree PARENT --tree . --tree . --tree PARENT
    python -m eeg2video_tpu_torch.utils.attention_ab --cases attention_f32 --tree PARENT ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases ff_ln --tree PARENT --tree . ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases ff_ln_bwd --tree PARENT --tree . ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases ff_f32 --tree PARENT --tree . ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases ff_bwd_f32 --tree PARENT --tree . ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases conv3x3 --tree PARENT --tree . ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases geglu_out --tree PARENT --tree . ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases temporal --tree PARENT --tree . ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases geglu_out_bwd --tree PARENT ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases geglu_f32 --tree PARENT ...
    python -m eeg2video_tpu_torch.utils.attention_ab --cases int8 --tree PARENT --tree . ...

Each ``--tree`` is the root of a checkout. Its ``eeg2video_tpu_torch`` is
imported in a process of its own (two versions never share a process), its
kernels are built at first use, and every case below runs 10 times after one
warm-up call, timed with CUDA events (the median is kept). One JSON line per
tree: the tree, the card's name and power limit, and ms per case. Given in the
order parent, change, change, parent, the trees compare two versions in one
call on one card. The cases are the attention forward and backward calls of
the generation and train paths at full width (batch 2 and 10), with and
without the gradient of a mask's bias, ``fused_attention`` and the temporal
pair at the train scale; the inputs are random from a seed, and the line also
gives a digest of each case's output bits (``digest``). ``--cases attention_f32``
times the f32 attention kernels (f32 operands) at the shapes of the f32
generation forward and train step: the forward at (2,4608,320)x2304,
(2,4,2304,320)x[2304|2304] and (10,4,...) with lse, the backward at
(10,2,2304,320)x2304 and (10,4,...) with and without dbias, and the
head-major pair at (10,8,2304,40)x4608; beside each, as ``library_ms``, one
scaled_dot_product_attention call on the same f32 tensors (autograd through
it for a backward, a mask that asks for a gradient for dbias), and a digest
of each case's output bits. ``--cases ff_ln`` times ``ff_ln``
instead, at the generation and train shapes of levels 0 and 1 (T = 27648 /
6912 and 138240 / 34560 at C = 320 / 640), and beside each case, as
``composed_ms``, the cuBLAS composition layer_norm -> F.linear -> h gelu(g) ->
F.linear + x on the same inputs: a reference only, which the port never calls.
``--cases ff_ln_bwd`` times ``ff_ln_bwd`` at the train shapes of levels 0
and 1 (T = 138240 / 34560 at C = 320 / 640), and as ``composed_ms`` the
gradient with respect to x (``torch.autograd.grad``) of that composition,
its forward included, as the kernel recomputes the forward. For both, the
line also gives a digest of the kernel's output bits (``digest``) at each
timed shape and at T = 1, 37 and 130 for C = 320 and 640, so that two
versions can be held to the same bits. ``--cases ff_f32`` and ``--cases
ff_bwd_f32`` do the same on f32 operands (the f32 kernels ``ff_ln_f32`` /
``ff_ln_bwd_f32``), with the composition in f32 and cuBLAS's TF32 off, and
digests at the same shapes. ``--cases conv3x3`` times
``conv3x3_gn_silu`` at the shapes of a UNet forward's level-0 convolutions
(chip_smoke.py's conv cases: N = 12 images for one clip's guidance pair, 24
for a two-clip dispatch; Cin = 320 with stats and temb, without either, the
skip half with a zero bias, Cin = 640 with temb), with the cuDNN composition
silu(x * scale + shift) in bf16 -> F.conv2d on channels-last views -> + bias +
temb (and the stats sums) as ``composed_ms``, and a digest of each case's
output (and stats) bits. ``--cases geglu_out`` times ``geglu_out`` at the
row counts of its launches (I = 5120, C = 1280: T = 1728 and 480 for one
clip's guidance pair at level 2 and the mid block, 3456 for a two-clip
dispatch, 8640 and 2400 for the train step at batch 10), with the cuBLAS
composition F.linear(h * F.gelu(g), W, b) as ``composed_ms``, the bytes the
kernel's blocks copy from L2 (``l2_bytes``, from the tiling, where the tree
has ``geglu.geglu_out_l2_read_bytes``) and a digest of the output bits at
the timed shapes and at T = 1, 37 and 130. ``--cases temporal`` times the
temporal pair (forward and backward) in bf16 and in f32 at the train step's
levels 0-2 ((10, 6, 2304, 320), (10, 6, 576, 640), (10, 6, 144, 1280), H = 8)
and digests both at those shapes and at lengths 1, 37, 130 of each width,
F = 1 and F = 8. ``--cases geglu_out_bwd`` times ``geglu_out_bwd`` at the
train step's T = 8640 and 2400 (I = 5120, C = 1280), with the cuBLAS
composition g @ W -> the gate's backward in eager ops as ``composed_ms``, and
digests its output at those and at T = 1, 37, 130. ``--cases geglu_f32``
times the f32 pair on f32 operands: ``geglu_out`` at the forward's row
counts and ``geglu_out_bwd`` at the train step's, each with its composition
in f32 (cuBLAS's TF32 off) as ``composed_ms`` and digests at those shapes
and at T = 1, 37, 130. ``--cases int8`` times ``int8_dense`` at the five
layers of the hidden=10000 semantic MLP (chip_smoke.py's four shapes: the
first layer, a middle one at 100 rows and at one row, the out layer), with a
dequantize to bf16 and one ``F.linear`` as ``library_ms``, the bytes of x its
blocks read from L2 (``l2_bytes``, where the tree has ``int8_dense.plan``),
and digests of the output bits at those
shapes and at 7, 113 and 200 rows.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys


def _cases(torch, attention, temporal=None):
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    heads, cases = 8, {}

    def packed(label, q, k0, v0, k1=None, v1=None, bias=False):
        b0 = None
        if bias:
            b0 = 0.5 * torch.randn(k0.shape[0], 1, k0.shape[1], generator=g, device="cuda")
            b0[:, :, ::9] = -1e4
        out, lse = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0,
                                                 return_lse=True)
        dout = r(*q.shape)
        if not bias:
            cases[f"fwd {label}"] = lambda: attention.flash_attention_fwd(
                q, k0, v0, heads, k1=k1, v1=v1)
            cases[f"fwd {label} +lse"] = lambda: attention.flash_attention_fwd(
                q, k0, v0, heads, k1=k1, v1=v1, return_lse=True)
        cases[f"bwd {label}{' +dbias' if bias else ''}"] = lambda: attention.flash_attention_bwd(
            q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1, bias0=b0, need_dbias=bias)

    for b in (2, 10):
        packed(f"self ({b},2,2304,320)x2304", r(b, 2, 2304, 320), r(b, 2304, 320),
               r(b, 2304, 320))
        packed(f"dual ({b},4,2304,320)x[2304|2304]", r(b, 4, 2304, 320), r(b, 2304, 320),
               r(b, 2304, 320), r(b, 4, 2304, 320), r(b, 4, 2304, 320))
    packed("self (10,2,2304,320)x2304", r(10, 2, 2304, 320), r(10, 2304, 320), r(10, 2304, 320),
           bias=True)
    packed("dual (10,4,2304,320)x[2304|2304]", r(10, 4, 2304, 320), r(10, 2304, 320),
           r(10, 2304, 320), r(10, 4, 2304, 320), r(10, 4, 2304, 320), bias=True)
    packed("dual D=80 (10,4,576,640)x[576|576]", r(10, 4, 576, 640), r(10, 576, 640),
           r(10, 576, 640), r(10, 4, 576, 640), r(10, 4, 576, 640))
    packed("dual D=160 (10,4,144,1280)x[144|144]", r(10, 4, 144, 1280), r(10, 144, 1280),
           r(10, 144, 1280), r(10, 4, 144, 1280), r(10, 4, 144, 1280))
    packed("dual D=160 (10,4,40,1280)x[40|40]", r(10, 4, 40, 1280), r(10, 40, 1280),
           r(10, 40, 1280), r(10, 4, 40, 1280), r(10, 4, 40, 1280))
    packed("cross (2,13824,320)x77", r(2, 13824, 320), r(2, 77, 320), r(2, 77, 320))

    q, k, v, dout = r(10, 8, 2304, 40), r(10, 8, 4608, 40), r(10, 8, 4608, 40), \
        r(10, 8, 2304, 40)
    out, lse = attention.fused_attention_fwd(q, k, v, return_lse=True)
    cases["fwd fused (10,8,2304,40)x4608 +lse"] = lambda: attention.fused_attention_fwd(
        q, k, v, return_lse=True)
    cases["bwd fused (10,8,2304,40)x4608"] = lambda: attention.fused_attention_bwd(
        q, k, v, dout, out, lse)
    if temporal is not None:  # the frame-axis pair at the train step's level-0 shape
        tq, tk, tv, tdo = (r(10, 6, 2304, 320) for _ in range(4))
        cases["temporal fwd (10,6,2304,320)"] = lambda: temporal.temporal_attention_fwd(
            tq, tk, tv, heads)
        cases["temporal bwd (10,6,2304,320)"] = lambda: temporal.temporal_attention_bwd(
            tq, tk, tv, tdo, heads)
    return cases


def sdpa_views(torch, q, k0, v0, k1, v1, heads):
    """(n, H, L, D) views of packed operands for one scaled_dot_product_attention
    call: K0 / V0 repeated per frame, K1 / V1 concatenated after them."""
    hd = q.shape[-1]
    m = q.shape[1] if q.dim() == 4 else 1
    q3 = q.flatten(0, 1) if q.dim() == 4 else q
    kk, vv = k0.repeat_interleave(m, dim=0), v0.repeat_interleave(m, dim=0)
    if k1 is not None:
        kk = torch.cat([kk, k1.flatten(0, 1)], dim=1)
        vv = torch.cat([vv, v1.flatten(0, 1)], dim=1)
    split = lambda t: t.unflatten(-1, (heads, hd // heads)).transpose(1, 2)  # noqa: E731
    return split(q3), split(kk), split(vv)


def _f32_cases(torch, attention):
    """{label: (kernel call, SDPA f32 call)} of the f32 attention kernels at the
    shapes of the f32 generation forward and train step (chip_smoke.py's f32
    rows): the library call is one scaled_dot_product_attention on the same
    f32 tensors (autograd through it for a backward, its forward outside the
    timed call; a mask that asks for a gradient for dbias)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    heads, cases = 8, {}

    def fwd(label, q, k0, v0, k1=None, v1=None, lse=False):
        qh, kh, vh = sdpa_views(torch, q, k0, v0, k1, v1, heads)
        cases[f"fwd {label}{' +lse' if lse else ''}"] = (
            lambda: attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1,
                                                  return_lse=lse),
            lambda: F.scaled_dot_product_attention(qh, kh, vh))

    def bwd(label, q, k0, v0, k1=None, v1=None, bias=False):
        b0 = None
        if bias:
            b0 = 0.5 * torch.randn(k0.shape[0], 1, k0.shape[1], generator=g, device="cuda")
            b0[:, :, ::9] = -1e4
        out, lse = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=b0,
                                                 return_lse=True)
        dout = r(*q.shape)
        leaves = [t.detach().requires_grad_()
                  for t in sdpa_views(torch, q, k0, v0, k1, v1, heads)]
        wrt, full = leaves, None
        if bias:  # the mask asks for a gradient; segment 1's keys take 0
            mask = b0.clone().requires_grad_()
            m = q.shape[1] if q.dim() == 4 else 1
            full = F.pad(mask.repeat_interleave(m, dim=0)[:, None],
                         (0, leaves[1].shape[2] - k0.shape[1]))
            wrt = leaves + [mask]
        sd_out = F.scaled_dot_product_attention(*leaves, attn_mask=full)
        hd = q.shape[-1]
        doh = (dout.reshape(-1, dout.shape[-2], hd).unflatten(-1, (heads, hd // heads))
               .transpose(1, 2))
        cases[f"bwd {label}{' +dbias' if bias else ''}"] = (
            lambda: attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                                  bias0=b0, need_dbias=bias),
            lambda: torch.autograd.grad(sd_out, wrt, doh, retain_graph=True))

    fwd("self (2,4608,320)x2304", r(2, 4608, 320), r(2, 2304, 320), r(2, 2304, 320))
    fwd("dual (2,4,2304,320)x[2304|2304]", r(2, 4, 2304, 320), r(2, 2304, 320), r(2, 2304, 320),
        r(2, 4, 2304, 320), r(2, 4, 2304, 320))
    fwd("dual (10,4,2304,320)x[2304|2304]", r(10, 4, 2304, 320), r(10, 2304, 320),
        r(10, 2304, 320), r(10, 4, 2304, 320), r(10, 4, 2304, 320), lse=True)
    bwd("self (10,2,2304,320)x2304", r(10, 2, 2304, 320), r(10, 2304, 320), r(10, 2304, 320))
    bwd("dual (10,4,2304,320)x[2304|2304]", r(10, 4, 2304, 320), r(10, 2304, 320),
        r(10, 2304, 320), r(10, 4, 2304, 320), r(10, 4, 2304, 320))
    bwd("dual (10,4,2304,320)x[2304|2304]", r(10, 4, 2304, 320), r(10, 2304, 320),
        r(10, 2304, 320), r(10, 4, 2304, 320), r(10, 4, 2304, 320), bias=True)
    q, k, v, dout = r(10, 8, 2304, 40), r(10, 8, 4608, 40), r(10, 8, 4608, 40), r(10, 8, 2304, 40)
    out, lse = attention.fused_attention_fwd(q, k, v, return_lse=True)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sd_out = F.scaled_dot_product_attention(*leaves)
    cases["fwd fused (10,8,2304,40)x4608 +lse"] = (
        lambda: attention.fused_attention_fwd(q, k, v, return_lse=True),
        lambda: F.scaled_dot_product_attention(q, k, v))
    cases["bwd fused (10,8,2304,40)x4608"] = (
        lambda: attention.fused_attention_bwd(q, k, v, dout, out, lse),
        lambda: torch.autograd.grad(sd_out, leaves, dout, retain_graph=True))
    return cases


# row counts that end inside a block, whose outputs are compared bit for bit only
_FF_EDGES = ((1, 320), (37, 320), (130, 320), (1, 640), (37, 640), (130, 640))


def _ff_cases(torch, geglu, shapes=((27648, 320), (6912, 640), (138240, 320), (34560, 640)),
              dtype=None):
    """{label: (ff_ln call, composed cuBLAS call)} on the inputs chip_smoke.py
    uses, bf16 operands (or ``dtype``'s)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    dtype = dtype or torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    cases = {}
    for t, c in shapes:
        i = 4 * c
        args = [r(t, c), 1.0 + 0.05 * r(c).float(), 0.02 * r(c).float(),
                r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i).float(),
                r(c, i, scale=i ** -0.5), 0.02 * r(c).float()]
        x, gamma, beta, wp, bp, wo, bo = args
        vb = [v.to(dtype) for v in (gamma, beta, bp, bo)]

        def composed(x=x, wp=wp, wo=wo, vb=vb, c=c):
            h, gate = F.linear(F.layer_norm(x, (c,), vb[0], vb[1]), wp, vb[2]).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), wo, vb[3]) + x

        cases[f"ff_ln T={t} C={c}"] = (lambda a=args: geglu.ff_ln(*a), composed)
    return cases


def _ff_bwd_cases(torch, geglu, shapes=((138240, 320), (34560, 640)), dtype=None):
    """{label: (ff_ln_bwd call, autograd through the composed cuBLAS forward)}
    on the inputs chip_smoke.py uses, bf16 operands (or ``dtype``'s)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    dtype = dtype or torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    cases = {}
    for t, c in shapes:
        i = 4 * c
        args = [r(t, c), r(t, c), 1.0 + 0.05 * r(c).float(), 0.02 * r(c).float(),
                r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i).float(),
                r(c, i, scale=i ** -0.5)]
        x, dout, gamma, beta, wp, bp, wo = args
        vb = [v.to(dtype) for v in (gamma, beta, bp)]
        bo = torch.zeros(c, dtype=dtype, device="cuda")

        def composed(x=x, dout=dout, wp=wp, wo=wo, vb=vb, bo=bo, c=c):
            xl = x.detach().requires_grad_()
            h, gate = F.linear(F.layer_norm(xl, (c,), vb[0], vb[1]), wp, vb[2]).chunk(2, dim=-1)
            out = F.linear(h * F.gelu(gate), wo, bo) + xl
            return torch.autograd.grad(out, xl, dout)

        cases[f"ff_ln_bwd T={t} C={c}"] = (lambda a=args: geglu.ff_ln_bwd(*a), composed)
    return cases


# (label, N, Cin, stats, temb, zero bias) of the level-0 convolutions of a UNet forward
CONV_SHAPES = (("Cin=320 (12,36,64) +stats +temb", 12, 320, True, True, False),
               ("Cin=320 (12,36,64)", 12, 320, False, False, False),
               ("Cin=320 (12,36,64) skip half, zero bias", 12, 320, False, False, True),
               ("Cin=640 (12,36,64) +temb", 12, 640, False, True, False),
               ("Cin=320 (24,36,64) +stats +temb", 24, 320, True, True, False))


def conv_composed(torch, args, stats):
    """The cuDNN composition of ``conv3x3_gn_silu`` on its arguments: silu(x *
    scale + shift) in bf16 -> F.conv2d on channels-last views -> + bias + temb
    (-> the stats sums). A yardstick only, which the port never calls."""
    import torch.nn.functional as F

    x, w, b, scale, shift, tb = args
    w_cl = w.contiguous(memory_format=torch.channels_last)
    bt = b[None, None, None, :] + (0 if tb is None else tb[:, None, None, :])
    sc, sh = scale[:, None, None, :], shift[:, None, None, :]

    def composed():
        a = F.silu(x.float() * sc + sh).bfloat16()
        o = F.conv2d(a.permute(0, 3, 1, 2), w_cl, None, padding=1).permute(0, 2, 3, 1)
        o = (o.float() + bt).bfloat16()
        if not stats:
            return o
        of = o.float()
        return o, torch.stack([of.sum(dim=(1, 2)), (of * of).sum(dim=(1, 2))], dim=1)

    return composed


def conv_args(torch, r, g, n, cin, temb, zero_bias=False, dev="cuda"):
    """Inputs of a level-0 convolution: (n, 36, 64, cin) -> 320 channels;
    ``r(*shape, scale=)`` draws bf16 normals from the generator ``g``."""
    return [r(n, 36, 64, cin), r(320, cin, 3, 3, scale=(9 * cin) ** -0.5),
            torch.zeros(320, device=dev) if zero_bias else 0.02 * r(320).float(),
            torch.rand(n, cin, generator=g, device=dev) + 0.5,
            torch.randn(n, cin, generator=g, device=dev) * 0.5,
            torch.randn(n, 320, generator=g, device=dev) if temb else None]


def conv_cases(torch, dev="cuda", shapes=CONV_SHAPES):
    """[(label, args, stats)] of the level-0 convolutions, from a seed."""
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()

    return [(label, conv_args(torch, r, g, n, cin, temb, zero_bias, dev), stats)
            for label, n, cin, stats, temb, zero_bias in shapes]


# row counts of the geglu_out launches (generation: level 2 and the mid
# block of one clip's guidance pair, a two-clip dispatch; the train step),
# and rows that end inside a block, compared bit for bit only
GEGLU_SHAPES = (1728, 480, 3456, 8640, 2400)
GEGLU_EDGES = (1, 37, 130)


def geglu_args(r, t):
    """Inputs of a geglu_out call at I = 5120, C = 1280 (chip_smoke.py's);
    ``r(*shape, scale=)`` draws bf16 normals."""
    return [r(t, 10240), r(1280, 5120, scale=5120 ** -0.5), 0.02 * r(1280).float()]


def geglu_composed(args):
    """The cuBLAS composition of ``geglu_out``: F.linear(h * F.gelu(g), W, b)
    in the operands' dtype (bf16, or f32). A yardstick only, which the port
    never calls."""
    import torch.nn.functional as F

    h2, w, b = args
    h, g = h2.chunk(2, dim=-1)
    bb = b.to(h2.dtype)
    return lambda: F.linear(h * F.gelu(g), w, bb)


def _geglu_cases(torch, shapes, dtype=None):
    """{label: args} of geglu_out, from a seed (bf16 unless ``dtype``)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dtype = dtype or torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    return {f"T={t} I=5120 C=1280": geglu_args(r, t) for t in shapes}


# the temporal pair at the train step's levels 0-2 (batch 10, 6 frames, H = 8:
# D = 40, 80, 160), and edges: lengths that end inside a backward run at each
# width, and F = 1 and F = 8, compared bit for bit only
TEMPORAL_SHAPES = ((10, 6, 2304, 320), (10, 6, 576, 640), (10, 6, 144, 1280))
TEMPORAL_EDGES = (*((2, 6, l, hd) for hd in (320, 640, 1280) for l in (1, 37, 130)),
                  (2, 1, 37, 320), (1, 8, 130, 1280))


def _temporal_cases(torch, temporal, shapes, dtype):
    """{label: (forward call, backward call)} of the temporal pair, from a seed."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for shape in shapes:
        q, k, v, dout = (torch.randn(*shape, generator=g, device="cuda").to(dtype)
                         for _ in range(4))
        cases[f"{tuple(shape)} {str(dtype).split('.')[-1]}"] = (
            lambda q=q, k=k, v=v: temporal.temporal_attention_fwd(q, k, v, 8),
            lambda q=q, k=k, v=v, d=dout: temporal.temporal_attention_bwd(q, k, v, d, 8))
    return cases


def geglu_bwd_composed(args):
    """The cuBLAS composition of ``geglu_out_bwd``: dgated = g @ W, then the
    gate's backward in eager ops, in the operands' dtype. A yardstick only,
    which the port never calls."""
    import torch
    import torch.nn.functional as F

    h2, g, w = args
    h, gate = h2.chunk(2, dim=-1)

    def run():
        dgated = g @ w
        return torch.cat([dgated * F.gelu(gate),
                          torch.ops.aten.gelu_backward(dgated * h, gate)], dim=-1)
    return run


# row counts of the geglu_out_bwd launches of a train step (level 2, the mid
# block), and rows that end inside a tile, compared bit for bit only
GEGLU_BWD_SHAPES = (8640, 2400)
GEGLU_BWD_EDGES = (1, 37, 130)


def _geglu_bwd_cases(torch, shapes, dtype=None):
    """{label: (h2, g, w)} of geglu_out_bwd at I = 5120, C = 1280, from a seed
    (bf16 unless ``dtype``)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dtype = dtype or torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    return {f"T={t} I=5120 C=1280": [r(t, 10240), r(t, 1280), r(1280, 5120, scale=5120 ** -0.5)]
            for t in shapes}


# (label, rows, K, N) of int8_dense: the semantic MLP's first layer, a middle
# layer at the serving chunk's 100 rows and at one row, the out layer
INT8_SHAPES = (("fc0 M=100 (310->10000)", 100, 310, 10000),
               ("fc1-3 M=100 (10000->10000)", 100, 10000, 10000),
               ("fc1-3 M=1 (10000->10000)", 1, 10000, 10000),
               ("out M=100 (10000->59136)", 100, 10000, 77 * 768))
INT8_EDGES = (("M=7 (10000->10000)", 7, 10000, 10000),
              ("M=113 (10000->10000)", 113, 10000, 10000),
              ("M=200 (10000->10000)", 200, 10000, 10000),
              ("M=7 (10000->59136)", 7, 10000, 77 * 768))


def _int8_cases(torch, int8_dense, shapes):
    """{label: (x, w_q, scale, bias, n)}: random weights from a seed, quantized
    by the tree's own quantize_int8, ReLU'd activations as the MLP feeds them."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for label, m, k, n in shapes:
        w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        w_q, scale = int8_dense.quantize_int8(w)
        del w
        bias = 0.1 * torch.randn(n, generator=g, device="cuda")
        x = torch.randn(m, k, generator=g, device="cuda").relu()
        cases[label] = (x, w_q, scale, bias, n)
    return cases


def int8_library(args):
    """A dequantize to bf16 and one F.linear (cuBLAS) with the same scale and
    bias epilogue: a yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    x, w_q, scale, bias, n = args
    kp = w_q.shape[0]

    def run():
        y = F.linear(F.pad(x, (0, kp - x.shape[1])).bfloat16(), w_q.to(torch.bfloat16).t())
        return y[:, :n].float() * scale[:n] + bias
    return run


def _digest(torch, *outs):
    """The first 16 hex digits of the sha256 of the tensors' bits."""
    h = hashlib.sha256()
    for out in outs:
        h.update(out.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# device cycles (about 5 ms) spun ahead of each timed run: the device is busy
# while the host enqueues the run, so the events time the device's work, not
# the host's Python and launch overhead (which sets the reading of a call that
# takes the device less time than the host takes to enqueue it)
PAD_CYCLES = 10_000_000


def _time(torch, fn, reps=10):
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PAD_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _one(tree, which="attention"):
    import torch

    from eeg2video_tpu_torch.ops import _build, attention, conv2d, geglu, temporal

    if not torch.cuda.is_available():
        sys.exit("attention_ab: no GPU")
    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    line = {"tree": tree, "package": os.path.dirname(attention.__file__),
            "device": torch.cuda.get_device_name(0), "smi": smi[0] if smi else None}
    if which == "conv3x3":
        cases = conv_cases(torch)
        run = {label: (lambda a=args, st=stats: conv2d.conv3x3_gn_silu(*a, with_stats=st))
               for label, args, stats in cases}
        line["ms"] = {label: _time(torch, fn) for label, fn in run.items()}
        line["composed_ms"] = {label: _time(torch, conv_composed(torch, args, stats))
                               for label, args, stats in cases}
        line["digest"] = {label: _digest(torch, *_as_tuple(fn())) for label, fn in run.items()}
    elif which == "geglu_out":
        cases = _geglu_cases(torch, GEGLU_SHAPES)
        line["ms"] = {label: _time(torch, lambda a=args: geglu.geglu_out(*a))
                      for label, args in cases.items()}
        line["composed_ms"] = {label: _time(torch, geglu_composed(args))
                               for label, args in cases.items()}
        l2 = getattr(geglu, "geglu_out_l2_read_bytes", None)
        if l2 is not None:
            line["l2_bytes"] = {f"T={t} I=5120 C=1280": l2(t, 5120, 1280) for t in GEGLU_SHAPES}
        every = {**cases, **_geglu_cases(torch, GEGLU_EDGES)}
        line["digest"] = {label: _digest(torch, geglu.geglu_out(*args))
                          for label, args in every.items()}
    elif which == "temporal":
        cases, every = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            cases.update(_temporal_cases(torch, temporal, TEMPORAL_SHAPES, dtype))
            every.update(_temporal_cases(torch, temporal, TEMPORAL_EDGES, dtype))
        every.update(cases)
        line["ms"] = {f"{way} {label}": _time(torch, fns[i]) for label, fns in cases.items()
                      for i, way in enumerate(("fwd", "bwd"))}
        line["digest"] = {f"{way} {label}": _digest(torch, *_as_tuple(fns[i]()))
                          for label, fns in every.items() for i, way in enumerate(("fwd", "bwd"))}
    elif which == "geglu_out_bwd":
        cases = _geglu_bwd_cases(torch, GEGLU_BWD_SHAPES)
        line["ms"] = {label: _time(torch, lambda a=args: geglu.geglu_out_bwd(*a))
                      for label, args in cases.items()}
        line["composed_ms"] = {label: _time(torch, geglu_bwd_composed(args))
                               for label, args in cases.items()}
        every = {**cases, **_geglu_bwd_cases(torch, GEGLU_BWD_EDGES)}
        line["digest"] = {label: _digest(torch, geglu.geglu_out_bwd(*args))
                          for label, args in every.items()}
    elif which == "geglu_f32":
        torch.backends.cuda.matmul.allow_tf32 = False  # the f32 composition in full f32
        f32 = torch.float32
        fwd, bwd = _geglu_cases(torch, GEGLU_SHAPES, f32), _geglu_bwd_cases(
            torch, GEGLU_BWD_SHAPES, f32)
        run = {**{f"fwd {k}": (lambda a=a: geglu.geglu_out(*a), geglu_composed(a))
                  for k, a in fwd.items()},
               **{f"bwd {k}": (lambda a=a: geglu.geglu_out_bwd(*a), geglu_bwd_composed(a))
                  for k, a in bwd.items()}}
        line["ms"] = {label: _time(torch, fn) for label, (fn, _) in run.items()}
        line["composed_ms"] = {label: _time(torch, ref) for label, (_, ref) in run.items()}
        every = {**{f"fwd {k}": lambda a=a: geglu.geglu_out(*a) for k, a in
                    {**fwd, **_geglu_cases(torch, GEGLU_EDGES, f32)}.items()},
                 **{f"bwd {k}": lambda a=a: geglu.geglu_out_bwd(*a) for k, a in
                    {**bwd, **_geglu_bwd_cases(torch, GEGLU_BWD_EDGES, f32)}.items()}}
        line["digest"] = {label: _digest(torch, fn()) for label, fn in every.items()}
    elif which in ("ff_ln", "ff_ln_bwd", "ff_f32", "ff_bwd_f32"):
        make = _ff_cases if which in ("ff_ln", "ff_f32") else _ff_bwd_cases
        dtype = torch.float32 if which.endswith("f32") else torch.bfloat16
        torch.backends.cuda.matmul.allow_tf32 = False  # the f32 composition in full f32
        cases = make(torch, geglu, dtype=dtype)
        line["ms"] = {label: _time(torch, fn) for label, (fn, _) in cases.items()}
        line["composed_ms"] = {label: _time(torch, ref) for label, (_, ref) in cases.items()}
        # the output's bits at the timed shapes and at row counts that end inside a block
        every = {**cases, **make(torch, geglu, _FF_EDGES, dtype=dtype)}
        line["digest"] = {label: _digest(torch, fn()) for label, (fn, _) in every.items()}
    elif which == "int8":
        from eeg2video_tpu_torch.ops import int8_dense

        cases = _int8_cases(torch, int8_dense, INT8_SHAPES)
        line["ms"] = {label: _time(torch, lambda a=args: int8_dense.int8_dense(*a))
                      for label, args in cases.items()}
        line["library_ms"] = {label: _time(torch, int8_library(args))
                              for label, args in cases.items()}
        plan = getattr(int8_dense, "plan", None)
        if plan is not None:
            line["l2_bytes"] = {label: plan(m, -(-k // 32) * 32, -(-n // 512) * 512)["x_l2_bytes"]
                                for label, m, k, n in INT8_SHAPES}
        digests = {label: _digest(torch, int8_dense.int8_dense(*args))
                   for label, args in cases.items()}
        del cases
        edges = _int8_cases(torch, int8_dense, INT8_EDGES)
        digests.update({label: _digest(torch, int8_dense.int8_dense(*args))
                        for label, args in edges.items()})
        line["digest"] = digests
    elif which == "attention_f32":
        cases = _f32_cases(torch, attention)
        line["ms"] = {label: _time(torch, fn) for label, (fn, _) in cases.items()}
        line["library_ms"] = {label: _time(torch, ref) for label, (_, ref) in cases.items()}
        line["digest"] = {label: _digest(torch, *(t for t in _as_tuple(fn()) if t is not None))
                          for label, (fn, _) in cases.items()}
    else:
        cases = _cases(torch, attention, temporal)
        line["ms"] = {label: _time(torch, fn) for label, fn in cases.items()}
        line["digest"] = {label: _digest(torch, *(t for t in _as_tuple(fn()) if t is not None))
                          for label, fn in cases.items()}
    print(json.dumps(line), flush=True)


def _as_tuple(res):
    return tuple(res) if isinstance(res, (tuple, list)) else (res,)


# a child process: the tree's package first on the path, this file's
# functions loaded by path (the other tree may not have this module)
_CHILD = """
import importlib.util, sys
tree, path, which = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("attention_ab_child", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._one(tree, which)
"""


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True,
                        help="root of a checkout (repeat: one process each, in order)")
    parser.add_argument("--cases",
                        choices=("attention", "attention_f32", "ff_ln", "ff_ln_bwd", "ff_f32",
                                 "ff_bwd_f32", "conv3x3", "geglu_out", "temporal",
                                 "geglu_out_bwd", "geglu_f32", "int8"),
                        default="attention",
                        help="the kernels to time (default: the attention cases)")
    args = parser.parse_args(argv)
    rc = 0
    for tree in args.tree:
        rc |= subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(tree),
                              os.path.abspath(__file__), args.cases]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
