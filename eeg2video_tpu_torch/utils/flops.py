"""Analytic matmul-FLOP counting for the diffusion stack, to report MFU
against the card's bf16 peak.

Counterpart of ``eeg2video_tpu/utils/flops.py`` (:22-231), the same walk with
the NVIDIA H100's peak. Convention: standard MFU accounting,
multiply-accumulate = 2 FLOPs, only matmul-class ops counted (convs, dense
layers, attention GEMMs); norms, softmax and elementwise ops are excluded.
The walk mirrors models/unet3d.py + models/unet_blocks.py structurally
(reference EEG2Video_New/Generation/models/unet.py:80-207), so the channel
and skip bookkeeping cannot drift from the model.
"""

from __future__ import annotations

import math
from typing import Dict

H100_BF16_PEAK = 989e12  # H100 SXM, dense bf16 on the tensor cores (NVIDIA data sheet)


def _conv(b, h, w, cin, cout, k=3):
    return 2 * b * h * w * cin * cout * k * k


def _dense(tokens, cin, cout):
    return 2 * tokens * cin * cout


def _attn_gemms(batch, lq, lkv, inner):
    """QK^T + PV, summed over heads: head_dim * heads = inner."""
    return 2 * 2 * batch * lq * lkv * inner


def _resnet(b, h, w, cin, cout, temb_dim, acc):
    acc["conv"] += _conv(b, h, w, cin, cout) + _conv(b, h, w, cout, cout)
    acc["dense"] += _dense(b, temb_dim, cout)
    if cin != cout:
        acc["conv"] += _conv(b, h, w, cin, cout, k=1)


def _transformer3d(B, F, h, w, ch, ctx_len, ctx_dim, acc):
    """Transformer3DModel: proj_in/out 1x1 + one BasicTransformerBlock
    (attn1 sparse-causal / attn2 cross / GEGLU FF / attn_temp)."""
    L = h * w
    bf = B * F
    acc["conv"] += 2 * _conv(bf, h, w, ch, ch, k=1)  # proj_in + proj_out
    # attn1: q/k/v/out projections over all tokens
    acc["dense"] += 4 * _dense(bf * L, ch, ch)
    # sparse-causal attention: frames 0-1 attend frame 0 (Lkv=L; the
    # reference's [f0, f0] concat is softmax-equivalent to one copy —
    # attention3d.py dedups it), frames 2..F-1 attend [f0, f_prev] (2L)
    n_long = max(F - 2, 0)
    n_short = min(F, 2)
    acc["attn"] += _attn_gemms(B * n_short, L, L, ch)
    acc["attn"] += _attn_gemms(B * n_long, L, 2 * L, ch)
    # attn2 cross: q/out on tokens, k/v on per-frame-repeated context
    acc["dense"] += 2 * _dense(bf * L, ch, ch)
    acc["dense"] += 2 * _dense(bf * ctx_len, ctx_dim, ch)
    acc["attn"] += _attn_gemms(bf, L, ctx_len, ch)
    # GEGLU FF: ch -> 2*4ch, 4ch -> ch
    acc["dense"] += _dense(bf * L, ch, 8 * ch) + _dense(bf * L, 4 * ch, ch)
    # attn_temp: frame-axis attention, batch B*L, seq F
    acc["dense"] += 4 * _dense(bf * L, ch, ch)
    acc["attn"] += _attn_gemms(B * L, F, F, ch)


def unet3d_forward_flops(cfg, batch, frames, h, w,
                         ctx_len=77) -> Dict[str, float]:
    """Matmul FLOPs of one UNet3DConditionModel forward at (batch, frames,
    h, w) latents.  Returns a breakdown {conv, dense, attn, total} plus
    per-level subtotals keyed 'level_hw<h*w>' (used by the remat model)."""
    boc = cfg.block_out_channels
    temb_dim = boc[0] * 4
    bf = batch * frames
    acc = {"conv": 0.0, "dense": 0.0, "attn": 0.0}
    by_hw: Dict[int, float] = {}

    def tracked(fn, hw_key):
        before = dict(acc)
        fn()
        gained = sum(acc.values()) - sum(before.values())
        by_hw[hw_key] = by_hw.get(hw_key, 0.0) + gained

    acc["dense"] += _dense(batch, boc[0], temb_dim) + _dense(batch, temb_dim, temb_dim)
    acc["conv"] += _conv(bf, h, w, cfg.in_channels, boc[0])

    n = len(boc)
    sizes = [(h, w)]
    skips = [boc[0]]
    ch_in = boc[0]
    hh, ww = h, w
    for i, ch in enumerate(boc):
        final = i == n - 1

        def down_level(i=i, ch=ch, ch_in=ch_in, hh=hh, ww=ww, final=final):
            cin = ch_in
            for _ in range(cfg.layers_per_block):
                _resnet(bf, hh, ww, cin, ch, temb_dim, acc)
                cin = ch
                if not final:
                    _transformer3d(batch, frames, hh, ww, ch, ctx_len,
                                   cfg.cross_attention_dim, acc)
                skips.append(ch)
            if not final:
                h2, w2 = math.ceil(hh / 2), math.ceil(ww / 2)
                acc["conv"] += _conv(bf, h2, w2, ch, ch)  # stride-2 downsample
                skips.append(ch)

        tracked(down_level, hh * ww)
        ch_in = ch
        if not final:
            hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
            sizes.append((hh, ww))

    def mid():
        _resnet(bf, hh, ww, boc[-1], boc[-1], temb_dim, acc)
        _transformer3d(batch, frames, hh, ww, boc[-1], ctx_len,
                       cfg.cross_attention_dim, acc)
        _resnet(bf, hh, ww, boc[-1], boc[-1], temb_dim, acc)

    tracked(mid, hh * ww)

    rev = list(reversed(boc))
    x_ch = boc[-1]
    for i, ch in enumerate(rev):
        final = i == n - 1
        hw = sizes[n - 1 - i]

        def up_level(i=i, ch=ch, x_ch=x_ch, hw=hw, final=final):
            cin = x_ch
            for _ in range(cfg.layers_per_block + 1):
                skip = skips.pop()
                _resnet(bf, hw[0], hw[1], cin + skip, ch, temb_dim, acc)
                cin = ch
                if i > 0:
                    _transformer3d(batch, frames, hw[0], hw[1], ch, ctx_len,
                                   cfg.cross_attention_dim, acc)
            if not final:
                nh, nw = sizes[n - 2 - i]
                acc["conv"] += _conv(bf, nh, nw, ch, ch)  # post-upsample conv

        tracked(up_level, hw[0] * hw[1])
        x_ch = ch

    acc["conv"] += _conv(bf, h, w, boc[0], cfg.out_channels)
    out = dict(acc)
    out["total"] = sum(acc.values())
    for hw, v in by_hw.items():
        out[f"level_hw{hw}"] = v
    return out


def vae_decoder_flops(cfg, batch, h, w) -> float:
    """Matmul FLOPs of one AutoencoderKL.decode at (batch, h, w) latents
    (models/vae.py Decoder: conv_in, mid 2 resnets + attn, 4 up levels of
    layers_per_block+1 resnets, upsample convs, conv_out)."""
    boc = cfg.block_out_channels
    rev = list(reversed(boc))
    f = _conv(batch, h, w, cfg.latent_channels, cfg.latent_channels, k=1)  # post_quant
    f += _conv(batch, h, w, cfg.latent_channels, rev[0])
    # mid: 2 resnets + single-head attention at latent res
    for _ in range(2):
        f += 2 * _conv(batch, h, w, rev[0], rev[0])
    L = h * w
    f += 4 * _dense(batch * L, rev[0], rev[0]) + _attn_gemms(batch, L, L, rev[0])
    cin = rev[0]
    hh, ww = h, w
    for i, ch in enumerate(rev):
        for _ in range(cfg.layers_per_block + 1):
            f += _conv(batch, hh, ww, cin, ch) + _conv(batch, hh, ww, ch, ch)
            if cin != ch:
                f += _conv(batch, hh, ww, cin, ch, k=1)
            cin = ch
        if i < len(rev) - 1:
            hh, ww = hh * 2, ww * 2
            f += _conv(batch, hh, ww, ch, ch)  # post-upsample conv
    f += _conv(batch, hh, ww, rev[-1], cfg.sample_channels)
    return f


def generation_clip_flops(ucfg, vcfg, num_inference_steps=100, frames=6,
                          height=288, width=512) -> float:
    """One end-to-end clip at the reference config: num_inference_steps DDIM
    steps x CFG pair (batch 2 through the UNet, pipeline batches the pair,
    reference pipeline_tuneeeg2video.py:313) + VAE decode of each frame."""
    lh, lw = height // 8, width // 8
    unet = unet3d_forward_flops(ucfg, 2, frames, lh, lw)["total"]
    return num_inference_steps * unet + vae_decoder_flops(vcfg, frames, lh, lw)


def train_step_flops(ucfg, batch=10, frames=6, height=288, width=512,
                     remat_min_hw=256) -> float:
    """Matmul FLOPs of one fine-tune step (posteriors precomputed; the
    VAE encoder runs once per dataset, not per step).

    Model: forward + activation-gradient backward (~= forward for every
    conv/GEMM) + weight gradients ONLY for the trainable mask
    (attn1.to_q / attn2.to_q / attn_temp q,k,v,out: frozen weights take no
    gradient, so no dW GEMM runs for them) + flash-attention
    backward recompute (5 GEMMs vs the forward's 2) + remat recompute of
    the levels whose H*W >= remat_min_hw."""
    lh, lw = height // 8, width // 8
    fwd = unet3d_forward_flops(ucfg, batch, frames, lh, lw)
    total = fwd["total"]  # forward
    total += fwd["total"]  # dx backward, same GEMM count per layer
    total += 1.5 * fwd["attn"]  # flash bwd: 5 GEMMs = fwd(2) + dx(2) + 1.5x
    # dW for the trainable mask (per level it's a small slice of the dense
    # bucket); approximate with the exact per-layer dense flops:
    boc = ucfg.block_out_channels
    bf = batch * frames
    hh, ww = lh, lw
    dw = 0.0
    n = len(boc)
    for i, ch in enumerate(boc):  # down + mirrored up attention layers
        if i == n - 1:
            continue
        L = hh * ww
        per_attn_dw = (_dense(bf * L, ch, ch)      # attn1.to_q
                       + _dense(bf * L, ch, ch)    # attn2.to_q
                       + 4 * _dense(bf * L, ch, ch))  # attn_temp q/k/v/out
        n_attn = ucfg.layers_per_block + (ucfg.layers_per_block + 1)
        dw += n_attn * per_attn_dw
        hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
    dw += (_dense(bf * hh * ww, boc[-1], boc[-1]) * 6)  # mid block
    total += dw
    # remat: recompute the forward of every level with H*W >= threshold
    for k, v in fwd.items():
        if k.startswith("level_hw") and int(k[len("level_hw"):]) >= remat_min_hw:
            total += v
    return total


def mfu(flops: float, seconds: float, peak: float = H100_BF16_PEAK) -> float:
    return flops / seconds / peak
