"""The benchmark's frozen count of work: matrix FLOPs of the UNet and VAE
walks, the model FLOPs of a fine-tune step, and the operations and bytes of
each attention and feed-forward call from which a roofline's least time
follows.

Convention (standard MFU accounting): a multiply-add is 2 FLOPs and only
matrix-class work counts (convolutions, dense layers, the attention GEMMs);
norms, softmax and elementwise work do not. The walk follows the inflated
UNet of the configurations (``reference/unet3d.py``); at the 36x64 latents of
a 288x512 clip the levels are 36x64, 18x32, 9x16 and 5x8.

A step's model FLOPs are its forward, the backward for the activations (each
conv and dense layer again, each attention's four GEMMs, twice its forward;
the stem conv takes none) and the weight gradients of the trainable mask.
What the program recomputes (checkpointed blocks, the attention backward's
probabilities) is not model work and is not counted.

A call's least time is max(FLOPs / PEAK_FLOPS, bytes / PEAK_BYTES): each
operand read once and each result written once, in bf16 (lse rows in f32).
"""

from __future__ import annotations

import math

PEAK_FLOPS = 989e12   # H100 SXM dense bf16 tensor rate (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
BF16 = 2


def _conv(b, h, w, cin, cout, k=3):
    return 2 * b * h * w * cin * cout * k * k


def _dense(tokens, cin, cout):
    return 2 * tokens * cin * cout


def _attn_gemms(batch, lq, lkv, inner):
    return 2 * 2 * batch * lq * lkv * inner


def levels(cfg, h, w):
    """[(level, h, w, channels)] of the UNet's resolutions."""
    out = []
    for i, ch in enumerate(cfg["block_out_channels"]):
        out.append((i, h, w, ch))
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return out


def transformers(cfg, h, w):
    """[(h, w, channels, count)]: the transformer blocks at each resolution
    (per level ``layers_per_block`` down and ``layers_per_block + 1`` up, the
    mid block's one at the last level)."""
    lv = levels(cfg, h, w)
    n, layers = len(lv), cfg["layers_per_block"]
    out = [(hh, ww, ch, 2 * layers + 1) for i, hh, ww, ch in lv[:-1]]
    _, hh, ww, ch = lv[-1]
    out.append((hh, ww, ch, 1))
    return out


def _resnet(b, h, w, cin, cout, temb, acc):
    acc["conv"] += _conv(b, h, w, cin, cout) + _conv(b, h, w, cout, cout)
    acc["dense"] += _dense(b, temb, cout)
    if cin != cout:
        acc["conv"] += _conv(b, h, w, cin, cout, k=1)


def _transformer(b, f, h, w, ch, ctx_len, ctx_dim, acc):
    L, bf = h * w, b * f
    acc["conv"] += 2 * _conv(bf, h, w, ch, ch, k=1)
    acc["dense"] += 4 * _dense(bf * L, ch, ch)
    acc["attn"] += _attn_gemms(b * min(f, 2), L, L, ch)
    acc["attn"] += _attn_gemms(b * max(f - 2, 0), L, 2 * L, ch)
    acc["dense"] += 2 * _dense(bf * L, ch, ch) + 2 * _dense(bf * ctx_len, ctx_dim, ch)
    acc["attn"] += _attn_gemms(bf, L, ctx_len, ch)
    acc["dense"] += _dense(bf * L, ch, 8 * ch) + _dense(bf * L, 4 * ch, ch)
    acc["dense"] += 4 * _dense(bf * L, ch, ch)
    acc["attn"] += _attn_gemms(b * L, f, f, ch)


def unet_forward_flops(cfg, batch, frames, h, w, ctx_len=77):
    """{conv, dense, attn, stem, total} matrix FLOPs of one forward at (batch,
    frames, h, w) latents. The cross-attention's K/V projections count once a
    frame, as training runs them; inference runs them once a video, 0.5% of
    a forward less."""
    chs = list(cfg["block_out_channels"])
    n, layers, temb = len(chs), cfg["layers_per_block"], 4 * chs[0]
    ctx_dim, bf = cfg["cross_attention_dim"], batch * frames
    acc = {"conv": 0.0, "dense": 0.0, "attn": 0.0}
    acc["dense"] += _dense(batch, chs[0], temb) + _dense(batch, temb, temb)
    stem = _conv(bf, h, w, cfg["in_channels"], chs[0])
    acc["conv"] += stem
    sizes, skips, ch_in, hh, ww = [(h, w)], [chs[0]], chs[0], h, w
    for i, ch in enumerate(chs):
        final = i == n - 1
        cin = ch_in
        for _ in range(layers):
            _resnet(bf, hh, ww, cin, ch, temb, acc)
            cin = ch
            if not final:
                _transformer(batch, frames, hh, ww, ch, ctx_len, ctx_dim, acc)
            skips.append(ch)
        if not final:
            acc["conv"] += _conv(bf, math.ceil(hh / 2), math.ceil(ww / 2), ch, ch)
            skips.append(ch)
            hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
            sizes.append((hh, ww))
        ch_in = ch
    _resnet(bf, hh, ww, chs[-1], chs[-1], temb, acc)
    _transformer(batch, frames, hh, ww, chs[-1], ctx_len, ctx_dim, acc)
    _resnet(bf, hh, ww, chs[-1], chs[-1], temb, acc)
    x_ch = chs[-1]
    for i, ch in enumerate(reversed(chs)):
        final = i == n - 1
        ph, pw = sizes[n - 1 - i]
        cin = x_ch
        for _ in range(layers + 1):
            _resnet(bf, ph, pw, cin + skips.pop(), ch, temb, acc)
            cin = ch
            if i > 0:
                _transformer(batch, frames, ph, pw, ch, ctx_len, ctx_dim, acc)
        if not final:
            nh, nw = sizes[n - 2 - i]
            acc["conv"] += _conv(bf, nh, nw, ch, ch)
        x_ch = ch
    acc["conv"] += _conv(bf, h, w, chs[0], cfg["out_channels"])
    out = dict(acc)
    out["stem"] = stem
    out["total"] = acc["conv"] + acc["dense"] + acc["attn"]
    return out


def vae_decoder_flops(cfg, batch, h, w):
    """Matrix FLOPs of one decode of (batch, h, w) latents."""
    rev = list(reversed(cfg["block_out_channels"]))
    lat = cfg["latent_channels"]
    f = _conv(batch, h, w, lat, lat, k=1) + _conv(batch, h, w, lat, rev[0])
    f += 4 * _conv(batch, h, w, rev[0], rev[0])
    L = h * w
    f += 4 * _dense(batch * L, rev[0], rev[0]) + _attn_gemms(batch, L, L, rev[0])
    cin, hh, ww = rev[0], h, w
    for i, ch in enumerate(rev):
        for _ in range(cfg["layers_per_block"] + 1):
            f += _conv(batch, hh, ww, cin, ch) + _conv(batch, hh, ww, ch, ch)
            if cin != ch:
                f += _conv(batch, hh, ww, cin, ch, k=1)
            cin = ch
        if i < len(rev) - 1:
            hh, ww = 2 * hh, 2 * ww
            f += _conv(batch, hh, ww, ch, ch)
    return f + _conv(batch, hh, ww, rev[-1], cfg["sample_channels"])


def clip_flops(ucfg, vcfg, steps, frames, height, width):
    """One served clip: ``steps`` UNet forwards on the guidance pair (batch
    2) and the decode of its frames."""
    h, w = height // 8, width // 8
    return (steps * unet_forward_flops(ucfg, 2, frames, h, w)["total"]
            + vae_decoder_flops(vcfg, frames, h, w))


def trainable_weight_grad_flops(cfg, batch, frames, h, w):
    """dW of the trainable mask: attn1.to_q, attn2.to_q and attn_temp's
    four projections of every transformer block."""
    return sum(count * 6 * _dense(batch * frames * hh * ww, ch, ch)
               for hh, ww, ch, count in transformers(cfg, h, w))


def train_step_flops(cfg, batch, frames, h, w, ctx_len=77):
    """Model FLOPs of one fine-tune step on precomputed posteriors."""
    fwd = unet_forward_flops(cfg, batch, frames, h, w, ctx_len)
    backward = fwd["total"] - fwd["stem"] + fwd["attn"]
    return fwd["total"] + backward + trainable_weight_grad_flops(cfg, batch, frames, h, w)


# --- single calls ------------------------------------------------------------------

def call(flops, nbytes):
    return {"flops": float(flops), "bytes": float(nbytes),
            "least_s": max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)}


def attention_calls(cfg, batch, frames, h, w, ctx_len=77, train=False, temporal=False):
    """The attention calls of one forward: sparse-causal (frames 0-1 against
    K0; frames >= 2 against [K0 | K_prev]), cross (per video at inference,
    per frame with the context repeated in training) and, with ``temporal``,
    the frame-axis attention at each token. Each entry: flops, bytes,
    least_s; ``train`` adds each call's backward: four GEMMs, twice the
    forward's FLOPs, reading q, k, v, out, dout and lse and writing dq, dk,
    dv."""
    heads = cfg["attention_heads"]
    out = []

    def add(n, lq, lkv, ch, kv_rows, q_rows):
        flops = _attn_gemms(n, lq, lkv, ch)
        q = BF16 * q_rows * ch
        kv = BF16 * kv_rows * ch
        lse = 4 * heads * q_rows
        out.append(call(flops, 2 * q + 2 * kv))
        if train:
            out.append(call(2 * flops, 4 * q + 4 * kv + 2 * lse))

    for hh, ww, ch, count in transformers(cfg, h, w):
        L = hh * ww
        for _ in range(count):
            f01 = min(frames, 2)
            add(batch, f01 * L, L, ch, batch * L, batch * f01 * L)
            if frames > 2:
                m = frames - 2
                add(batch * m, L, 2 * L, ch, batch * L + batch * m * L, batch * m * L)
            ctx_rows = batch * frames * ctx_len if train else batch * ctx_len
            add(batch * frames, L, ctx_len, ch, ctx_rows, batch * frames * L)
            if temporal:
                add(batch * L, frames, frames, ch, batch * frames * L, batch * frames * L)
    return out


def ff_calls(cfg, batch, frames, h, w, widths, train=False):
    """The feed-forward calls (LayerNorm, the GEGLU projection to 8C, the
    gate, the projection back to C, the residual) of the transformer blocks
    whose width is in ``widths``; ``train`` adds each call's backward, the
    same two GEMMs for the activations (the weights are frozen), reading x,
    dout and the weights and writing dx."""
    out = []
    for hh, ww, ch, count in transformers(cfg, h, w):
        if ch not in widths:
            continue
        t = batch * frames * hh * ww
        flops = _dense(t, ch, 8 * ch) + _dense(t, 4 * ch, ch)
        weights = BF16 * (12 * ch * ch + 8 * ch + 3 * ch)
        for _ in range(count):
            out.append(call(flops, 2 * BF16 * t * ch + weights))
            if train:
                out.append(call(flops, 3 * BF16 * t * ch + weights))
    return out


def least_seconds(calls):
    return sum(c["least_s"] for c in calls)
