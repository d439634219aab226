"""Per-clip motion scores (coarse-to-fine Horn-Schunck flow) on the card.

Counterpart of ``eeg2video_tpu/data/optical_flow.py``: the producer of the
(blocks, clips) motion table ``All_video_optical_flow_score.npy`` that DANA's
``add_noise`` thresholds. Horn-Schunck (quadratic data and smoothness terms)
runs coarse to fine over a 2x average-pooled pyramid with a bilinear warp
between levels; a clip's score is the mean flow magnitude, in pixels of the
input per frame step, over its pixels and consecutive frame pairs.

JAX writes it in jnp under ``jit`` and ``lax.scan`` (no Pallas kernel), so
the port writes it as torch ops on the device, every frame pair of a chunk
of clips as one batch:

- the stencils run as shifted multiply-adds in float32 over zero padding
  placed as XLA's "SAME" places it: 1 on each side of the 3x3 average, 0
  before and 1 after the 2x2 derivative stencils (no library convolution,
  so no TF32 rounding on the card);
- the 2x flow upsampling is ``F.interpolate`` bilinear with
  ``align_corners=False``, which gives ``jax.image.resize``'s half-pixel
  weights and, at the edges, its renormalised (edge-repeating) samples;
- the warp clamps the sample point to the frame and the top-left tap to
  ``w - 2`` / ``h - 2``, as JAX's does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

# Horn-Schunck neighbourhood average (the standard 8-neighbour stencil).
_AVG = ((1 / 12, 1 / 6, 1 / 12),
        (1 / 6, 0.0, 1 / 6),
        (1 / 12, 1 / 6, 1 / 12))
# 2x2 derivative stencils (Horn & Schunck 1981 eqs. 5-7): the spatial
# derivatives average over both frames, the temporal one over the 2x2 patch.
_KX = ((-0.25, 0.25), (-0.25, 0.25))
_KY = ((-0.25, -0.25), (0.25, 0.25))
_KT = ((0.25, 0.25), (0.25, 0.25))


def _conv(x, k):
    """(..., H, W) cross-correlated with the stencil ``k`` (kh, kw), zero
    "SAME" padding as XLA pads: (k - 1) // 2 before, the rest after."""
    kh, kw = len(k), len(k[0])
    h, w = x.shape[-2:]
    xp = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    out = None
    for i in range(kh):
        for j in range(kw):
            c = float(np.float32(k[i][j]))
            if c == 0.0:
                continue
            tap = xp[..., i:i + h, j:j + w]
            out = tap * c if out is None else torch.add(out, tap, alpha=c)
    return out


def _warp(img, u, v):
    """Bilinear backward warp: ``img`` (N, H, W) sampled at (x + u, y + v);
    out-of-frame samples clamp to the border."""
    n, h, w = img.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=img.dtype, device=img.device),
                            torch.arange(w, dtype=img.dtype, device=img.device), indexing="ij")
    xs = torch.clamp(xx[None] + u, 0.0, w - 1.0)
    ys = torch.clamp(yy[None] + v, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(xs), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2)
    fx, fy = xs - x0, ys - y0
    base = (y0.long() * w + x0.long()).reshape(n, h * w)
    flat = img.reshape(n, h * w)

    def take(offset):
        return torch.gather(flat, 1, base + offset).reshape(n, h, w)

    top = take(0) * (1 - fx) + take(1) * fx
    bot = take(w) * (1 - fx) + take(w + 1) * fx
    return top * (1 - fy) + bot * fy


def _hs_level(i1, i2, u, v, alpha, n_iter):
    """Horn-Schunck Jacobi iterations at one pyramid level; i2 is warped by
    the incoming flow and the solved increment is added to it."""
    i2w = _warp(i2, u, v)
    ix = _conv(i1 + i2w, _KX)
    iy = _conv(i1 + i2w, _KY)
    it = _conv(i2w - i1, _KT)
    denom = alpha * alpha + ix * ix + iy * iy
    d = torch.zeros((2,) + u.shape, dtype=u.dtype, device=u.device)  # (du, dv)
    for _ in range(n_iter):
        db = _conv(d, _AVG)
        t = (ix * db[0] + iy * db[1] + it) / denom
        d = torch.stack([db[0] - ix * t, db[1] - iy * t])
    return u + d[0], v + d[1]


def _downsample(x):
    """2x average pool (N, H, W) -> (N, H // 2, W // 2)."""
    n, h, w = x.shape
    return x[:, : h - h % 2, : w - w % 2].reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _upsample(x, shape):
    return F.interpolate(x[:, None], size=shape, mode="bilinear", align_corners=False)[:, 0]


def horn_schunck(i1, i2, alpha=1.0, n_iter=100, levels=3):
    """Batched coarse-to-fine Horn-Schunck flow of (N, H, W) grayscale
    tensors in [0, 1], computed on their device in float32. Returns (u, v),
    each (N, H, W), in pixels of the input (u the column displacement)."""
    i1, i2 = i1.float(), i2.float()
    pyr = [(i1, i2)]
    for _ in range(levels - 1):
        pyr.append((_downsample(pyr[-1][0]), _downsample(pyr[-1][1])))
    u = torch.zeros_like(pyr[-1][0])
    v = torch.zeros_like(u)
    for lvl in range(levels - 1, -1, -1):
        a, b = pyr[lvl]
        if u.shape != a.shape:  # the flow of the level above, in this level's pixels
            u = 2.0 * _upsample(u, a.shape[-2:])
            v = 2.0 * _upsample(v, a.shape[-2:])
        u, v = _hs_level(a, b, u, v, alpha, n_iter)
    return u, v


def _to_gray(frames):
    """(..., H, W, 3) uint8 (scaled to [0, 1]) or float -> (..., H, W) luma."""
    f = frames.float()
    if frames.dtype == torch.uint8:
        f = f / 255.0
    return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]


def clip_motion_scores(frames, alpha=1.0, n_iter=100, levels=3, device="cuda"):
    """(B, F, H, W, 3) frames (array or tensor) -> (B,) mean flow magnitude
    per frame pair, every consecutive pair of every clip as one batch, on
    ``device``."""
    frames = torch.as_tensor(frames, device=resolve_device(device))
    gray = _to_gray(frames)
    b, f, h, w = gray.shape
    i1 = gray[:, :-1].reshape(b * (f - 1), h, w)
    i2 = gray[:, 1:].reshape(b * (f - 1), h, w)
    u, v = horn_schunck(i1, i2, alpha=alpha, n_iter=n_iter, levels=levels)
    mag = torch.sqrt(u * u + v * v)
    return mag.reshape(b, f - 1, h, w).mean(dim=(1, 2, 3))


def score_clips(frames, alpha=1.0, n_iter=100, levels=3, chunk=25, device="cuda"):
    """(B, F, H, W, 3) uint8 clips -> (B,) float32 scores on the host,
    ``chunk`` clips at a time on ``device``; the tail chunk is padded with
    black clips to ``chunk``, as JAX pads it to reuse its compiled shape."""
    device = resolve_device(device)
    frames = np.asarray(frames)
    n = frames.shape[0]
    out = []
    with torch.no_grad():
        for s in range(0, n, chunk):
            part = frames[s: s + chunk]
            if part.shape[0] != chunk:
                pad = np.zeros((chunk - part.shape[0],) + part.shape[1:], part.dtype)
                part = np.concatenate([part, pad], axis=0)
            scores = clip_motion_scores(part, alpha, n_iter, levels, device)
            out.append(scores[: n - s].cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.float32)
