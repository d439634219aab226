"""Plain reference of one served clip: initial noise, DPM-Solver++(2M) with
classifier-free guidance, and the per-frame VAE decode.

- The initial noise of clip ``name`` of a request with seed ``seed`` is a
  ``torch.Generator`` on the serving device seeded by 63 bits of
  BLAKE2b(f"{seed}:{name}"), drawn as (F, H/8, W/8, 4) float32: the
  server's rule that keeps a clip independent of what shares its dispatch.
- The schedule is Stable Diffusion 1.4's (1000 steps, scaled-linear betas
  0.00085 -> 0.012, steps_offset 1, leading spacing) solved by DPM-Solver++
  (2M) (Lu et al. 2022, arXiv:2211.01095), data prediction, the first step
  first order and the last one too; the coefficients are float64 on the host,
  then float32.
- Each step runs the UNet once on [negative, embedding] and mixes
  eps_u + g (eps_c - eps_u); the final latents are divided by 0.18215 and
  decoded frame by frame; pixels are (x / 2 + 0.5) clamped to [0, 1].
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .vae import SD_VAE_SCALE

T_TRAIN = 1000


def clip_seed(seed: int, name: int) -> int:
    digest = hashlib.blake2b(f"{int(seed)}:{int(name)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def clip_noise(seed, name, shape, device):
    g = torch.Generator(device=device).manual_seed(clip_seed(seed, name))
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def alphas_cumprod():
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T_TRAIN, dtype=np.float64) ** 2
    return betas, np.cumprod(1.0 - betas)


def dpm_solver_pp(steps: int):
    """(timesteps, per-step float32 coefficients) of DPM-Solver++(2M)."""
    betas, ac = alphas_cumprod()
    ratio = T_TRAIN // steps
    ts = (np.arange(steps) * ratio).round()[::-1].astype(np.int64) + 1
    prev = ts - ratio
    ac_s = ac[ts]
    ac_t = np.where(prev >= 0, ac[np.maximum(prev, 0)], 1.0 - betas[0])
    al_s, si_s, al_t, si_t = np.sqrt(ac_s), np.sqrt(1 - ac_s), np.sqrt(ac_t), np.sqrt(1 - ac_t)
    h = np.log(al_t / si_t) - np.log(al_s / si_s)
    r = np.concatenate([[h[0]], h[:-1]]) / h
    coef = {k: v.astype(np.float32) for k, v in
            dict(al_s=al_s, si_s=si_s, al_t=al_t, si_t=si_t, h=h, r=r).items()}
    return ts, coef


@torch.no_grad()
def denoise(unet, emb, negative, noise, steps: int, guidance: float):
    """emb and negative (77, 768), noise (F, h, w, 4) -> final latents (F, h,
    w, 4), float32."""
    ts, c = dpm_solver_pp(steps)
    ctx = torch.stack([negative, emb]).float()
    lat = noise.float()[None]
    prev_x0 = None
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=lat.device)
    for i, t in enumerate(ts):
        tt = torch.full((2,), int(t), dtype=torch.int64, device=lat.device)
        eps_u, eps_c = unet(torch.cat([lat, lat]), tt, ctx).float().chunk(2)
        eps = eps_u + guidance * (eps_c - eps_u)
        x0 = (lat - f32(c["si_s"][i]) * eps) / f32(c["al_s"][i])
        if i == 0 or i == steps - 1:
            d = x0
        else:
            k = 1.0 / (2.0 * f32(c["r"][i]))
            d = (1.0 + k) * x0 - k * prev_x0
        lat = (f32(c["si_t"][i]) / f32(c["si_s"][i])) * lat - f32(c["al_t"][i]) * torch.expm1(
            -f32(c["h"][i])) * d
        prev_x0 = x0
    return lat[0]


@torch.no_grad()
def decode(decoder, latents):
    """(F, h, w, 4) final latents -> (F, 8h, 8w, 3) pixels in [0, 1]."""
    z = latents / SD_VAE_SCALE
    video = torch.cat([decoder(z[i:i + 1]) for i in range(z.shape[0])])
    return (video / 2 + 0.5).clamp(0.0, 1.0)
