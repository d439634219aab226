"""Plain reference of the video-diffusion fine-tune step
(EEG2Video_New/Generation/train_finetune_videodiffusion.py:288-330, with
Tune-A-Video's recipe the same step).

One step on a batch of posteriors (mean || logvar, (B, F, h, w, 8)) and
contexts (B, 77, 768):

- the step's draws come from a ``torch.Generator`` on the training device
  seeded by (seed << 20) + step, in this order: the posterior's eps
  (B*F, h, w, 4), the timesteps (B,) in [0, 1000), the noise (B, F, h, w, 4);
- latents = (mean + exp(logvar / 2) eps) * 0.18215, DDPM q-sample with
  Stable Diffusion's alphas_cumprod (float32), epsilon prediction, the mean
  squared error over the whole batch;
- only the trainable mask (``unet3d.trainable``) takes gradients; they are
  clipped by their global norm (the recipe's 1.0) and AdamW (the recipe's lr
  3e-5, betas (0.9, 0.999), eps 1e-8, weight decay 1e-2, from the
  configuration's ``train`` group) updates them in float32.

The batch runs in micro batches whose squared errors are summed, so the
gradient is that of the whole batch's mean. ``follow`` returns what the
benchmark compares: each step's loss, each trainable leaf's norm of the
first step's clipped gradient, and of its change after the last step.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampler import alphas_cumprod
from .unet3d import UNet3D, trainable
from .vae import SD_VAE_SCALE


def draws(seed, step, b, f, lat, device):
    g = torch.Generator(device=device).manual_seed((int(seed) << 20) + int(step))
    eps = torch.randn((b * f, *lat), generator=g, device=device)
    t = torch.randint(0, 1000, (b,), generator=g, device=device)
    noise = torch.randn((b, f, *lat), generator=g, device=device)
    return eps, t, noise


def follow(p, cfg, hp, num, posteriors, contexts, seed, micro=1, keep_rows=None):
    """``p``: float32 state dict (the trainable leaves are made to require
    grad here); ``cfg`` the UNet's configuration, ``hp`` the train group's; ``posteriors`` and ``contexts``: one (B, ...) tensor per step.
    Returns {"loss": [...], "grad_norm": {leaf: norm}, "change_norm": {leaf:
    norm}} after len(posteriors) steps. ``keep_rows`` (a fault for the
    check's own test) takes the loss's mean over that many leading rows of
    each batch only."""
    names = [n for n in p if trainable(n)]
    for n in names:
        p[n] = p[n].detach().clone().requires_grad_(True)
    start = {n: p[n].detach().clone() for n in names}
    params = [p[n] for n in names]
    opt = torch.optim.AdamW(params, lr=hp["learning_rate"],
                            betas=(hp["adam_beta1"], hp["adam_beta2"]), eps=hp["adam_epsilon"],
                            weight_decay=hp["adam_weight_decay"], foreach=False)
    unet = UNet3D(p, cfg, num, checkpointed=True)
    ac = torch.from_numpy(alphas_cumprod()[1].astype(np.float32))
    losses, grad_norm = [], None
    for step, (post, ctx) in enumerate(zip(posteriors, contexts)):
        b, f = post.shape[:2]
        lat = tuple(post.shape[2:4]) + (post.shape[-1] // 2,)
        eps, t, noise = draws(seed, step, b, f, lat, post.device)
        mean, logvar = post.float().flatten(0, 1).chunk(2, dim=-1)
        z = (mean + torch.exp(0.5 * logvar) * eps) * SD_VAE_SCALE
        latents = z.reshape(b, f, *lat)
        a = ac.to(post.device)[t].reshape(b, 1, 1, 1, 1)
        noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
        total, rows = 0.0, b if keep_rows is None else keep_rows
        for s in range(0, rows, micro):
            e = min(s + micro, rows)
            pred = unet(noisy[s:e], t[s:e], ctx[s:e].float())
            sq = ((pred.float() - noise[s:e]) ** 2).sum() / noise[:rows].numel()
            sq.backward()
            total += float(sq.detach())
        losses.append(total)
        torch.nn.utils.clip_grad_norm_(params, hp["max_grad_norm"], foreach=False)
        if step == 0:
            grad_norm = {n: float(torch.linalg.vector_norm(p[n].grad)) for n in names}
        opt.step()
        opt.zero_grad(set_to_none=True)
    change = {n: float(torch.linalg.vector_norm(p[n].detach() - start[n])) for n in names}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}
