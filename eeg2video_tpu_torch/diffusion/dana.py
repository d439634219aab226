"""DANA: dynamic noise adding (reference EEG2Video_New/DANA/add_noise.py:18-65).

Counterpart of ``eeg2video_tpu/diffusion/dana.py``. Mixes per-frame iid noise
(weight sqrt(1-beta_d)) with one noise sample shared across frames (weight
sqrt(beta_d)), then q-samples at a random timestep with a *linear* 1e-4 ->
0.02 beta schedule over 500 steps (reference L42-43). beta_d encodes
optical-flow "dynamism": 0.3 for fast clips, 0.2 otherwise (reference L120,
threshold 1.799 on the flow score, L107).

The draws come from an explicit ``torch.Generator`` (the reference seeds torch
globally with 3407, L81; the JAX package splits a ``jax.random`` key: the
three give different numbers from the same seed), or are handed in, which is
how the parity tests feed both packages the same noise.
"""

from __future__ import annotations

import numpy as np
import torch

DANA_TIME_STEPS = 500
FLOW_THRESHOLD = 1.799
BETA_FAST = 0.3
BETA_SLOW = 0.2


def dana_betas(time_steps: int = DANA_TIME_STEPS, start=1e-4, end=2e-2) -> np.ndarray:
    return np.linspace(start, end, time_steps, dtype=np.float64)


def dana_add_noise(generator, x0, dynamic_beta, time_steps: int = DANA_TIME_STEPS, *,
                   t=None, diverse=None, same=None):
    """Noise a batch of latents (B, F, C, H, W), a tensor on any device.

    ``dynamic_beta``: scalar or (B,) per-clip mixing weight.
    Matches reference Diffusion.forward (add_noise.py:45-65): per-item random
    t ~ U[0, T), diverse + shared noise mix, q-sample. The three draws come
    from ``generator`` (a ``torch.Generator`` on x0's device), in the order
    t, diverse, same, unless given: ``t`` (B,) integer timesteps, ``diverse``
    with x0's shape, ``same`` (B, 1, C, H, W), shared by the frames.
    """
    b = x0.shape[0]
    dev, dt = x0.device, x0.dtype
    if t is None:
        t = torch.randint(0, time_steps, (b,), generator=generator, device=dev)
    if diverse is None:
        diverse = torch.randn(x0.shape, generator=generator, device=dev, dtype=dt)
    if same is None:
        same = torch.randn((b, 1) + tuple(x0.shape[2:]), generator=generator, device=dev,
                           dtype=dt)
    per_clip = (b,) + (1,) * (x0.dim() - 1)
    beta_d = torch.tensor(np.asarray(dynamic_beta), device=dev).to(dt)
    if beta_d.dim():
        beta_d = beta_d.reshape(per_clip)
    noise = diverse * torch.sqrt(1.0 - beta_d) + same * torch.sqrt(beta_d)

    ac = torch.from_numpy(np.cumprod(1.0 - dana_betas(time_steps))).to(dev).to(dt)
    t = torch.as_tensor(t, device=dev).long()
    sa = torch.sqrt(ac)[t].reshape(per_clip)
    so = torch.sqrt(1.0 - ac)[t].reshape(per_clip)
    return sa * x0 + so * noise


def flow_to_beta(flow_scores, threshold: float = FLOW_THRESHOLD) -> np.ndarray:
    """Optical-flow score -> beta_d (reference add_noise.py:106,120).

    ``threshold`` defaults to the reference's 1.799 fast-motion cut; the
    server exposes it (--dana_threshold) because the shipped score table's
    estimator and scale are unpublished."""
    return np.where(np.asarray(flow_scores) >= threshold, BETA_FAST, BETA_SLOW)
