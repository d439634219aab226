"""DDIM noise schedule (eta = 0) with diffusers-0.11.1 timestep spacing, in
numpy (tables) and torch (the step).

Counterpart of ``eeg2video_tpu/diffusion/schedulers.py`` (``DDIMSchedule``
and the shared spacing helper ``_ddim_spacing``, :43-62, 98-141), for the
Stable Diffusion v1-4 config: 1000 train timesteps, scaled_linear betas
0.00085 -> 0.012, steps_offset 1, set_alpha_to_one False, epsilon
prediction. DPM-Solver++ is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


NUM_TRAIN_TIMESTEPS = 1000
BETA_START, BETA_END = 0.00085, 0.012  # scaled_linear
STEPS_OFFSET = 1


def ddim_spacing(num_inference_steps):
    """The leading-space discretization shared with DPM-Solver++: f64
    ``(betas, alphas_cumprod, step_ratio, timesteps)``; rejects step counts
    outside [1, T] (past T the step ratio floors to 0 and every step would
    be a no-op)."""
    t_max = NUM_TRAIN_TIMESTEPS
    if not 1 <= num_inference_steps <= t_max:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} must be in [1, {t_max}]")
    betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, t_max, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    step_ratio = t_max // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
    ts = ts.astype(np.int32) + STEPS_OFFSET
    return betas, ac, step_ratio, ts


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    alphas_cumprod: np.ndarray  # f32 (num_train_timesteps,)
    timesteps: np.ndarray       # int32, descending
    final_alpha_cumprod: np.float32
    num_train_timesteps: int
    num_inference_steps: int
    init_noise_sigma: float = 1.0  # DDIM's scale_model_input is the identity

    @classmethod
    def create(cls, num_inference_steps):
        _, ac, _, ts = ddim_spacing(num_inference_steps)
        # set_alpha_to_one False: the final step lands on alphas_cumprod[0]
        return cls(alphas_cumprod=ac.astype(np.float32), timesteps=ts,
                   final_alpha_cumprod=np.float32(ac[0]),
                   num_train_timesteps=NUM_TRAIN_TIMESTEPS,
                   num_inference_steps=num_inference_steps)

    def step(self, model_output, t, sample):
        """x_t -> x_{t - step_ratio} (eta = 0, no clipping), f32."""
        prev_t = int(t) - self.num_train_timesteps // self.num_inference_steps
        a_t = torch.tensor(self.alphas_cumprod[int(t)], dtype=torch.float32)
        a_prev = torch.tensor(self.alphas_cumprod[prev_t] if prev_t >= 0
                              else self.final_alpha_cumprod, dtype=torch.float32)
        x0 = (sample - torch.sqrt(1.0 - a_t) * model_output) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * model_output
