"""DDIM (eta = 0) and DPM-Solver++(2M) noise schedules with diffusers-0.11.1
timestep spacing, and the DDPM forward process of the fine-tune, in numpy
(tables) and torch (the steps).

Counterpart of ``eeg2video_tpu/diffusion/schedulers.py`` (``DDPMSchedule``
:66-89, ``DDIMSchedule`` :98-153 with the inversion's ``inverse_step``,
``DPMSolverPPSchedule`` :157-234 and the spacing helper the samplers share,
``_ddim_spacing`` :43-62), for the Stable Diffusion v1-4 config: 1000 train
timesteps, scaled_linear betas 0.00085 -> 0.012, steps_offset 1,
set_alpha_to_one False, epsilon prediction. All per-step coefficients are
computed on the host in f64 and kept as f32; the steps run in f32 on the
sample's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


NUM_TRAIN_TIMESTEPS = 1000
BETA_START, BETA_END = 0.00085, 0.012  # scaled_linear
STEPS_OFFSET = 1


def _betas():
    return np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, NUM_TRAIN_TIMESTEPS,
                       dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """The forward (q) process the fine-tune noises its latents with."""

    alphas_cumprod: np.ndarray  # f32 (num_train_timesteps,)
    num_train_timesteps: int

    @classmethod
    def create(cls):
        return cls(alphas_cumprod=np.cumprod(1.0 - _betas()).astype(np.float32),
                   num_train_timesteps=NUM_TRAIN_TIMESTEPS)

    def add_noise(self, x0, noise, t):
        """q(x_t | x_0) = sqrt(ac_t) x0 + sqrt(1 - ac_t) noise, f32; ``t`` is a
        (B,) integer tensor, one timestep per leading row of ``x0``."""
        ac = torch.from_numpy(self.alphas_cumprod).to(x0.device)[t.long()]
        ac = ac.reshape(ac.shape + (1,) * (x0.dim() - ac.dim()))
        return torch.sqrt(ac) * x0 + torch.sqrt(1.0 - ac) * noise


def ddim_spacing(num_inference_steps):
    """The leading-space discretization DDIM and DPM-Solver++ share (they
    discretize the same probability-flow ODE on the same grid): f64
    ``(betas, alphas_cumprod, step_ratio, timesteps)``. Rejects step counts
    outside [1, T] (past T the step ratio floors to 0 and every step would
    be a no-op) and a grid whose first timestep falls past the table."""
    t_max = NUM_TRAIN_TIMESTEPS
    if not 1 <= num_inference_steps <= t_max:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} must be in [1, {t_max}]")
    betas = _betas()
    ac = np.cumprod(1.0 - betas)
    step_ratio = t_max // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
    ts = ts.astype(np.int32) + STEPS_OFFSET
    if ts[0] >= t_max:
        raise ValueError(
            f"num_inference_steps={num_inference_steps}: with steps_offset "
            f"{STEPS_OFFSET} the first timestep is {ts[0]}, past the {t_max}-entry "
            f"alphas_cumprod table; use at most {t_max - 1} steps")
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

    def inverse_step(self, model_output, t, sample):
        """x_{t - step_ratio} -> x_t, the reverse of ``step`` (DDIM inversion),
        f32; where t - step_ratio < 0 the start is ``final_alpha_cumprod``."""
        prev_t = int(t) - self.num_train_timesteps // self.num_inference_steps
        a_prev = torch.tensor(self.alphas_cumprod[prev_t] if prev_t >= 0
                              else self.final_alpha_cumprod, dtype=torch.float32)
        a_next = torch.tensor(self.alphas_cumprod[int(t)], dtype=torch.float32)
        x0 = (sample - torch.sqrt(1.0 - a_prev) * model_output) / torch.sqrt(a_prev)
        return torch.sqrt(a_next) * x0 + torch.sqrt(1.0 - a_next) * model_output


@dataclasses.dataclass(frozen=True)
class DPMSolverPPSchedule:
    """DPM-Solver++(2M): a second-order multistep ODE sampler (Lu et al.
    2022, data-prediction / multistep variant), the serving fast path beside
    the reference's 100-step DDIM: it reaches the same solution in a fraction
    of the steps. Same noise schedule and timestep grid as ``DDIMSchedule``.
    ``step`` takes the loop index and the previous step's x0 prediction; the
    first step has no history and the last drops to first order (the 2M
    correction would extrapolate x0 across the final interval otherwise)."""

    alphas_cumprod: np.ndarray  # f32 (num_train_timesteps,)
    timesteps: np.ndarray       # int32, descending, length N
    alpha_s: np.ndarray         # sqrt(ac) at the current t of step i
    sigma_s: np.ndarray         # sqrt(1 - ac) at the current t
    alpha_t: np.ndarray         # sqrt(ac) at the target t of step i
    sigma_t: np.ndarray         # sqrt(1 - ac) at the target t
    h: np.ndarray               # lambda_t - lambda_s per step
    r: np.ndarray               # h_{i-1} / h_i (1.0 at i = 0)
    num_train_timesteps: int
    num_inference_steps: int
    init_noise_sigma: float = 1.0

    @classmethod
    def create(cls, num_inference_steps):
        betas, ac, step_ratio, ts = ddim_spacing(num_inference_steps)
        final_ac = np.float64(1.0 - betas[0])  # set_alpha_to_one False
        # DDIM-convention targets: prev_t = t - step_ratio, the final interval
        # landing on final_alpha_cumprod (= ac[0])
        ac_s = ac[ts]
        prev = ts - step_ratio
        ac_t = np.where(prev >= 0, ac[np.maximum(prev, 0)], final_ac)
        al_s, si_s = np.sqrt(ac_s), np.sqrt(1.0 - ac_s)
        al_t, si_t = np.sqrt(ac_t), np.sqrt(1.0 - ac_t)
        h = np.log(al_t / si_t) - np.log(al_s / si_s)
        r = np.concatenate([[h[0]], h[:-1]]) / h
        f32 = lambda a: a.astype(np.float32)
        return cls(alphas_cumprod=f32(ac), timesteps=ts, alpha_s=f32(al_s),
                   sigma_s=f32(si_s), alpha_t=f32(al_t), sigma_t=f32(si_t),
                   h=f32(h), r=f32(r), num_train_timesteps=NUM_TRAIN_TIMESTEPS,
                   num_inference_steps=num_inference_steps)

    def step(self, model_output, i, sample, prev_x0):
        """One 2M update at loop index ``i`` (epsilon-prediction model), f32.
        Returns ``(new_sample, x0)``; hand ``x0`` back as ``prev_x0`` of the
        next step (any tensor works at i = 0: it is not read)."""
        i = int(i)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        al_s, si_s = f32(self.alpha_s[i]), f32(self.sigma_s[i])
        al_t, si_t = f32(self.alpha_t[i]), f32(self.sigma_t[i])
        x0 = (sample - si_s * model_output) / al_s
        if i == 0 or i == self.num_inference_steps - 1:
            d = x0
        else:
            c = 1.0 / (2.0 * f32(self.r[i]))
            d = (1.0 + c) * x0 - c * prev_x0
        new = (si_t / si_s) * sample - al_t * torch.expm1(-f32(self.h[i])) * d
        return new, x0
