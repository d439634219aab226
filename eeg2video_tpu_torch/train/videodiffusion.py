"""Video-diffusion fine-tune trainer (reference
EEG2Video_New/Generation/train_finetune_videodiffusion.py:66-397) on one GPU.

Counterpart of ``eeg2video_tpu/train/videodiffusion.py``:

- trainable modules restricted to ("attn1.to_q", "attn2.to_q", "attn_temp")
  (reference L72-76, L142-146): only those parameters require a gradient and
  only they are handed to the optimizer, so frozen weights get no gradient
  buffer and no Adam moments;
- AdamW lr 3e-5, betas (0.9, 0.999), wd 1e-2, eps 1e-8, global-norm clip 1.0
  over the trainable gradients (reference L77-87, L327-328); with
  ``use_8bit_adam`` the AdamW of ``train.optim`` with int8 moments (the
  reference's bitsandbytes AdamW8bit, L163-173);
- gradient accumulation (``gradient_accumulation_steps`` k, JAX
  ``optax.MultiSteps``): every micro step adds its gradient to a running mean,
  ``acc + (g - acc) / (n + 1)``, and every k-th one clips that mean and takes
  the optimizer step; ``step`` counts micro steps, as JAX's does;
- bf16 compute with f32 parameters (the reference's fp16 autocast, L99-102,
  L286): see ``TrainState``;
- gradient checkpointing (reference L154-155): ``remat`` / ``remat_min_hw``
  / ``remat_save_attn``, see ``models.unet3d``.

Training math (reference L288-319): VAE-encode pixels (or take precomputed
posteriors), sample the posterior x 0.18215, draw uniform timesteps and
noise, DDPM q-sample, UNet eps-prediction, f32 MSE. Every random draw comes
from a ``torch.Generator`` seeded from (seed, step), so a resumed run draws
what the uninterrupted one would have; each draw can also be passed in.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..diffusion.schedulers import DDPMSchedule
from ..models.vae import SD_VAE_SCALE
from ..utils.device import resolve_device
from .optim import Adam8bit, true_div


def trainable(name: str) -> bool:
    """Reference freeze rule (train L142-146) on a parameter name of the
    port's (diffusers) key space: every ``attn_temp`` parameter, and
    ``to_q`` of ``attn1`` and ``attn2``."""
    parts = name.split(".")
    if "attn_temp" in parts:
        return True
    return ("attn1" in parts or "attn2" in parts) and "to_q" in parts


def unet_tp_rules(name: str):
    """Megatron tensor parallelism of every attention and feed-forward
    projection (JAX's rules, train/videodiffusion.py:75-86, over the port's
    names, for ``parallel.shard_params``): to_q/k/v and the GEGLU projection
    split by output features (dim 0 of the torch weight; the projection's
    weight and bias by halves, so that each rank keeps the same rows of the
    hidden and the gate half), to_out and the feed-forward's out by input
    features (dim 1); every other parameter, biases of the row splits
    included, whole."""
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in ("to_q", "to_k", "to_v"):
        return (0, "tp")
    if parts[-3:-1] == ["0", "proj"] and "ff" in parts:
        return (0, "tp", 2)
    if parts[-1] == "weight" and (parts[-3:-1] == ["to_out", "0"]
                                  or (parts[-3:-1] == ["net", "2"] and "ff" in parts)):
        return (1, "tp")
    return None


@dataclasses.dataclass(frozen=True)
class VideoDiffusionTrainConfig:
    learning_rate: float = 3e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    weight_decay: float = 1e-2
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # recompute only blocks whose input has H*W >= this many tokens per frame
    # (0 = everywhere): at 36x64 latents levels 0 and 1 are recomputed and
    # levels 2, 3 and mid keep their (small) activations
    remat_min_hw: int = 256
    # keep the attention, temporal and feed-forward kernels' outputs inside a
    # recomputed block instead of running those forwards again (JAX's
    # remat_save_attn; the model's remat_save_convs stays at its default, True)
    remat_save_attn: bool = True
    # False = the reference freeze rule; True = every parameter trains
    train_all: bool = False
    # micro steps per optimizer step (the running mean of their gradients)
    gradient_accumulation_steps: int = 1
    # int8 Adam moments (train.optim.Adam8bit)
    use_8bit_adam: bool = False


class TrainState:
    """Parameters, optimizer and step of a fine-tune.

    f32 is the stored truth of every parameter. With ``compute_dtype``
    float32 the model's own parameters are that truth. Otherwise the model is
    a working copy in the compute dtype: frozen weights are cast once (their
    f32 originals are kept on the host, untouched, for checkpoints), and each
    trainable parameter has an f32 master on the device that the optimizer
    updates; the working copy is re-cast from it after every step and its
    gradient is carried to the master in f32 (the cast's own backward)."""

    def __init__(self, unet: nn.Module, cfg: VideoDiffusionTrainConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.step = 0
        named = dict(unet.named_parameters())
        self.trainable_names = [n for n in named if cfg.train_all or trainable(n)]
        chosen = set(self.trainable_names)
        for n, p in named.items():
            if p.dtype != torch.float32:
                raise ValueError(f"{n}: the train state is built from f32 parameters, "
                                 f"got {p.dtype}")
            p.requires_grad_(n in chosen)
        self.frozen_f32 = None
        if self.dtype == torch.float32:
            self.unet = unet.to(self.device)
            self.masters = {n: p for n, p in self.unet.named_parameters() if n in chosen}
        else:
            self.frozen_f32 = {n: p.detach().cpu() for n, p in named.items()
                               if n not in chosen}
            self.masters = {n: nn.Parameter(named[n].detach().to(self.device).clone())
                            for n in self.trainable_names}
            self.unet = unet.to(device=self.device, dtype=self.dtype)
        self.working = {n: p for n, p in self.unet.named_parameters() if n in chosen}
        adamw = Adam8bit if cfg.use_8bit_adam else torch.optim.AdamW
        self.optimizer = adamw(
            list(self.masters.values()), lr=cfg.learning_rate,
            betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay)
        # the running mean of the micro steps' gradients and how many it holds
        # (JAX wraps its optimizer in MultiSteps for k > 1 only)
        self.accum = ({n: torch.zeros_like(p) for n, p in self.masters.items()}
                      if cfg.gradient_accumulation_steps > 1 else None)
        self.mini_step = 0

    def _sync_working(self):
        if self.dtype != torch.float32:
            with torch.no_grad():
                for n, master in self.masters.items():
                    self.working[n].copy_(master)

    def apply_gradients(self):
        """Take one micro step: clip the trainable gradients by their global
        norm, take one AdamW step on the f32 masters and refresh the working
        copy; with gradient accumulation, add the gradients to the running
        mean instead and do that with the mean every k-th micro step."""
        for n, master in self.masters.items():
            w = self.working[n]
            if w.grad is None:
                raise RuntimeError(f"{n}: trainable but received no gradient")
            if master is not w:
                master.grad = w.grad.float()
                w.grad = None
        self.step += 1
        if self.accum is not None:
            with torch.no_grad():
                for n, master in self.masters.items():
                    acc = self.accum[n]
                    acc.add_(true_div(master.grad - acc, float(self.mini_step + 1)))
                    master.grad = None
            self.mini_step += 1
            if self.mini_step < self.cfg.gradient_accumulation_steps:
                return
            for n, master in self.masters.items():
                master.grad = self.accum[n]
        torch.nn.utils.clip_grad_norm_(list(self.masters.values()), self.cfg.max_grad_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum is not None:
            for acc in self.accum.values():
                acc.zero_()
            self.mini_step = 0
        self._sync_working()

    def params_f32(self):
        """The stored truth: ``{name: f32 tensor on the host}`` in the
        model's key order, frozen entries bit-equal to what was loaded."""
        out = {}
        for n, p in self.unet.named_parameters():
            if n in self.masters:
                out[n] = self.masters[n].detach().cpu()
            elif self.frozen_f32 is not None:
                out[n] = self.frozen_f32[n]
            else:
                out[n] = p.detach().cpu()
        return out

    def state_dict(self):
        sd = {"params": self.params_f32(), "opt_state": self.optimizer.state_dict(),
              "step": self.step, "trainable": list(self.trainable_names)}
        if self.accum is not None:
            sd["accum"] = {n: a.detach().cpu() for n, a in self.accum.items()}
            sd["mini_step"] = self.mini_step
        return sd

    def load_state_dict(self, sd):
        """Restore the trainable parameters, the optimizer state and the
        step. The frozen parameters of ``sd`` must be this state's own: a
        fine-tune never changes them, so a difference means another model."""
        if list(sd["trainable"]) != self.trainable_names:
            raise ValueError("the checkpoint was written under another freeze rule")
        ours = self.params_f32()
        with torch.no_grad():
            for n, p in sd["params"].items():
                if n in self.masters:
                    self.masters[n].copy_(p)
                elif not torch.equal(ours[n], p):
                    raise ValueError(f"{n}: frozen weight differs from the checkpoint's")
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        if self.accum is not None:
            with torch.no_grad():
                for n, a in sd.get("accum", {}).items():
                    self.accum[n].copy_(a)
            self.mini_step = int(sd.get("mini_step", 0))
        self._sync_working()


def init_video_train_state(unet, cfg=VideoDiffusionTrainConfig(), device="cuda"):
    """Train state of ``unet`` (f32 parameters) on ``device``: the card
    unless the caller names the CPU; raises where there is no card."""
    return TrainState(unet, cfg, device)


def step_generator(seed: int, step: int, device):
    """The generator of one step's draws, a function of (seed, step) only."""
    return torch.Generator(device=device).manual_seed((int(seed) << 20) + int(step))


def video_loss(unet, vae, pixels, context, cfg, *, generator=None, t=None, noise=None,
               eps=None, ddpm=None):
    """The fine-tune loss of one batch (videodiffusion.py:180-214 of the JAX
    package). ``pixels`` (B, F, H, W, 3) in [-1, 1], or precomputed
    posteriors (B, F, H/8, W/8, 8), mean || logvar on the channels (see
    ``encode_posteriors``); ``context`` (B, 77, cross_attention_dim).
    ``t`` (B,), ``noise`` (latents' shape) and the posterior's ``eps``
    (B*F, H/8, W/8, 4) are drawn from ``generator`` unless given."""
    dtype = getattr(torch, cfg.compute_dtype)
    ddpm = ddpm or DDPMSchedule.create()
    b, f = pixels.shape[:2]
    dev = pixels.device
    if pixels.shape[-1] == 8:
        mean, logvar = pixels.flatten(0, 1).float().chunk(2, dim=-1)
    else:
        with torch.no_grad():
            mean, logvar = vae.encode(pixels.flatten(0, 1).to(dtype))
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=dev)
    z = mean.float() + torch.exp(0.5 * logvar.float()) * eps
    latents = (z * SD_VAE_SCALE).reshape(b, f, *mean.shape[1:])
    if t is None:
        t = torch.randint(0, ddpm.num_train_timesteps, (b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=dev)
    noisy = ddpm.add_noise(latents, noise, t)
    pred = unet(noisy.to(dtype), t, context.to(dtype), train=True, remat=cfg.remat,
                remat_min_hw=cfg.remat_min_hw, remat_save_attn=cfg.remat_save_attn).float()
    return torch.mean((pred - noise) ** 2)


@torch.no_grad()
def encode_posteriors(vae, pixels, batch: int = 8):
    """Precompute VAE posteriors for a clip set: (N, F, H, W, 3) pixels ->
    (N, F, H/8, W/8, 8) f32 ``mean || logvar`` on the VAE's device.

    Feed the result to the train step in place of pixels (the loss
    dispatches on the channel count): one encoder pass per dataset instead of
    one per step, the same training distribution because the posterior's
    parameters are deterministic and its sampling stays in the step. Frames
    go through the encoder one at a time, ``batch`` of them per transfer."""
    p = next(vae.parameters())
    pixels = torch.as_tensor(pixels)
    n, f = pixels.shape[:2]
    flat = pixels.reshape(n * f, *pixels.shape[2:])
    outs = []
    for s in range(0, n * f, batch):
        chunk = flat[s:s + batch].to(p.device, p.dtype)
        for frame in chunk:
            mean, logvar = vae.encode(frame[None])
            outs.append(torch.cat([mean[0].float(), logvar[0].float()], dim=-1))
    post = torch.stack(outs)
    return post.reshape(n, f, *post.shape[1:])


def train_step(state: TrainState, vae, pixels, context, seed, *, t=None, noise=None,
               eps=None):
    """One micro step on one batch (an optimizer step unless gradients
    accumulate); returns the loss (a 0-d tensor on the device, not
    synchronized). The step's draws come from
    ``step_generator(seed, state.step)``, and ``state.step`` counts micro
    steps, so each micro batch draws its own."""
    gen = step_generator(seed, state.step, state.device)
    loss = video_loss(state.unet, vae, pixels.to(state.device), context.to(state.device),
                      state.cfg, generator=gen, t=t, noise=noise, eps=eps)
    loss.backward()
    state.apply_gradients()
    return loss.detach()


def train_epoch(state: TrainState, vae, pixels_all, context_all, perm, seed, on_step=None):
    """One epoch over ``perm`` (steps, B) integer indices into the resident
    clip set; returns the mean loss (one host synchronization, at the end).
    ``on_step(state, loss)`` is called after every (micro) step."""
    losses = []
    for idx in torch.as_tensor(perm, device=pixels_all.device).long():
        losses.append(train_step(state, vae, pixels_all[idx], context_all[idx], seed))
        if on_step is not None:
            on_step(state, losses[-1])
    return float(torch.stack(losses).mean())
