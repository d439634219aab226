"""EEG-conditioned video generation: ``EEG2VideoPipeline``.

Counterpart of ``eeg2video_tpu/diffusion/pipeline.py`` (``_sample`` and
``EEG2VideoPipeline``, :39-137, 165-213), single device. A (B, 77*768)
semantic embedding and optional initial latents go in; DDIM runs one UNet
call per step on the classifier-free-guidance pair; each frame is decoded by
the VAE on its own. The models run in bf16, the scheduler math in f32.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.unet3d import UNet3DConditionModel, UNet3DConfig
from ..models.vae import SD_VAE_SCALE, AutoencoderKL, VAEConfig
from .schedulers import DDIMSchedule


@dataclasses.dataclass
class EEG2VideoPipeline:
    unet: UNet3DConditionModel
    vae: AutoencoderKL
    dtype: torch.dtype = torch.bfloat16

    @property
    def device(self):
        return self.unet.conv_in.weight.device

    @classmethod
    def create(cls, unet_state, vae_state, unet_config=UNet3DConfig(),
               vae_config=VAEConfig(), dtype=torch.bfloat16, device="cpu"):
        """Build both models on ``device`` in ``dtype`` from state dicts in
        the diffusers key space (``convert.from_jax`` or a checkpoint);
        ``None`` leaves a model's weights as allocated (uninitialized), for
        callers that fill them afterwards."""
        with torch.device("meta"):
            unet = UNet3DConditionModel(unet_config)
            vae = AutoencoderKL(vae_config)
        models = []
        for model, state in ((unet, unet_state), (vae, vae_state)):
            model = model.to(dtype).to_empty(device=device).eval()
            if state is not None:
                model.load_state_dict(state, strict=True)
            models.append(model.requires_grad_(False))
        return cls(unet=models[0], vae=models[1], dtype=dtype)

    @torch.inference_mode()
    def __call__(self, embeddings, negative, *, latents=None, generator=None,
                 video_length=6, height=288, width=512, num_inference_steps=50,
                 guidance_scale=7.5, sampler="ddim"):
        """Generate videos.

        embeddings: (B, 77*768) or (B, 77, 768) semantic embeddings
        negative:   (77*768,) CFG negative shared by the batch, or (B, 77*768)
        latents:    optional (B, F, H/8, W/8, 4) channels-last initial latents;
                    drawn from ``generator`` (a torch.Generator on the
                    pipeline's device) when None
        returns (B, F, H, W, 3) float32 in [0, 1]
        """
        if sampler != "ddim":
            raise ValueError(f"unknown sampler '{sampler}' (only ddim is ported)")
        sched = DDIMSchedule.create(num_inference_steps)
        dev, dt = self.device, self.dtype
        embeddings = torch.as_tensor(embeddings, device=dev)
        b = embeddings.shape[0]
        emb = embeddings.reshape(b, 77, 768).to(dt)
        negative = torch.as_tensor(negative, device=dev)
        if negative.dim() == 1:
            neg = negative.reshape(1, 77, 768).expand(b, 77, 768)
        else:
            neg = negative.reshape(b, 77, 768)
        context = torch.cat([neg.to(dt), emb], dim=0)  # CFG pair [neg, cond]

        h8, w8 = height // 8, width // 8
        if latents is None:
            latents = torch.randn((b, video_length, h8, w8, 4), generator=generator,
                                  device=dev, dtype=torch.float32)
        lat = torch.as_tensor(latents, device=dev).float() * sched.init_noise_sigma

        for t in sched.timesteps:
            inp = torch.cat([lat, lat], dim=0).to(dt)
            tt = torch.full((2 * b,), int(t), device=dev, dtype=torch.int64)
            eps = self.unet(inp, tt, context).float()
            eps_u, eps_c = eps.chunk(2, dim=0)
            lat = sched.step(eps_u + guidance_scale * (eps_c - eps_u), t, lat)

        frames = (lat / SD_VAE_SCALE).to(dt).flatten(0, 1)
        video = torch.cat([self.vae.decode(frames[i:i + 1])
                           for i in range(frames.shape[0])])
        video = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
        return video.reshape(b, video_length, height, width, 3)
