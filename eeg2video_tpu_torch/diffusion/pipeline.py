"""EEG-conditioned video generation: ``EEG2VideoPipeline``.

Counterpart of ``eeg2video_tpu/diffusion/pipeline.py`` (``_sample`` and
``EEG2VideoPipeline``, :39-213; the layout helpers :216-259). A (B, 77*768)
semantic embedding and optional initial latents go in; DDIM or
DPM-Solver++(2M) runs one UNet call per step on the classifier-free-guidance
pair; each frame is decoded by the VAE on its own. The models run in bf16,
the scheduler math in f32.

Across GPUs (``shard``, forward only): each dp rank runs the guidance pair of
its slice of the batch, the UNet under ``sp_scope`` (ring attention) and with
its tp shards; the VAE stays whole and decodes the rank's slice; the result
is gathered over dp and returned whole on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import attention3d
from ..models.unet3d import UNet3DConditionModel, UNet3DConfig
from ..models.vae import SD_VAE_SCALE, AutoencoderKL, VAEConfig
from ..utils.device import resolve_device
from .schedulers import DDIMSchedule, DPMSolverPPSchedule


@dataclasses.dataclass
class EEG2VideoPipeline:
    unet: UNet3DConditionModel
    vae: AutoencoderKL
    dtype: torch.dtype = torch.bfloat16
    mesh: object = None  # a parallel.Mesh, set by shard()

    @property
    def device(self):
        return self.unet.conv_in.weight.device

    @classmethod
    def create(cls, unet_state, vae_state, unet_config=UNet3DConfig(),
               vae_config=VAEConfig(), dtype=torch.bfloat16, device="cuda"):
        """Build both models on ``device`` (the card unless the caller names
        the CPU; raises where there is no card) in ``dtype`` from state dicts
        in the diffusers key space (``convert.from_jax`` or a checkpoint);
        ``None`` leaves a model's weights as allocated (uninitialized), for
        callers that fill them afterwards."""
        device = resolve_device(device)
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

    def shard(self, mesh, tp_rules=None):
        """Multi-GPU generation on ``mesh`` (``parallel.make_mesh``; every rank
        calls it): the UNet's parameters are sliced in place by ``tp_rules``
        (``train.unet_tp_rules`` for Megatron tp; None keeps them whole), the
        VAE stays whole, and every later call splits its batch over dp and
        routes spatial attention through ring attention where the mesh has an
        sp axis of size > 1. Returns self. Raises, before slicing anything,
        where tp would cut an attention's heads (a rank's shard of to_q/k/v
        must hold whole heads)."""
        from ..parallel import shard_params

        tp = mesh.size("tp")
        if tp_rules is not None and tp > 1:
            for name, m in self.unet.named_modules():
                if (isinstance(m, attention3d.Attention) and m.heads % tp
                        and tp_rules(f"{name}.to_q.weight") is not None):
                    raise ValueError(f"{name}: heads={m.heads} not divisible by tp={tp}")
        shard_params(self.unet, mesh, tp_rules)
        shard_params(self.vae, mesh, None)
        self.mesh = mesh
        return self

    @torch.inference_mode()
    def __call__(self, embeddings, negative, *, latents=None, generator=None,
                 video_length=6, height=288, width=512, num_inference_steps=50,
                 guidance_scale=7.5, decode=True, sampler="ddim"):
        """Generate videos.

        embeddings: (B, 77*768) or (B, 77, 768) semantic embeddings
        negative:   (77*768,) CFG negative shared by the batch, or (B, 77*768)
        latents:    optional (B, F, H/8, W/8, 4) channels-last initial latents;
                    drawn from ``generator`` (a torch.Generator on the
                    pipeline's device) when None
        sampler:    "ddim" (the reference's sampler) or "dpm++"
                    (DPM-Solver++(2M), the serving fast path)
        returns (B, F, H, W, 3) float32 in [0, 1], or the final latents
        (B, F, H/8, W/8, 4) float32 if ``decode`` is False
        """
        if sampler not in ("ddim", "dpm++"):
            raise ValueError(f"unknown sampler '{sampler}' (ddim | dpm++)")
        sched = (DDIMSchedule if sampler == "ddim" else DPMSolverPPSchedule).create(
            num_inference_steps)
        dev, dt = self.device, self.dtype
        embeddings = torch.as_tensor(embeddings, device=dev)
        b = embeddings.shape[0]
        h8, w8 = height // 8, width // 8
        if latents is None:  # drawn for the whole batch, so clips do not depend on dp
            latents = torch.randn((b, video_length, h8, w8, 4), generator=generator,
                                  device=dev, dtype=torch.float32)
        latents = torch.as_tensor(latents, device=dev)
        negative = torch.as_tensor(negative, device=dev)
        sp_mesh = None
        if self.mesh is not None:
            from ..parallel import shard_batch

            dp = self.mesh.size("dp")
            if b % dp:
                raise ValueError(f"batch {b} not divisible by dp={dp}")
            embeddings = shard_batch(embeddings, self.mesh)
            latents = shard_batch(latents, self.mesh)
            if negative.dim() > 1:
                negative = shard_batch(negative, self.mesh)
            b //= dp
            sp_mesh = self.mesh if self.mesh.size("sp") > 1 else None
        emb = embeddings.reshape(b, 77, 768).to(dt)
        if negative.dim() == 1:
            neg = negative.reshape(1, 77, 768).expand(b, 77, 768)
        else:
            neg = negative.reshape(b, 77, 768)
        context = torch.cat([neg.to(dt), emb], dim=0)  # CFG pair [neg, cond]
        with attention3d.sp_scope(sp_mesh):
            out = self._sample(context, latents, sched, guidance_scale, sampler, decode,
                               video_length, height, width)
        if self.mesh is not None:
            from ..parallel import gather_batch

            out = gather_batch(out, self.mesh)
        return out

    def _sample(self, context, latents, sched, guidance_scale, sampler, decode, video_length,
                height, width):
        dev, dt = self.device, self.dtype
        b = latents.shape[0]
        lat = latents.float() * sched.init_noise_sigma

        x0 = torch.zeros_like(lat)  # DPM++'s history; not read at the first step
        for i, t in enumerate(sched.timesteps):
            inp = torch.cat([lat, lat], dim=0).to(dt)
            tt = torch.full((2 * b,), int(t), device=dev, dtype=torch.int64)
            eps = self.unet(inp, tt, context).float()
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
            if sampler == "ddim":
                lat = sched.step(eps, t, lat)
            else:
                lat, x0 = sched.step(eps, i, lat, x0)

        if not decode:
            return lat
        frames = (lat / SD_VAE_SCALE).to(dt).flatten(0, 1)
        video = torch.cat([self.vae.decode(frames[i:i + 1])
                           for i in range(frames.shape[0])])
        video = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
        return video.reshape(b, video_length, height, width, 3)


def latents_from_torch_layout(x, frames=None):
    """Reference latent artifacts are rearranged 'a b c d e -> a c b d e'
    before the pipeline (inference_eeg2video.py:63,69), i.e. files store
    (B, F, C, H, W) and the reference pipeline wants (B, C, F, H, W). Accepts
    either and returns channels-last (B, F, H, W, C) as numpy.

    ``frames`` (optional): the expected frame count. Required to resolve the
    one genuinely ambiguous shape (a 4-frame clip's (B, 4, 4, H, W) reads the
    same in both layouts) and validated when given, so a wrong-length
    artifact fails here with the shape, not downstream."""
    x = np.asarray(x)
    if x.ndim != 5:
        raise ValueError(f"unrecognized latent layout {x.shape}")
    if frames is not None:
        ch_first = x.shape[1] == 4 and x.shape[2] == frames
        fr_first = x.shape[2] == 4 and x.shape[1] == frames
        if ch_first and fr_first:  # frames == 4: contents are undecidable
            raise ValueError(
                f"ambiguous latent layout {x.shape}: a {frames}-frame "
                "clip reads identically channel-first and frame-first — "
                "reorder the artifact to (B, F, H, W, C) yourself and "
                "pass it to the pipeline directly")
        if not (ch_first or fr_first):
            raise ValueError(
                f"latent layout {x.shape} does not match frames={frames} "
                "in either (B, C, F, H, W) or (B, F, C, H, W)")
    else:
        ch_first = x.shape[1] == 4 and x.shape[2] != 4
        fr_first = x.shape[2] == 4
        if x.shape[1] == 4 and x.shape[2] == 4:
            raise ValueError(
                f"ambiguous latent layout {x.shape} (F == C == 4): pass "
                "frames= to disambiguate")
    if ch_first:  # (B, C, F, H, W)
        return np.transpose(x, (0, 2, 3, 4, 1))
    if fr_first:  # (B, F, C, H, W)
        return np.transpose(x, (0, 1, 3, 4, 2))
    raise ValueError(f"unrecognized latent layout {x.shape}")


def video_to_torch_layout(video):
    """(B, F, H, W, 3) -> the reference pipeline's output layout
    (B, 3, F, H, W) (pipeline_tuneeeg2video.py:177), as numpy."""
    if isinstance(video, torch.Tensor):
        video = video.detach().cpu().numpy()
    return np.transpose(np.asarray(video), (0, 4, 1, 2, 3))
