"""Text-conditioned generation and DDIM inversion.

Counterpart of ``eeg2video_tpu/diffusion/text_pipeline.py``:
``TextToVideoPipeline`` (:29-53), the reference's ``TuneAVideoPipeline``
(pipeline_tuneavideo.py:40-412), and ``ddim_inversion`` (:56-77), the
reference's tuneavideo/util.py:56-101. The prompts go through the CLIP text
tower (f32, as the JAX package runs it); the negative is the empty prompt's
encoding (the ``negative.npy`` artifact, pipeline_tuneavideo.py:230-233); the
sampling is ``EEG2VideoPipeline``'s, so every UNet call runs the port's
generation kernels on the card. Noise comes from ``generator=`` where JAX
takes ``key=``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..models.clip_text import CLIPTextConfig, CLIPTextModel, encode_ids
from .pipeline import EEG2VideoPipeline
from .schedulers import DDIMSchedule

MAX_LENGTH = 77


def tokenize(tokenizer, prompts, max_length=MAX_LENGTH):
    """(len(prompts), max_length) ids: padded to ``max_length`` and truncated,
    as the JAX package asks a ``transformers.CLIPTokenizer`` for them."""
    return tokenizer(prompts, max_length=max_length, padding="max_length",
                     truncation=True, return_tensors="np").input_ids


@dataclasses.dataclass
class TextToVideoPipeline:
    """A tokenizer and the CLIP text encoder in front of ``EEG2VideoPipeline``."""

    base: EEG2VideoPipeline
    text_model: CLIPTextModel
    tokenizer: object  # a transformers CLIPTokenizer (local files) or a stand-in

    @classmethod
    def create(cls, pipe: EEG2VideoPipeline, text_state, tokenizer,
               text_config: CLIPTextConfig = CLIPTextConfig()):
        """The text encoder in f32 on the pipeline's device, from a state dict
        in ``transformers.CLIPTextModel``'s keys."""
        with torch.device("meta"):
            model = CLIPTextModel(text_config)
        model = model.to_empty(device=pipe.device).eval()
        model.load_state_dict(text_state, strict=True)
        return cls(pipe, model.requires_grad_(False), tokenizer)

    def encode_prompts(self, prompts: List[str]):
        """(len(prompts), 77, hidden) f32 last hidden states on the pipeline's
        device."""
        return encode_ids(self.text_model, tokenize(self.tokenizer, prompts))

    def __call__(self, prompts: List[str], **kw):
        emb = self.encode_prompts(prompts).reshape(len(prompts), -1)
        negative = self.encode_prompts([""]).reshape(-1)
        return self.base(emb, negative, **kw)


@torch.inference_mode()
def ddim_inversion(unet, video_latents, context, num_inv_steps: int = 50):
    """Deterministic DDIM inversion of clean latents into noise space: the
    unconditional DDIM loop walked backwards (ascending timesteps), with
    ``DDIMSchedule.inverse_step`` on the f32 latents and the UNet in its own
    dtype.

    video_latents: (B, F, h, w, 4) channels-last, already x0.18215-scaled
    context:       (B, 77, 768) (the reference inverts with the empty prompt's)
    returns the latents after ``num_inv_steps`` inverse steps, f32
    """
    sched = DDIMSchedule.create(num_inv_steps)
    weight = unet.conv_in.weight
    dev, dt = weight.device, weight.dtype
    lat = torch.as_tensor(video_latents, device=dev).float()
    ctx = torch.as_tensor(context, device=dev).to(dt)
    b = lat.shape[0]
    for t in sched.timesteps[::-1]:
        tt = torch.full((b,), int(t), device=dev, dtype=torch.int64)
        eps = unet(lat.to(dt), tt, ctx).float()
        lat = sched.inverse_step(eps, t, lat)
    return lat
