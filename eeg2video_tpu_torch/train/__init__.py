"""The fine-tune training path (the video-diffusion train step and its
checkpoints) and the Seq2Seq stage's inference helpers."""

from .videodiffusion import unet_tp_rules

__all__ = ["unet_tp_rules"]
