"""The fine-tune training path (the video-diffusion train step on one GPU or
a (dp, sp, tp) mesh, and its checkpoints) and the Seq2Seq stage's inference
helpers."""

from .videodiffusion import (TrainState, init_video_train_state, train_epoch, train_step,
                             unet_tp_rules)

__all__ = ["TrainState", "init_video_train_state", "train_epoch", "train_step", "unet_tp_rules"]
