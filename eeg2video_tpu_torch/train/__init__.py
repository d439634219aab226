"""The fine-tune training path: the video-diffusion train step and its
checkpoints."""
