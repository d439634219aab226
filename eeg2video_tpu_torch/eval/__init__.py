"""Evaluation of generated clips (counterpart of ``eeg2video_tpu/eval``)."""

from .metrics import (
    hue_score_only,
    mse_score_only,
    n_way_top_k_acc,
    psnr_score_only,
    ssim,
    ssim_score_only,
)

__all__ = ["hue_score_only", "mse_score_only", "n_way_top_k_acc", "psnr_score_only", "ssim",
           "ssim_score_only"]
