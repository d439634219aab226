"""The inference helpers of the Seq2Seq stage: the 100/50 windowing of 2 s
segments, the reference's data plumbing and the chunked rollout. Counterpart
of ``windows_from_segments``, ``prepare_seq2seq_data`` and ``rollout_latents``
of ``eeg2video_tpu/train/seq2seq.py``; the trainer there is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import meta
from ..utils import StandardScaler

# Rows per dispatch in rollout_latents; the warm server's Seq2Seq runtime goes
# through the same function, so a file-chained run and the server run one
# shape: a different batch shape may be summed in another order.
ROLLOUT_CHUNK = 50


def pad_rows(x, chunk):
    """Zero-pad axis 0 of ``x`` up to a multiple of ``chunk``."""
    pad = (-len(x)) % chunk
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


def windows_from_segments(seg: np.ndarray) -> np.ndarray:
    """(..., C, 400) 2 s raw segments -> (..., 7, C, 100) sliding windows
    (100 samples every 50, reference my_autoregressive_transformer.py:309-314):
    the Seq2Seq model's input contract."""
    if seg.shape[-1] != 400:
        raise ValueError(f"expected 400-sample segments, got {seg.shape}")
    return np.stack([seg[..., i:i + 100] for i in range(0, 301, 50)], axis=-3)


def prepare_seq2seq_data(raw_eeg: np.ndarray, train_latents: np.ndarray,
                         test_latents: np.ndarray):
    """Reproduces the reference data plumbing (L278-340): GT-label reorder of
    EEG and latents, 100/50 windowing of the 400-sample segments, blocks 0-5
    train / 6 test, StandardScaler fit on flattened train EEG applied to both.

    raw_eeg: (7, 40, 5, 62, 400); train_latents: (1200, 4, 6, 36, 64)
    (the 1200_latent.npy layout); test_latents: (200, 4, 6, 36, 64).
    Returns (train_eeg (1200,7,62,100), train_lat (1200,6,4,36,64),
             test_eeg (200,7,62,100), test_lat (200,6,4,36,64), scaler).
    """
    # reorder presentation order -> class order per block (L289-304)
    eeg = np.stack([meta.reorder_by_gt(raw_eeg[b], b) for b in range(7)])
    lat = train_latents.reshape(6, 40, 5, *train_latents.shape[1:])
    lat = np.stack([meta.reorder_by_gt(lat[b], b) for b in range(6)])
    lat = lat.reshape(-1, *train_latents.shape[1:])  # (1200, 4, 6, 36, 64)

    # 400 -> 7 windows of 100 every 50 (L309-314), window axis first
    win = windows_from_segments(eeg)
    # win: (7, 40, 5, 7w, 62, 100) -> flatten trials
    win = win.reshape(7, 40 * 5, 7, 62, 100)
    train_eeg = win[:6].reshape(-1, 7, 62, 100)
    test_eeg = win[6]

    scaler = StandardScaler().fit(train_eeg.reshape(len(train_eeg), -1))
    train_eeg = scaler.transform(train_eeg.reshape(len(train_eeg), -1)).reshape(-1, 7, 62, 100)
    test_eeg = scaler.transform(test_eeg.reshape(len(test_eeg), -1)).reshape(-1, 7, 62, 100)

    # latents 'b c f h w -> b f c h w' (L333-334)
    train_lat = np.transpose(lat, (0, 2, 1, 3, 4)).astype(np.float32)
    test_lat = np.transpose(np.asarray(test_latents), (0, 2, 1, 3, 4)).astype(np.float32)
    return train_eeg, train_lat, test_eeg, test_lat, scaler


def rollout_latents(model, eeg, batch_size: int = ROLLOUT_CHUNK) -> np.ndarray:
    """Inference rollout of a ``Seq2SeqTransformer`` (in eval mode, on its
    device) over (N, 7, 62, 100) windows -> (N, F, C, H, W) float32 latents,
    the latent_out_block7_40_classes.npy artifact (reference L377-387). The
    final ragged chunk is zero-padded to ``batch_size`` (batch elements are
    independent) so that every dispatch has one shape."""
    device = next(model.parameters()).device
    n = len(eeg)
    eeg = pad_rows(np.asarray(eeg, np.float32), batch_size)
    with torch.inference_mode():
        outs = [model(torch.from_numpy(eeg[s:s + batch_size]).to(device))[1][:, :-1]
                .float().cpu().numpy() for s in range(0, len(eeg), batch_size)]
    return np.concatenate(outs)[:n]
