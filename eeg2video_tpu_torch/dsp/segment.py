"""EEG segmentation as single gather expressions (numpy, host side).

Counterpart of ``eeg2video_tpu/dsp/segment.py``: the same index math, which
replaces the reference's triple-nested Python loops
(reference segment_raw_signals_200Hz.py:97-108) and its
``sliding_window_view`` pipeline (reference segment_sliding_window.py:6-21).
"""

from __future__ import annotations

import numpy as np

from ..data import meta


def extract_2s_segment(data, block: int, concept: int, repetition: int, fs: int = meta.FS):
    """One raw 2 s segment (62, 2*fs) from a (7, 62, T) recording.

    Same index math and validation as the reference
    (segment_raw_signals_200Hz.py:49-69).
    """
    if not 0 <= block < meta.N_BLOCKS:
        raise ValueError("`block` must be in [0, 6]")
    if not 0 <= concept < meta.N_CONCEPTS:
        raise ValueError("`concept` must be in [0, 39]")
    if not 0 <= repetition < meta.N_REPS:
        raise ValueError("`repetition` must be in [0, 4]")
    start, end = meta.concept_clip_slice(concept, repetition, fs)
    seg = data[block][:, start:end]
    if seg.shape[-1] != 2 * fs:
        raise RuntimeError("Segment length mismatch")
    return seg


def _clip_starts(fs: int) -> np.ndarray:
    """Start sample of each (concept, rep) clip within a block, shape (40, 5)."""
    baseline = meta.BASELINE_SEC * fs
    clip_len = meta.CLIP_SEC * fs
    stride = baseline + meta.N_REPS * clip_len
    concepts = np.arange(meta.N_CONCEPTS)[:, None] * stride
    reps = np.arange(meta.N_REPS)[None, :] * clip_len
    return concepts + reps + baseline


def segment_block(block_data, fs: int = meta.FS):
    """(62, T) block recording -> (40, 5, 62, 2*fs) via one vectorised gather."""
    idx = _clip_starts(fs)[..., None] + np.arange(2 * fs)  # (40, 5, 2*fs)
    segs = np.take(np.asarray(block_data), idx, axis=-1)
    # gather along time, then channels in front of time
    return np.moveaxis(segs, -4, -2) if segs.ndim == 4 else segs


def segment_subject(data, fs: int = meta.FS):
    """(7, 62, T) raw recording -> (7, 40, 5, 62, 2*fs).

    Equivalent to reference ``segment_all_files`` inner loops
    (segment_raw_signals_200Hz.py:97-108), as one gather.
    """
    idx = _clip_starts(fs)[..., None] + np.arange(2 * fs)  # (40, 5, 400)
    segs = np.take(np.asarray(data), idx, axis=-1)  # (7, 62, 40, 5, 400)
    return np.transpose(segs, (0, 2, 3, 1, 4))


def sliding_windows(data, win_s: float = 0.5, step_s: float = 0.25, fs: int = meta.FS):
    """(..., C, T) -> (..., n_windows, C, win) sliding windows.

    Matches reference ``seg_sliding_window`` (segment_sliding_window.py:6-21):
    windows of ``win_s`` seconds every ``step_s`` seconds, window axis placed
    *before* the channel axis.  For the canonical (7,40,5,62,400) input with
    0.5 s / 0.25 s this yields (7,40,5,7,62,100).
    """
    data = np.asarray(data)
    win_t = int(fs * win_s)
    step_t = int(fs * step_s)
    n_win = (data.shape[-1] - win_t) // step_t + 1
    idx = (np.arange(n_win) * step_t)[:, None] + np.arange(win_t)  # (n_win, win_t)
    w = np.take(data, idx, axis=-1)  # (..., C, n_win, win_t)
    return np.moveaxis(w, -2, -3)
