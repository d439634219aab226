"""Canonical SEED-DV dataset metadata (a copy of the JAX package's
``data/meta.py``: numpy only, the port imports nothing of that package).

The reference repo copy-pastes the 7x40 ``GT_label`` class-permutation table
into seven different scripts (e.g. reference EEG-VP/EEG_VP_train_test.py:188,
EEG2Video_New/DANA/add_noise.py:83, Seq2Seq/my_autoregressive_transformer.py:262,
Semantic/eeg_text.py:59).  Here it lives exactly once, together with every
other dataset-geometry invariant (see SURVEY.md section 1).

Dataset geometry (per subject):
- 7 blocks of 62-channel 200 Hz EEG; each block is 40 concepts x
  (3 s hint + 5 x 2 s clips)  (reference segment_raw_signals_200Hz.py:58-65)
- video side: 24 fps, GIFs are 6 frames @ 288x512
- blocks 0..5 are the train split, block 6 the test split, everywhere.
"""

from __future__ import annotations

import numpy as np

# --- scalar invariants -------------------------------------------------------
FS = 200  # EEG sampling rate (Hz)
N_BLOCKS = 7
N_CONCEPTS = 40  # concepts per block
N_REPS = 5  # 2-second clips per concept
N_CHANNELS = 62
BASELINE_SEC = 3  # hint length before each concept's clips
CLIP_SEC = 2
VIDEO_FPS = 24
GIF_FRAMES = 6
GIF_HEIGHT = 288
GIF_WIDTH = 512
LATENT_CHANNELS = 4
LATENT_HEIGHT = 36  # 288 / 8
LATENT_WIDTH = 64  # 512 / 8

# occipital electrode subset used by the "local" branch of GLFNet
# (reference models.py:358,398: channels 50..61)
OCCIPITAL_CHANNELS = tuple(range(50, 62))

# frequency bands for DE/PSD (Hz): delta, theta, alpha, beta, gamma
# (reference DE_PSD.py:28-29)
BAND_STARTS_HZ = (1, 4, 8, 14, 31)
BAND_ENDS_HZ = (4, 8, 14, 31, 99)
N_BANDS = 5
BAND_NAMES = ("delta", "theta", "alpha", "beta", "gamma")

# --- the class-order permutation table ---------------------------------------
# GT_LABEL[b, i] is the 1-indexed concept id shown at position ``i`` of block
# ``b``.  Dataset metadata, identical to the table the reference embeds in
# seven scripts (values from the SEED-DV stimulus ordering).
GT_LABEL = np.array(
    [
        [23, 22, 9, 6, 18, 14, 5, 36, 25, 19, 28, 35, 3, 16, 24, 40, 15, 27, 38, 33,
         34, 4, 39, 17, 1, 26, 20, 29, 13, 32, 37, 2, 11, 12, 30, 31, 8, 21, 7, 10],
        [27, 33, 22, 28, 31, 12, 38, 4, 18, 17, 35, 39, 40, 5, 24, 32, 15, 13, 2, 16,
         34, 25, 19, 30, 23, 3, 8, 29, 7, 20, 11, 14, 37, 6, 21, 1, 10, 36, 26, 9],
        [15, 36, 31, 1, 34, 3, 37, 12, 4, 5, 21, 24, 14, 16, 39, 20, 28, 29, 18, 32,
         2, 27, 8, 19, 13, 10, 30, 40, 17, 26, 11, 9, 33, 25, 35, 7, 38, 22, 23, 6],
        [16, 28, 23, 1, 39, 10, 35, 14, 19, 27, 37, 31, 5, 18, 11, 25, 29, 13, 20, 24,
         7, 34, 26, 4, 40, 12, 8, 22, 21, 30, 17, 2, 38, 9, 3, 36, 33, 6, 32, 15],
        [18, 29, 7, 35, 22, 19, 12, 36, 8, 15, 28, 1, 34, 23, 20, 13, 37, 9, 16, 30,
         2, 33, 27, 21, 14, 38, 10, 17, 31, 3, 24, 39, 11, 32, 4, 25, 40, 5, 26, 6],
        [29, 16, 1, 22, 34, 39, 24, 10, 8, 35, 27, 31, 23, 17, 2, 15, 25, 40, 3, 36,
         26, 6, 14, 37, 9, 12, 19, 30, 5, 28, 32, 4, 13, 18, 21, 20, 7, 11, 33, 38],
        [38, 34, 40, 10, 28, 7, 1, 37, 22, 9, 16, 5, 12, 36, 20, 30, 6, 15, 35, 2,
         31, 26, 18, 24, 8, 3, 23, 19, 14, 13, 21, 4, 25, 11, 32, 17, 39, 29, 33, 27],
    ],
    dtype=np.int64,
)
assert GT_LABEL.shape == (N_BLOCKS, N_CONCEPTS)
# every row is a permutation of 1..40
assert all(sorted(row) == list(range(1, 41)) for row in GT_LABEL)

# canonical tensor shapes of every inter-stage artifact (SURVEY.md section 1)
SHAPES = {
    "segmented_raw_2s": (N_BLOCKS, N_CONCEPTS, N_REPS, N_CHANNELS, 2 * FS),
    "segmented_500ms_sw": (N_BLOCKS, N_CONCEPTS, N_REPS, 7, N_CHANNELS, FS // 2),
    "de_1per2s": (N_BLOCKS, N_CONCEPTS, N_REPS, N_CHANNELS, N_BANDS),
    "de_1per500ms": (N_BLOCKS, N_CONCEPTS, N_REPS, 7, N_CHANNELS, N_BANDS),
    "de_1per1s": (N_BLOCKS, N_CONCEPTS, N_REPS, 2, N_CHANNELS, N_BANDS),
    "train_latents": (1200, LATENT_CHANNELS, GIF_FRAMES, LATENT_HEIGHT, LATENT_WIDTH),
    "test_latents": (200, LATENT_CHANNELS, GIF_FRAMES, LATENT_HEIGHT, LATENT_WIDTH),
    "text_embedding": (77, 768),
}


def block_reorder_indices(block: int, chosen_labels=None) -> np.ndarray:
    """Indices that reorder a block's presentation order into label order.

    ``out[j]`` is the position within ``block`` at which concept
    ``chosen_labels[j]`` was shown; gathering a block-ordered array with it
    yields class-sorted data.  Mirrors ``[list(GT_label[i]).index(element)
    for element in chosed_label]`` (reference my_autoregressive_transformer.py:290).
    """
    if chosen_labels is None:
        chosen_labels = range(1, N_CONCEPTS + 1)
    row = list(GT_LABEL[block])
    return np.array([row.index(lbl) for lbl in chosen_labels], dtype=np.int64)


def reorder_by_gt(x: np.ndarray, block: int, axis: int = 0) -> np.ndarray:
    """Gather ``x`` (presentation order along ``axis``) into class order."""
    return np.take(x, block_reorder_indices(block), axis=axis)


def all_labels(reps: int = N_REPS) -> np.ndarray:
    """0-indexed class labels in presentation order, shape (7, 40*reps).

    Mirrors the reference's ``GT_label - 1`` then ``repeat(reps)`` pattern
    (reference train_finetune_videodiffusion.py:55-58).
    """
    return np.repeat(GT_LABEL - 1, reps, axis=1)


def train_test_split_blocks(test_block: int = 6):
    """Blocks 0..5 train / block 6 test is the canonical split; the EEG-VP
    benchmark additionally runs leave-one-block-out with val = test_block-1
    (reference EEG_VP_train_test.py:238-241)."""
    train = [b for b in range(N_BLOCKS) if b != test_block]
    return train, test_block


def concept_clip_slice(concept: int, repetition: int, fs: int = FS):
    """Sample range of one 2 s clip inside a block's raw (62, T) recording.

    Index math from reference segment_raw_signals_200Hz.py:58-65:
    ``start = concept*(3*fs + 5*2*fs) + 3*fs + repetition*2*fs``.
    """
    baseline = BASELINE_SEC * fs
    clip_len = CLIP_SEC * fs
    stride = baseline + N_REPS * clip_len
    start = concept * stride + baseline + repetition * clip_len
    return start, start + clip_len
