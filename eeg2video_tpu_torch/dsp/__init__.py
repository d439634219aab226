"""EEG signal processing: 2 s segmentation and DE / PSD band features."""

from .segment import (  # noqa: F401
    extract_2s_segment,
    segment_block,
    segment_subject,
    sliding_windows,
)
from .de_psd import de_psd, de_psd_numpy, hann_window_ref  # noqa: F401
