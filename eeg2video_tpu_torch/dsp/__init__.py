"""EEG signal processing: the Butterworth bandpass, 2 s segmentation and DE /
PSD band features."""

from .segment import (  # noqa: F401
    extract_2s_segment,
    segment_block,
    segment_subject,
    sliding_windows,
)
from .de_psd import de_psd, de_psd_numpy, hann_window_ref  # noqa: F401
from .bandpass import (  # noqa: F401
    bandpass_filter,
    butter_bandpass,
    butter_bandpass_sos,
    filtfilt,
    lfilter_zi,
    sos_filtfilt,
)
