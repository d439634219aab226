"""Differential-entropy / power-spectral-density band features.

Counterpart of ``eeg2video_tpu/dsp/de_psd.py``. The reference computes DE/PSD
with a per-channel Python loop over 86,800 scipy FFTs plus a scalar
band-accumulation loop (reference DE_PSD.py:55-68). Here the whole computation
is two matrix products on the device:

    features = |(x * hann)[..., :200] @ DFT_basis|^2 @ band_matrix

Behavioral quirks of the reference are reproduced exactly (they are
output-affecting):

1. the nonstandard Hann window ``0.5 - 0.5*cos(2*pi*n/(H+1))`` for n=1..H
   (DE_PSD.py:51), not scipy/numpy ``hanning``;
2. ``fft(x, n=200)`` semantics: the windowed signal is *truncated* to its
   first 200 samples when longer (2 s windows, H=400) and zero-padded when
   shorter (0.5 s windows, H=100) (DE_PSD.py:58);
3. per-band energy averages bins ``[int(fStart/fs*200) - 1, int(fEnd/fs*200))``,
   an off-by-one window whose first bin overlaps the previous band, and
   normalises by ``fEnd - fStart + 1`` (DE_PSD.py:63-66);
4. ``psd = E`` and ``de = log2(100 * E)`` (DE_PSD.py:67-68).

Precision: :func:`de_psd_numpy` (vectorised float64) is the oracle.
:func:`de_psd` windows the signal in float32, as the JAX function does, and
forms both products in float64: the DFT sums cancel heavily, and a float32
product that the device runs in reduced precision (TF32 tensor cores, the
GPU's counterpart of the bf16 passes the JAX function avoids with
``Precision.HIGHEST``) costs ~3e-3 on the band energies. A float64 product has
no reduced-precision mode, so the result does not depend on
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision``; the products are 200x100 and 100x5,
far too small for the wider type to matter for time. Outputs are float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data import meta
from ..utils import resolve_device

STFTN = 200  # frequency-domain sampling rate (reference DE_PSD.py:27)
N_BINS = STFTN // 2


def hann_window_ref(length: int, dtype=np.float64) -> np.ndarray:
    """The reference's Hann variant: 0.5 - 0.5*cos(2*pi*n/(H+1)), n = 1..H."""
    n = np.arange(1, length + 1, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length + 1))).astype(dtype)


def _band_bounds(fs: int):
    """Integer bin bounds per band: int(f/fs*STFTN) for start and end."""
    starts = [int(f / fs * STFTN) for f in meta.BAND_STARTS_HZ]
    ends = [int(f / fs * STFTN) for f in meta.BAND_ENDS_HZ]
    return starts, ends


@functools.lru_cache(maxsize=8)
def _band_matrix(fs: int, dtype_name: str = "float64") -> np.ndarray:
    """(N_BINS, 5) matrix: column p averages |X|^2 over the reference's
    off-by-one band window [starts[p]-1, ends[p]) with weight
    1/(ends[p]-starts[p]+1)."""
    starts, ends = _band_bounds(fs)
    B = np.zeros((N_BINS, meta.N_BANDS), dtype=np.float64)
    for p in range(meta.N_BANDS):
        lo, hi = starts[p] - 1, ends[p]
        B[lo:hi, p] = 1.0 / (ends[p] - starts[p] + 1)
    return B.astype(dtype_name)


@functools.lru_cache(maxsize=4)
def _dft_bases(dtype_name: str = "float64"):
    """Real/imag DFT bases of shape (STFTN, N_BINS): ``x @ cos_basis`` and
    ``x @ sin_basis`` give Re/Im of the first 100 bins of a 200-point DFT."""
    n = np.arange(STFTN, dtype=np.float64)[:, None]
    k = np.arange(N_BINS, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / STFTN
    return np.cos(ang).astype(dtype_name), (-np.sin(ang)).astype(dtype_name)


def de_psd(x, fs: int = meta.FS, win_sec: float = 2.0, device="cuda"):
    """Compute (de, psd) band features for windows ``x`` of shape (..., T).

    Numerical equivalent of reference ``DE_PSD(data, fre, time_window)``
    (DE_PSD.py:8-71), batched over arbitrary leading axes: e.g. the full
    (7, 40, 5, 62, 400) tensor at once. ``x`` is a numpy array, moved to
    ``device`` (the card unless the caller names the CPU; raises where there
    is no card), or a tensor, computed where it lies.

    Returns float32 tensors ``(de, psd)`` of shape ``x.shape[:-1] + (5,)``.
    """
    H = int(round(fs * win_sec))
    if x.shape[-1] != H:
        raise ValueError(f"expected last axis {H} (= fs*win_sec), got {x.shape[-1]}")
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32)).to(resolve_device(device))
    dev = x.device
    xw = x.float() * torch.from_numpy(hann_window_ref(H, np.float32)).to(dev)
    # fft(x, n=STFTN): truncate to the first STFTN samples, or zero-pad
    xw = xw[..., :STFTN] if H >= STFTN else torch.nn.functional.pad(xw, (0, STFTN - H))
    flat = xw.reshape(-1, STFTN).double()
    cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _dft_bases())
    re, im = flat @ cos_b, flat @ sin_b
    mag2 = re * re + im * im  # |X_k|^2, first 100 bins
    psd = mag2 @ torch.from_numpy(_band_matrix(fs)).to(dev)
    de = torch.log2(100.0 * psd)
    shape = xw.shape[:-1] + (meta.N_BANDS,)
    return de.float().reshape(shape), psd.float().reshape(shape)


def de_psd_numpy(data: np.ndarray, fre: int = meta.FS, time_window: float = 2.0):
    """Float64 NumPy oracle with the reference's exact call convention:
    ``(n_channels, T) -> (de, psd)`` each (n_channels, 5); implements the same
    math as :func:`de_psd` without torch.

    Runs chunked over a reused scratch buffer with ``rfft``: whole-subject
    f64 temporaries hit pathological first-touch page-fault cost on small
    VMs, and numpy's complex ``fft`` is ~100x slower than the real path at
    this shape.  rfft of a real signal is the same DFT: bins match ``fft`` to
    float64 rounding.  Only the first STFTN window taps are applied because
    ``fft(x, n=STFTN)`` truncates the signal anyway (reference DE_PSD.py:58).
    """
    H = int(round(fre * time_window))
    assert data.shape[-1] == H
    w = hann_window_ref(H)
    lead = data.shape[:-1]
    flat = data.reshape(-1, H)
    n = flat.shape[0]
    band = _band_matrix(fre, "float64")
    psd = np.empty((n, band.shape[1]), np.float64)
    chunk = min(n, 4096)
    buf = np.zeros((chunk, STFTN), np.float64)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        if H >= STFTN:
            np.multiply(flat[i:i + m, :STFTN], w[:STFTN], out=buf[:m])
        else:
            np.multiply(flat[i:i + m], w, out=buf[:m, :H])
        X = np.fft.rfft(buf[:m], n=STFTN, axis=-1)[..., :N_BINS]
        mag2 = np.abs(X)
        np.square(mag2, out=mag2)
        np.matmul(mag2, band, out=psd[i:i + m])
    psd = psd.reshape(lead + (band.shape[1],))
    de = np.log2(100.0 * psd)
    return de, psd
