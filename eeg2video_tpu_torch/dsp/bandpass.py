"""Zero-phase Butterworth bandpass filtering of raw EEG.

Counterpart of ``eeg2video_tpu/dsp/bandpass.py``:

- the design, on the host in numpy float64, is a copy of the JAX package's
  (``_butter_bandpass_zpk`` :47, ``butter_bandpass`` :79,
  ``butter_bandpass_sos`` :91, ``lfilter_zi`` :120, ``_sos_zi`` :139), bit for
  bit: scipy.signal.butter's (b, a), and the same filter as biquads;
- ``filtfilt`` / ``sos_filtfilt`` / ``bandpass_filter`` filter along the last
  axis with scipy.signal.filtfilt's edge handling (odd extension of ``padlen``
  samples, steady-state initial conditions scaled by the first sample forward
  and by the forward pass's last sample backward). The recursion is the
  ``ops.iir`` kernel on the card (one launch a call; the transfer-function
  form as one section of order len(a) - 1, the SOS form as a cascade of S
  biquads), its plain version on the CPU.

The transfer-function recursion amplifies float32 roundoff (0.33 absolute at
order 4, bandpass.py:12-17 of the JAX package), so ``bandpass_filter`` uses
the cascade. A numpy array goes to ``device`` (the card unless the caller
names the CPU); a tensor is filtered where it lies. The float dtype is kept
(integers become float32, as in ``_float_dtype`` :222); the kernel takes
float32 and float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import iir
from ..utils import resolve_device


# ---------------------------------------------------------------------------
# Coefficient design (host-side numpy float64)
# ---------------------------------------------------------------------------

def _butter_bandpass_zpk(order: int, low: float, high: float, fs: float):
    if not 0 < low < high < fs / 2:
        raise ValueError(f"need 0 < low < high < fs/2, got {low}, {high}, {fs}")
    # normalized band edges in half-cycles/sample, pre-warped for bilinear
    wn = np.array([low, high], np.float64) / (fs / 2.0)
    fs_d = 2.0
    warped = 2.0 * fs_d * np.tan(np.pi * wn / fs_d)

    # analog Butterworth lowpass prototype: N poles on the unit circle
    k = np.arange(1, order + 1)
    p = np.exp(1j * np.pi * (2 * k + order - 1) / (2 * order))
    gain = 1.0

    # lowpass -> bandpass (scipy lp2bp_zpk): N zeros at s=0, poles split
    bw = warped[1] - warped[0]
    wo = np.sqrt(warped[0] * warped[1])
    p_scaled = p * bw / 2.0
    disc = np.sqrt(p_scaled**2 - wo**2)
    p_bp = np.concatenate([p_scaled + disc, p_scaled - disc])
    z_bp = np.zeros(order, np.complex128)
    gain = gain * bw**order

    # bilinear transform (scipy bilinear_zpk): zeros land on +1, the degree
    # surplus on -1
    fs2 = 2.0 * fs_d
    z_d = (fs2 + z_bp) / (fs2 - z_bp)
    p_d = (fs2 + p_bp) / (fs2 - p_bp)
    z_d = np.concatenate([z_d, -np.ones(len(p_bp) - len(z_bp))])
    gain = gain * np.real(np.prod(fs2 - z_bp) / np.prod(fs2 - p_bp))
    return z_d, p_d, gain


def butter_bandpass(order: int, low: float, high: float, fs: float):
    """Digital Butterworth bandpass (b, a), scipy.signal.butter semantics.

    order: order of the analog lowpass prototype (the digital filter has
    2*order poles).  low/high in Hz, fs in Hz.
    """
    z, p, k = _butter_bandpass_zpk(order, low, high, fs)
    b = np.real(k * np.poly(z))
    a = np.real(np.poly(p))
    return b, a


def butter_bandpass_sos(order: int, low: float, high: float, fs: float):
    """The same filter as second-order sections, shape (order, 6) rows of
    [b0, b1, b2, 1, a1, a2].

    Every section takes one zero pair (+1, -1) -> numerator proportional to
    [1, 0, -1]; poles are grouped into conjugate (or real) pairs; gain is
    spread evenly across sections to keep f32 intermediate magnitudes tame.
    """
    _, p, k = _butter_bandpass_zpk(order, low, high, fs)
    tol = 1e-9
    complex_p = sorted((x for x in p if x.imag > tol), key=lambda x: -abs(x))
    real_p = sorted((x.real for x in p if abs(x.imag) <= tol), key=abs,
                    reverse=True)
    pairs = [(x, np.conj(x)) for x in complex_p]
    pairs += [(real_p[i], real_p[i + 1]) for i in range(0, len(real_p), 2)]
    assert len(pairs) == order, (len(pairs), order)

    g = abs(k) ** (1.0 / order)  # spread the gain evenly over sections
    sos = np.zeros((order, 6), np.float64)
    for i, (p1, p2) in enumerate(pairs):
        sos[i, :3] = np.array([1.0, 0.0, -1.0]) * g
        if i == 0 and k < 0:
            sos[i, :3] *= -1.0
        sos[i, 3] = 1.0
        sos[i, 4] = -np.real(p1 + p2)
        sos[i, 5] = np.real(p1 * p2)
    return sos


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """scipy.signal.lfilter_zi: steady-state initial conditions of the
    direct-form-II-transposed filter for a unit step input."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    comp = np.zeros((n - 1, n - 1))
    comp[0, :] = -a[1:]
    comp[1:, :-1] = np.eye(n - 2)
    iminus = np.eye(n - 1) - comp.T
    bsum = b[1:] - a[1:] * b[0]
    return np.linalg.solve(iminus, bsum)


def _sos_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state state per section for a unit constant input into the
    cascade: section j's zi is its own lfilter_zi scaled by the DC gain of
    everything before it."""
    n = sos.shape[0]
    zi = np.zeros((n, 2), np.float64)
    scale = 1.0
    for j in range(n):
        b, a = sos[j, :3], sos[j, 3:]
        zi[j] = lfilter_zi(b, a) * scale
        scale *= np.sum(b) / np.sum(a)  # DC gain of section j
    return zi


# ---------------------------------------------------------------------------
# Filtering (the ops.iir kernel on the card)
# ---------------------------------------------------------------------------

def _as_rows(x, padlen: int, device):
    """x (..., T) -> (rows (R, T) in its float dtype, leading shape)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x)).to(resolve_device(device))
    if not x.is_floating_point():
        x = x.float()
    if x.shape[-1] <= padlen:
        raise ValueError(f"input length {x.shape[-1]} must exceed padlen {padlen}")
    return x.reshape(-1, x.shape[-1]), x.shape


def filtfilt(b, a, x, device="cuda"):
    """Zero-phase filtering along the last axis, matching
    ``scipy.signal.filtfilt(b, a, x)`` defaults (odd padding,
    padlen=3*max(len(a), len(b)), lfilter_zi initial conditions).

    Transfer-function form: exact in f64, numerically unsafe in f32 above ~order
    2; prefer ``bandpass_filter`` (SOS)."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    padlen = 3 * max(len(a), len(b))
    rows, shape = _as_rows(x, padlen, device)
    return iir.tf_filtfilt(rows, b, a, lfilter_zi(b, a), padlen).reshape(shape)


def sos_filtfilt(sos, x, padlen: int, device="cuda"):
    """Zero-phase biquad-cascade filtering; the same output as ``filtfilt`` on
    the expanded (b, a) in exact arithmetic, f32-stable."""
    sos = np.asarray(sos, np.float64)
    rows, shape = _as_rows(x, padlen, device)
    return iir.sos_filtfilt(rows, sos, _sos_zi(sos), padlen).reshape(shape)


def bandpass_filter(x, low: float, high: float, fs: float, order: int = 4, device="cuda"):
    """Zero-phase Butterworth bandpass along the last (time) axis —
    scipy.signal.filtfilt(butter(...)) semantics, f32-safe (biquad cascade)."""
    sos = butter_bandpass_sos(order, low, high, fs)
    padlen = 3 * (2 * order + 1)  # matches filtfilt's 3*max(len(a), len(b))
    return sos_filtfilt(sos, x, padlen, device=device)
