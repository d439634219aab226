"""Zero-phase IIR filtering of many rows: ``sos_filtfilt`` / ``tf_filtfilt``
(the CUDA kernel ``csrc/sos_filtfilt.cu``) and their plain PyTorch version.

Replaces no Pallas kernel: the JAX package runs the recursion as one
``lax.scan`` over time (eeg2video_tpu/dsp/bandpass.py:177 ``_sos_scan``, :215
``_filtfilt_sos_jit``; :155 ``_lfilter_scan``, :207 ``_filtfilt_tf_jit``). On
the card one launch does the whole filtfilt of x (R, T): the odd extension of
``padlen`` samples read by index, the forward pass from ``zi * ext[0]`` into a
workspace (R, T + 2 padlen) this wrapper allocates, the backward pass from
``zi * y_fwd[-1]``, the crop.

Two forms share the kernel and the plain version: a cascade of biquads
(``sos_filtfilt``, direct form II transposed a section, ``_sos_scan``'s order
of operations) and one section of order K (``tf_filtfilt``,
``_lfilter_scan``'s). Coefficients go to the kernel as (S, 2K + 1) rows
``[b0..bK, a1..aK]`` and the initial state as (S, K), in x's dtype (float32 or
float64). Every product and sum is rounded on its own in both versions, so on
the card they agree to the bit.

The plain version is eager: each step advances every row at once. The
biquads run as a wavefront (at step k section j takes sample k - j, the output
of section j - 1 one step before), so that a step is one set of ops on (R, S)
tensors and not S sets; every value sees the same operations in the same
order as in the sequential cascade.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

MAX_SECTIONS = 8   # biquads the kernel takes (csrc/sos_filtfilt.cu kMaxSections)
MAX_ORDER = 16     # order of the transfer-function form it takes (kMaxOrder; odd ones
                   # as the next even one)


def _odd_ext(x, padlen: int):
    """bandpass.py:200 ``_odd_ext`` on a (R, T) tensor."""
    if padlen == 0:
        return x
    left = 2.0 * x[:, :1] - x[:, 1:padlen + 1].flip(-1)
    right = 2.0 * x[:, -1:] - x[:, -padlen - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _biquads(u, y, coef, z0, z1, t0, t1):
    """One step of biquads side by side (``_sos_scan``'s arithmetic): inputs
    u (R, S'), outputs into y, states z0, z1 updated in place."""
    b0, b1, b2, a1, a2 = coef
    torch.add(torch.mul(u, b0, out=t0), z0, out=y)
    torch.mul(u, b1, out=t0)
    torch.add(torch.sub(t0, torch.mul(y, a1, out=t1), out=t0), z1, out=z0)
    torch.mul(u, b2, out=t0)
    torch.sub(t0, torch.mul(y, a2, out=t1), out=z1)


def _sos_pass(sos, x, z):
    """The biquad cascade over time: sos (S, 6), x (R, N), z (R, S, 2) -> y (R, N).
    A wavefront: at step k section j takes sample k - j. ``U[k, :, 0]`` is
    x[:, k]; ``U[k + 1, :, 1 + j]`` is section j's output at step k, the input
    of section j + 1 at step k + 1."""
    r, n = x.shape
    s = sos.shape[0]
    coef = [sos[:, i].contiguous() for i in (0, 1, 2, 4, 5)]
    z0, z1 = z[..., 0].contiguous(), z[..., 1].contiguous()
    U = x.new_zeros((n + s, r, s + 1))
    U[:n, :, 0] = x.T
    t0, t1 = torch.empty_like(z0), torch.empty_like(z0)
    for k in range(n + s - 1):
        lo, hi = max(0, k - n + 1), min(s, k + 1)  # the sections with a sample this step
        if (lo, hi) == (0, s):
            _biquads(U[k, :, :s], U[k + 1, :, 1:], coef, z0, z1, t0, t1)
        else:  # the first and last s - 1 steps
            c = slice(lo, hi)
            u = U[k, :, c]
            _biquads(u, U[k + 1, :, lo + 1:hi + 1], [v[c] for v in coef], z0[:, c], z1[:, c],
                     torch.empty_like(u), torch.empty_like(u))
    return U[s:, :, s].T


def _tf_pass(b, a, x, z):
    """One section of order K over time (``_lfilter_scan``): b, a (K + 1,),
    x (R, N), z (R, K) -> y (R, N)."""
    z = z.clone()
    y = torch.empty_like(x)
    b0, b_rest, a_rest = b[0], b[1:], a[1:]
    zero = torch.zeros_like(z[:, :1])
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        yt = b0 * xt + z[:, :1]
        z = (torch.cat([z[:, 1:], zero], dim=1) + b_rest * xt) - a_rest * yt
        y[:, t] = yt[:, 0]
    return y


def filtfilt_plain(x, coef, zi, padlen: int, tf: bool):
    """The plain version of both forms on (R, T): ``coef`` (S, 6) biquads
    (``tf`` False) or (2, K + 1) rows b and a (``tf`` True); ``zi`` (S, 2) or
    (K,), in x's dtype."""
    if tf:
        run, state = (lambda v, z: _tf_pass(coef[0], coef[1], v, z)), (lambda v: zi * v)
    else:
        run, state = (lambda v, z: _sos_pass(coef, v, z)), (lambda v: zi * v[..., None])
    ext = _odd_ext(x, padlen)
    y = run(ext, state(ext[:, :1]))  # from the steady state for ext[0]
    y = run(y.flip(-1), state(y[:, -1:])).flip(-1)  # and for the forward pass's last sample
    return y[:, padlen:y.shape[1] - padlen]


def _launch(x, coef_rows, zi_rows, padlen: int, sections: int, order: int, tf: bool):
    kernel = "sos_filtfilt" if x.dtype == torch.float32 else "sos_filtfilt_f64"
    req = _build.require
    req(x.dtype in (torch.float32, torch.float64), "sos_filtfilt",
        f"x must be float32 or float64, got {x.dtype}")
    req(x.dim() == 2 and x.shape[0] >= 1, kernel, "x must be a non-empty (R, T) tensor")
    r, t = x.shape
    req(t > padlen >= 0, kernel, f"T = {t} must exceed padlen = {padlen}")
    if tf:
        req(1 <= order <= MAX_ORDER, kernel,
            f"the transfer-function form takes orders 1..{MAX_ORDER}, got {order}")
    else:
        req(1 <= sections <= MAX_SECTIONS, kernel,
            f"the cascade takes 1..{MAX_SECTIONS} biquads, got {sections}")
    xc = x.contiguous()
    coef_t = torch.as_tensor(np.ascontiguousarray(coef_rows)).to(x.device, x.dtype)
    zi_t = torch.as_tensor(np.ascontiguousarray(zi_rows)).to(x.device, x.dtype)
    out = torch.empty_like(xc)
    ws = torch.empty((r, t + 2 * padlen), dtype=x.dtype, device=x.device)
    rc = _build.library().e2v_sos_filtfilt(
        xc.data_ptr(), out.data_ptr(), ws.data_ptr(), coef_t.data_ptr(), zi_t.data_ptr(), r, t,
        padlen, sections, order, int(tf), int(x.dtype == torch.float64), _build.stream_of(x))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out


def sos_filtfilt(x, sos, zi, padlen: int):
    """Zero-phase biquad cascade over the last axis of x (R, T), float32 or
    float64: ``sos`` (S, 6) rows [b0, b1, b2, 1, a1, a2], ``zi`` (S, 2) the
    steady-state state for a unit input (numpy float64; cast to x's dtype). A
    CUDA tensor launches the kernel; a CPU tensor takes ``filtfilt_plain``."""
    sos = np.asarray(sos, np.float64)
    zi = np.asarray(zi, np.float64)
    if not x.is_cuda:
        return filtfilt_plain(x, torch.as_tensor(sos).to(x.dtype),
                              torch.as_tensor(zi).to(x.dtype), padlen, tf=False)
    coef = sos[:, [0, 1, 2, 4, 5]]
    return _launch(x, coef, zi, padlen, sections=sos.shape[0], order=2, tf=False)


def tf_filtfilt(x, b, a, zi, padlen: int):
    """Zero-phase filtering by one section of order K = len(a) - 1 in the
    transfer-function form (b and a of equal length, a[0] taken as 1 as
    ``_lfilter_scan`` takes it), ``zi`` (K,). A CUDA tensor launches the
    kernel; a CPU tensor takes ``filtfilt_plain``."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    zi = np.asarray(zi, np.float64)
    if not x.is_cuda:
        coef = torch.as_tensor(np.stack([b, a])).to(x.dtype)
        return filtfilt_plain(x, coef, torch.as_tensor(zi).to(x.dtype), padlen, tf=True)
    order = len(a) - 1
    if order % 2 and order < MAX_ORDER:  # the kernel takes even orders: one zero term more
        b, a, zi, order = np.append(b, 0.0), np.append(a, 0.0), np.append(zi, 0.0), order + 1
    coef = np.concatenate([b, a[1:]])[None]
    return _launch(x, coef, zi[None], padlen, sections=1, order=order, tf=True)
