"""The port's Butterworth bandpass (dsp/bandpass.py over ops/iir.py) against
the JAX package's, on the CPU, where the filter runs the kernel's plain
version.

Tolerances, with their reasons:
- the design (b, a, the biquads, lfilter_zi, the cascade's zi) is a copy of
  the JAX package's numpy float64 code: bit-equal;
- float32 filtering: the two recursions round in different places (XLA's
  fused scan against eager ops), and the roundoff is amplified by poles near
  the unit circle (a 0.5-1 Hz low edge at 200 Hz): each side is 6-9e-5 of the
  output's max from the float64 result (measured at (3, 62, 400 / 401), three
  seeds), and the two differ by up to 1.2e-4. Held: port against JAX within
  3e-4 of the output's max, and the port's own error against the float64
  result (scipy's sosfiltfilt / filtfilt) at most twice JAX's;
- the transfer-function form at order 2: within 1e-5 of the max (measured
  6.9e-6);
- float64: port against JAX under JAX_ENABLE_X64 (in a subprocess, as
  tests/test_bandpass.py runs its gate) within 1e-6, that test's bound, the
  error measured and printed.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from scipy import signal

from eeg2video_tpu.cli import segment_raw_signals_200hz as jcli
from eeg2video_tpu.dsp import bandpass as jb
from eeg2video_tpu_torch.cli import segment_raw_signals_200hz as tcli
from eeg2video_tpu_torch.dsp import bandpass as tb, segment_subject
from eeg2video_tpu_torch.ops import iir

from test_torch_models import capped_threads

_threads = capped_threads()

F32_VS_JAX = 3e-4     # of the output's max (see above)
TF_VS_JAX = 1e-5      # the order-2 transfer-function form
F64_GATE = 1e-6       # tests/test_bandpass.py::test_filtfilt_matches_scipy_f64_subprocess

DESIGNS = [(4, 1.0, 49.0, 200.0), (2, 4.0, 31.0, 200.0), (5, 8.0, 14.0, 200.0),
           (3, 0.5, 70.0, 1000.0), (4, 0.5, 47.0, 200.0)]


@pytest.mark.parametrize("order,low,high,fs", DESIGNS)
def test_design_is_bit_equal_to_jax(order, low, high, fs):
    b, a = tb.butter_bandpass(order, low, high, fs)
    jb_, ja = jb.butter_bandpass(order, low, high, fs)
    assert np.array_equal(b, jb_) and np.array_equal(a, ja)
    sos = tb.butter_bandpass_sos(order, low, high, fs)
    assert np.array_equal(sos, jb.butter_bandpass_sos(order, low, high, fs))
    assert np.array_equal(tb.lfilter_zi(b, a), jb.lfilter_zi(b, a))
    assert np.array_equal(tb._sos_zi(sos), jb._sos_zi(sos))


def test_design_refuses_bad_band_like_jax():
    for fn in (tb.butter_bandpass, jb.butter_bandpass):
        with pytest.raises(ValueError, match="need 0 < low < high < fs/2"):
            fn(4, 40.0, 30.0, 200.0)


def _rel(got, want, scale):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(scale).max())


@pytest.mark.parametrize("t", [400, 401])
def test_bandpass_and_sos_filtfilt_match_jax_f32(t):
    x = np.random.default_rng(t).standard_normal((3, 62, t)).astype(np.float32)
    sos = jb.butter_bandpass_sos(4, 1.0, 49.0, 200.0)
    exact = signal.sosfiltfilt(sos, x.astype(np.float64), axis=-1, padlen=27)
    want = np.asarray(jb.bandpass_filter(x, 1.0, 49.0, 200.0, order=4))
    for got in (tb.bandpass_filter(x, 1.0, 49.0, 200.0, order=4, device="cpu"),
                tb.sos_filtfilt(sos, torch.from_numpy(x), 27)):
        assert got.dtype == torch.float32 and got.shape == x.shape
        got = got.numpy()
        assert _rel(got, want, want) < F32_VS_JAX
        assert _rel(got, exact, exact) <= 2 * _rel(want, exact, exact)


@pytest.mark.parametrize("t", [400, 401])
def test_filtfilt_transfer_function_form_matches_jax_f32(t):
    x = np.random.default_rng(t).standard_normal((3, 62, t)).astype(np.float32)
    b, a = jb.butter_bandpass(2, 4.0, 31.0, 200.0)
    want = np.asarray(jb.filtfilt(b, a, x))
    got = tb.filtfilt(b, a, x, device="cpu").numpy()
    assert _rel(got, want, want) < TF_VS_JAX


def test_filtfilt_float64_matches_jax_x64_subprocess(tmp_path):
    """JAX in float64 needs JAX_ENABLE_X64, a process-global switch: the JAX
    side runs in a fresh interpreter and writes its outputs to a file."""
    x = np.random.default_rng(1).standard_normal((5, 62, 401))
    np.save(tmp_path / "x.npy", x)
    code = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from eeg2video_tpu.dsp.bandpass import bandpass_filter, butter_bandpass, filtfilt
x = np.load({str(tmp_path / 'x.npy')!r})
b, a = butter_bandpass(4, 1.0, 49.0, 200.0)
np.savez({str(tmp_path / 'jax.npz')!r}, tf=np.asarray(filtfilt(b, a, x)),
         sos=np.asarray(bandpass_filter(x, 1.0, 49.0, 200.0, order=4)))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    want = np.load(tmp_path / "jax.npz")
    b, a = tb.butter_bandpass(4, 1.0, 49.0, 200.0)
    xt = torch.from_numpy(x)
    errs = {"sos": np.abs(tb.bandpass_filter(xt, 1.0, 49.0, 200.0).numpy() - want["sos"]).max(),
            "tf": np.abs(tb.filtfilt(b, a, xt).numpy() - want["tf"]).max()}
    print("float64 port vs JAX (x64), max abs:", errs)
    assert max(errs.values()) < F64_GATE


def test_input_not_longer_than_padlen_is_refused_like_jax():
    x = np.zeros((2, 27), np.float32)  # padlen of an order-4 bandpass: 3 (2 * 4 + 1) = 27
    for fn in (jb.bandpass_filter, lambda *a: tb.bandpass_filter(*a, device="cpu")):
        with pytest.raises(ValueError, match="input length 27 must exceed padlen 27"):
            fn(x, 1.0, 49.0, 200.0)
    b, a = jb.butter_bandpass(2, 4.0, 31.0, 200.0)
    with pytest.raises(ValueError, match="must exceed padlen 15"):
        tb.filtfilt(b, a, np.zeros((1, 15), np.float32), device="cpu")


def test_filters_keep_the_dtype_and_integers_become_float32():
    x = np.arange(2 * 100, dtype=np.int64).reshape(2, 100) % 7
    assert tb.bandpass_filter(x, 1.0, 49.0, 200.0, device="cpu").dtype == torch.float32
    x64 = torch.zeros((1, 100), dtype=torch.float64)
    assert tb.bandpass_filter(x64, 1.0, 49.0, 200.0).dtype == torch.float64


def test_the_card_is_the_default_and_refuses_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tb.bandpass_filter(np.zeros((1, 100), np.float32), 1.0, 49.0, 200.0)


def test_plain_version_is_the_sequential_cascade():
    """The wavefront of ``iir._sos_pass`` (section j at step k takes sample
    k - j) gives the bits of the cascade run section by section over time."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    sos = torch.from_numpy(jb.butter_bandpass_sos(4, 1.0, 49.0, 200.0).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((3, 4, 2)).astype(np.float32))
    got = iir._sos_pass(sos, x, z)
    y = x
    for j in range(4):  # one section over the whole signal, then the next
        b0, b1, b2, _, a1, a2 = sos[j]
        z0, z1, out = z[:, j, 0].clone(), z[:, j, 1].clone(), torch.empty_like(y)
        for t in range(y.shape[1]):
            u = y[:, t]
            yj = b0 * u + z0
            z0 = (b1 * u - a1 * yj) + z1
            z1 = b2 * u - a2 * yj
            out[:, t] = yj
        y = out
    assert torch.equal(got, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_odd_transfer_function_order_as_the_next_even_one_keeps_the_values(dtype):
    """The kernel takes even transfer-function orders; ``iir.tf_filtfilt``
    runs an odd order K on the card as K + 1 with a zero last term of b, a
    and zi. In the plain arithmetic that changes no value."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 300))).to(dtype)
    b, a = signal.butter(3, 0.3)
    zi = tb.lfilter_zi(b, a)
    padded = [np.append(v, 0.0) for v in (b, a, zi)]
    want = iir.filtfilt_plain(x, torch.as_tensor(np.stack([b, a])).to(dtype),
                              torch.as_tensor(zi).to(dtype), 12, tf=True)
    got = iir.filtfilt_plain(x, torch.as_tensor(np.stack(padded[:2])).to(dtype),
                             torch.as_tensor(padded[2]).to(dtype), 12, tf=True)
    assert torch.equal(got, want)


def test_segment_cli_bandpass_matches_jax(tmp_path):
    """Two channels of a whole subject (7 blocks of 104,000 samples, float64
    on disk): both CLIs filter in float32 and write float64 segments."""
    raw = np.random.default_rng(2).standard_normal((7, 2, 104000))
    (tmp_path / "raw").mkdir()
    np.save(tmp_path / "raw" / "sub1.npy", raw)
    flags = ["--eeg_root", str(tmp_path / "raw"), "--subs", "1", "--bandpass", "0.5", "47",
             "--bandpass_order", "4"]
    jcli.main(flags + ["--output_dir", str(tmp_path / "jax")])
    t0 = time.perf_counter()
    tcli.main(flags + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    seconds = time.perf_counter() - t0
    print(f"port segment_raw_signals_200hz --bandpass on (7, 2, 104000), CPU: {seconds:.1f} s")
    want = np.load(tmp_path / "jax" / "sub1.npy")
    got = np.load(tmp_path / "port" / "sub1.npy")
    assert got.shape == want.shape == (7, 40, 5, 2, 400) and got.dtype == np.float64
    assert _rel(got, want, want) < F32_VS_JAX
    sos = jb.butter_bandpass_sos(4, 0.5, 47.0, 200.0)
    exact = segment_subject(signal.sosfiltfilt(
        sos, raw.astype(np.float32).astype(np.float64), axis=-1, padlen=27))
    assert _rel(got, exact, exact) <= 2 * _rel(want, exact, exact)
