"""The port's preprocessing CLIs (segment_sliding_window,
extract_de_psd_features in its three modes) against the JAX package's, on the
same temporary files, on the CPU.

Tolerances: the sliding windows are a gather and the default DE/PSD path is
the same float64 numpy code on both sides: bit-equal. ``--f32`` runs each
package's own ``de_psd`` (the port's forms its products in float64, JAX's in
float32 at HIGHEST precision; ROADMAP §3, the `de_psd` entry): within 1e-4 relative.
"""

import numpy as np
import pytest

from eeg2video_tpu.cli import extract_de_psd_features as jde
from eeg2video_tpu.cli import segment_raw_signals_200hz as jseg
from eeg2video_tpu.cli import segment_sliding_window as jsw
from eeg2video_tpu_torch.cli import extract_de_psd_features as tde
from eeg2video_tpu_torch.cli import segment_raw_signals_200hz as tseg
from eeg2video_tpu_torch.cli import segment_sliding_window as tsw

from test_torch_models import capped_threads

_threads = capped_threads()

F32_RTOL = 1e-4


@pytest.fixture
def segments(tmp_path):
    """Two subjects of 2 s segments; the second a few concepts short, as a
    cut-down file (the CLIs take any leading shape)."""
    rng = np.random.default_rng(0)
    d = tmp_path / "seg"
    d.mkdir()
    np.save(d / "sub1.npy", rng.standard_normal((7, 3, 5, 62, 400)))
    np.save(d / "sub2.npy", rng.standard_normal((7, 2, 5, 62, 400)).astype(np.float32))
    np.save(d / "junk.npy", rng.standard_normal((3, 400)))  # skipped: not 5-D
    return d


@pytest.mark.parametrize("mmap", [False, True])
def test_segment_cli_without_bandpass_is_bit_equal_to_jax(tmp_path, mmap):
    """A float64 raw file (7 blocks of 104,000 samples, two channels): both CLIs
    gather its float32 values (JAX's jnp arrays with x64 off) and write float64."""
    (tmp_path / "raw").mkdir()
    np.save(tmp_path / "raw" / "sub4.npy", np.random.default_rng(3).standard_normal((7, 2, 104000)))
    flags = ["--eeg_root", str(tmp_path / "raw")] + (["--mmap"] if mmap else [])
    jseg.main(flags + ["--output_dir", str(tmp_path / "jax")])
    tseg.main(flags + ["--output_dir", str(tmp_path / "port")])
    want, got = np.load(tmp_path / "jax" / "sub4.npy"), np.load(tmp_path / "port" / "sub4.npy")
    assert got.shape == (7, 40, 5, 2, 400) and got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


def test_sliding_window_cli_is_bit_equal_to_jax(segments, tmp_path):
    jsw.main(["--input_dir", str(segments), "--output_dir", str(tmp_path / "jax")])
    tsw.main(["--input_dir", str(segments), "--output_dir", str(tmp_path / "port")])
    for name, shape in (("sub1.npy", (7, 3, 5, 7, 62, 100)), ("sub2.npy", (7, 2, 5, 7, 62, 100))):
        want, got = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
        assert got.shape == shape and got.dtype == want.dtype
        assert np.array_equal(got, want)
    assert not (tmp_path / "port" / "junk.npy").exists()


@pytest.mark.parametrize("mode", ["1per2s", "1per1s", "1per500ms"])
@pytest.mark.parametrize("f32", [False, True])
def test_de_psd_cli_matches_jax(segments, tmp_path, mode, f32):
    raw = segments
    if mode == "1per500ms":  # its input is the sliding windows
        jsw.main(["--input_dir", str(segments), "--output_dir", str(tmp_path / "sw")])
        raw = tmp_path / "sw"
    out = {}
    for side, cli in (("jax", jde), ("port", tde)):
        flags = ["--mode", mode, "--raw_dir", str(raw), "--subs", "1", "2",
                 "--de_dir", str(tmp_path / side / "de"), "--psd_dir", str(tmp_path / side / "psd")]
        if f32:
            flags.append("--f32")
            if side == "port":
                flags += ["--device", "cpu"]
        cli.main(flags)
        out[side] = {(kind, s): np.load(tmp_path / side / kind / f"sub{s}.npy")
                     for kind in ("de", "psd") for s in (1, 2)}
    lead = {"1per2s": (5,), "1per1s": (5, 2), "1per500ms": (5, 7)}[mode]
    for key, want in out["jax"].items():
        got = out["port"][key]
        assert got.shape == (7, 3 if key[1] == 1 else 2, *lead, 62, 5)
        assert got.dtype == want.dtype == np.float64
        if f32:
            np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)
        else:
            assert np.array_equal(got, want)


def test_de_psd_cli_f32_is_on_the_card_by_default(segments, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tde.main(["--raw_dir", str(segments), "--de_dir", str(tmp_path / "de"),
                  "--psd_dir", str(tmp_path / "psd"), "--f32"])
