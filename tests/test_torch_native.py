"""The port's data path (data/native.py: ``NpyBatchLoader``,
``decode_clips``) and the ``gif`` stage (data/video.py:
``clip_frame_schedule``, ``extract_gifs_from_block``, ``load_all``;
cli/extract_gif.py) against the JAX package on the CPU.

The outputs are held equal. The port's ``NpyBatchLoader`` gathers with numpy
and is held to numpy and to JAX's loader, which takes its C++ gather where
the file's layout allows. The clip decoder's C++ source is the JAX
package's, copied into the port and built by it. ``load_all`` decodes with
cv2 in Python on both sides. The GIFs differ in their encoder (the port's
native one, JAX's imageio), so the ``gif`` stage is held to JAX's choice of
frames: the written indices, and for every GIF frame the source frame it
shows (each source frame carries its index in its red level). Where this
cv2 build has no codec to write the test videos, the tests skip, as the JAX
package's do.
"""

import os

import numpy as np
import pytest

from eeg2video_tpu.cli import extract_gif as jextract_cli
from eeg2video_tpu.data import meta as jmeta
from eeg2video_tpu.data import native as jnative
from eeg2video_tpu.data import video as jvideo
from eeg2video_tpu_torch.cli import extract_gif as textract_cli
from eeg2video_tpu_torch.data import native as tnative
from eeg2video_tpu_torch.data import video as tvideo

from test_torch_models import capped_threads

_threads = capped_threads()


# --- NpyBatchLoader -----------------------------------------------------------------

@pytest.fixture(scope="module")
def arrays(tmp_path_factory):
    d = tmp_path_factory.mktemp("npy")
    a = np.random.default_rng(0).standard_normal((37, 5, 6)).astype(np.float32)
    files = {"f32": a, "f64": a.astype(np.float64) * 3, "fortran": np.asfortranarray(a),
             "int": (a * 100).astype(np.int32), "vector": a[:, 0, 0].copy()}
    for name, arr in files.items():
        np.save(d / f"{name}.npy", arr)
    return {name: str(d / f"{name}.npy") for name in files}, files


@pytest.mark.parametrize("name,native", [("f32", True), ("f64", True), ("vector", True),
                                         ("fortran", False), ("int", False)])
def test_npy_loader_matches_numpy_and_jax(arrays, name, native):
    """``native``: whether JAX's loader takes the file in C++ (else numpy)."""
    paths, data = arrays
    loader, jloader = tnative.NpyBatchLoader(paths[name]), jnative.NpyBatchLoader(paths[name])
    if jnative.native_available():
        assert (jloader._lib is not None) == native
    idx = np.array([3, 0, 36, 3, 17])
    want = data[name][idx].reshape(len(idx), -1)
    got = loader.gather(idx)
    assert got.dtype == want.dtype and loader.n_rows == 37 and loader.row_dim == want.shape[1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jloader.gather(idx))
    mean = np.linspace(-1, 1, loader.row_dim).astype(np.float32)
    std = np.linspace(0.5, 2, loader.row_dim).astype(np.float32)
    norm = loader.gather_normalized(idx, mean, std)
    assert norm.dtype == np.float32
    np.testing.assert_array_equal(norm, jloader.gather_normalized(idx, mean, std))
    np.testing.assert_allclose(norm, (want.astype(np.float32) - mean) / std, rtol=1e-6, atol=1e-6)
    loader.close()


def test_npy_loader_refuses_an_index_out_of_range(arrays):
    paths, _ = arrays
    loader = tnative.NpyBatchLoader(paths["f32"])
    for bad in ([37], [0, -1]):
        with pytest.raises(IndexError, match="out of range"):
            loader.gather(np.array(bad))
        with pytest.raises(IndexError, match="out of range"):
            loader.gather_normalized(np.array(bad), 0.0, 1.0)
    with pytest.raises(ValueError):
        loader.gather_normalized(np.array([0]), np.zeros(7, np.float32), 1.0)


def test_a_library_that_does_not_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_vlib", None)
    with pytest.raises(RuntimeError, match="native broken: .* failed"):
        tnative._build("broken", "_vlib", str(bad), "libbroken.so", lambda lib: None)


# --- the clip decoder ---------------------------------------------------------------

def _write_clip(path, n_frames, h=48, w=64, seed=0):
    cv2 = pytest.importorskip("cv2")
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
    if not wr.isOpened():
        pytest.skip("cv2 mp4 encoder unavailable")
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        wr.write(rng.integers(0, 255, (h, w, 3), np.uint8))
    wr.release()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    paths = []
    for i, n in enumerate((20, 20, 6)):
        _write_clip(d / f"{i}.mp4", n, seed=i)
        paths.append(str(d / f"{i}.mp4"))
    return paths


def test_decode_clips_equals_jax(clips):
    if not tnative.video_decoder_available():
        pytest.skip("opencv4 is not available to link the decoder against here")
    assert jnative.video_decoder_available()
    for args in ((40, 32, 4, 3, 1), (64, 48, 6, 1, 0), (33, 17, 8, 2, 2)):
        got = tnative.decode_clips(clips, *args)
        want = jnative.decode_clips(clips, *args)
        assert got.shape == want.shape == (3, args[2], args[1], args[0], 3)
        np.testing.assert_array_equal(got, want)
    short = tnative.decode_clips(clips[2:], 40, 32, 4, 3, 1)  # 6 frames: 1, 4 -> 2 of 4
    assert np.all(short[0, 2:] == 0.0) and np.abs(short[0, :2]).max() > 0


def test_a_clip_that_does_not_decode_raises_with_its_path(clips, tmp_path):
    """JAX decodes the others and zero-fills this one through cv2; the port
    refuses, naming it (a settled divergence)."""
    if not tnative.video_decoder_available():
        pytest.skip("opencv4 is not available to link the decoder against here")
    missing = str(tmp_path / "missing.mp4")
    want = jnative.decode_clips([clips[0], missing], 40, 32, 4)
    assert np.all(want[1] == 0.0)
    with pytest.raises(RuntimeError, match="missing.mp4"):
        tnative.decode_clips([clips[0], missing], 40, 32, 4)


def test_load_all_equals_jax(clips, monkeypatch):
    """Both decode with cv2 in Python: the port always, JAX where its C++
    decoder is missing (made so here)."""
    monkeypatch.setattr(jnative, "_load_video_lib", lambda: None)
    kw = dict(width=40, height=32, n_sample_frames=3, sample_frame_rate=4, sample_start_idx=1)
    got, ids = tvideo.VideoClipDataset(clips[:2], [5, 7], **kw).load_all()
    want, jids = jvideo.VideoClipDataset(clips[:2], np.asarray([5, 7]), **kw).load_all()
    assert got.shape == (2, 3, 32, 40, 3)
    np.testing.assert_array_equal(got, want)
    assert list(ids) == list(jids) == [5, 7]
    # and within a level of rounding of the C++ decoder, where it builds
    if tnative.video_decoder_available():
        np.testing.assert_allclose(got, tnative.decode_clips(clips[:2], 40, 32, 3, 4, 1),
                                   atol=2e-2)
    with pytest.raises(ValueError, match="2.mp4: decoded 6 frames"):
        tvideo.VideoClipDataset(clips, [0, 1, 2], **kw).load_all()


# --- the gif stage --------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(fps=4, n_concepts=3, reps=2)])
def test_clip_frame_schedule_equals_jax(kw):
    got, want = tvideo.clip_frame_schedule(**kw), jvideo.clip_frame_schedule(**kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _block_video(path, n_frames, w=64, h=36):
    """A block video whose frame i is flat with red level (5 i) % 250."""
    cv2 = pytest.importorskip("cv2")
    for codec, name in (("mp4v", str(path)), ("MJPG", str(path).replace(".mp4", ".avi"))):
        vw = cv2.VideoWriter(name, cv2.VideoWriter_fourcc(*codec), jmeta.VIDEO_FPS, (w, h))
        if not vw.isOpened():
            continue
        for i in range(n_frames):
            frame = np.zeros((h, w, 3), np.uint8)
            frame[..., 2] = (i * 5) % 250  # BGR: red
            vw.write(frame)
        vw.release()
        return name
    pytest.skip("no usable cv2 video codec in this build")


def _source_frames(gif_path):
    """The source frame index each GIF frame shows, from its red level."""
    reds = np.median(tvideo.load_gif(gif_path)[..., 0].reshape(-1, 18 * 32), axis=1)
    return np.round(reds / 5).astype(int)


def test_extract_gifs_from_block_picks_jax_frames(tmp_path):
    per_concept = (jmeta.BASELINE_SEC + jmeta.N_REPS * jmeta.CLIP_SEC) * jmeta.VIDEO_FPS
    vid = _block_video(tmp_path / "block0.mp4", per_concept)
    want = jvideo.extract_gifs_from_block(vid, str(tmp_path / "jax"), height=18, width=32)
    got = tvideo.extract_gifs_from_block(vid, str(tmp_path / "port"), height=18, width=32)
    assert got == want == [0, 1, 2, 3, 4]
    hint, clip_len = jmeta.BASELINE_SEC * jmeta.VIDEO_FPS, jmeta.CLIP_SEC * jmeta.VIDEO_FPS
    for rep in got:
        port = _source_frames(str(tmp_path / "port" / f"{rep}.gif"))
        jax = _source_frames(str(tmp_path / "jax" / f"{rep}.gif"))
        assert len(port) == jmeta.GIF_FRAMES
        np.testing.assert_array_equal(port, jax)
        src = hint + rep * clip_len + 8 * np.arange(jmeta.GIF_FRAMES)
        assert np.abs(port - (src * 5 % 250) / 5).max() <= 2  # within the codec's error


def test_extract_gif_cli_matches_jax(tmp_path, monkeypatch):
    """Two blocks of one concept each through both CLIs (``{b+1}.mp4`` ->
    ``Block{b}/{idx}.gif``), at GIF size 18x32 on both sides."""
    per_concept = (jmeta.BASELINE_SEC + jmeta.N_REPS * jmeta.CLIP_SEC) * jmeta.VIDEO_FPS
    videos = tmp_path / "videos"
    videos.mkdir()
    for b in (0, 1):
        name = _block_video(videos / f"{b + 1}.mp4", per_concept)
        if not name.endswith(".mp4"):
            pytest.skip("this cv2 build writes no mp4")
    # both CLIs call extract_gifs_from_block at its default size: wrap it
    for mod, ext in ((jvideo, jextract_cli), (tvideo, textract_cli)):
        fn = mod.extract_gifs_from_block
        monkeypatch.setattr(ext, "extract_gifs_from_block",
                            lambda src, out, fn=fn: fn(src, out, height=18, width=32))
    args = ["--video_dir", str(videos), "--blocks", "0", "1"]
    jextract_cli.main(args + ["--out_root", str(tmp_path / "jax")])
    got = textract_cli.main(args + ["--out_root", str(tmp_path / "port")])
    assert got == {0: [0, 1, 2, 3, 4], 1: [0, 1, 2, 3, 4]}
    for b in (0, 1):
        names = sorted(os.listdir(tmp_path / "port" / f"Block{b}"))
        assert names == sorted(os.listdir(tmp_path / "jax" / f"Block{b}"))
        for n in names:
            np.testing.assert_array_equal(_source_frames(str(tmp_path / "port" / f"Block{b}" / n)),
                                          _source_frames(str(tmp_path / "jax" / f"Block{b}" / n)))


def test_the_native_path_raises_where_jax_falls_back(monkeypatch):
    """No opencv4 to link: the decoder raises, naming pkg-config; JAX would
    fall back to cv2 in Python."""
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    monkeypatch.setattr(tnative, "_vlib", None)
    with pytest.raises(RuntimeError, match="opencv4"):
        tnative.video_library()
    assert not tnative.video_decoder_available()
