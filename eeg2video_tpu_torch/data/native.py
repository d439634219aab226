"""The native data path: host C++ built with ``g++`` at first use and bound
with ctypes, and the ``.npy`` row loader.

Counterpart of ``eeg2video_tpu/data/native.py``:

- ``NpyBatchLoader``: row gather from a memory-mapped ``.npy``, raw or
  z-scored, with numpy. JAX gathers through a threaded C++ loader where the
  file's layout allows; the port keeps numpy's memory map only, which gives
  the same rows and, in float32, the same normalized values;
- ``decode_clips`` (``csrc/video_decoder.cpp``, linked against opencv4
  through ``pkg-config``): a thread pool decoding clips straight into one
  (N, F, H, W, 3) float32 array in [-1, 1];
- ``write_gif_native`` (``csrc/gif_encoder.cpp``).

The C++ is host code, not device kernels. Each library goes beside the CUDA
kernels' into ``eeg2video_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of its source and flags. Where JAX falls
back to cv2 when the decoder is missing, the port does not: a library that
cannot be built raises with the compiler's output, and a clip that yields no
frame raises with its path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIF_SOURCE = os.path.join(_PKG, "csrc", "gif_encoder.cpp")
VIDEO_SOURCE = os.path.join(_PKG, "csrc", "video_decoder.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_glib = _vlib = None  # the loaded libraries
_lock = threading.Lock()  # writer and loader threads may race to the first build


def _opencv_flags():
    pc = shutil.which("pkg-config")
    res = (subprocess.run([pc, "--cflags", "--libs", "opencv4"], capture_output=True, text=True)
           if pc else None)
    if res is None or res.returncode != 0:
        why = "pkg-config is not installed" if pc is None else res.stderr.strip()
        raise RuntimeError(f"native video decoder: opencv4 is not available to link against "
                           f"(pkg-config --cflags --libs opencv4: {why})")
    return tuple(res.stdout.split())


def _build(what, cache, source, so_name, bind, link=()):
    """The library held in the module global ``cache``; else build
    ``source`` into ``_build/<hash>/so_name`` if it is not there, load it,
    ``bind`` its C signatures and keep it there. Raises with the compiler's
    output on failure."""
    with _lock:
        if globals()[cache] is not None:
            return globals()[cache]
        with open(source, "rb") as f:
            key = " ".join(CXX_FLAGS + tuple(link)).encode() + f.read()
        out_dir = os.path.join(BUILD_ROOT, hashlib.sha256(key).hexdigest()[:16])
        so = os.path.join(out_dir, so_name)
        if not os.path.exists(so):
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError(f"native {what}: no C++ compiler (g++) found")
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run([cxx, *CXX_FLAGS, source, "-o", tmp, *link],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                raise RuntimeError(f"native {what}: {cxx} failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
        lib = ctypes.CDLL(so)
        bind(lib)
        globals()[cache] = lib
        return lib


def _bind_gif(lib):
    lib.gif_encode_rgb.restype = ctypes.c_int
    lib.gif_encode_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_char_p]


def _bind_video(lib):
    lib.e2v_decode_clips.restype = ctypes.c_int
    lib.e2v_decode_clips.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def gif_library():
    """The loaded GIF encoder library, building it first if needed."""
    return _build("gif encoder", "_glib", GIF_SOURCE, "libgifencoder.so", _bind_gif)


def video_library():
    """The loaded clip decoder, building it (against opencv4) if needed."""
    if _vlib is not None:
        return _vlib
    return _build("video decoder", "_vlib", VIDEO_SOURCE, "libvideodecoder.so", _bind_video,
                  _opencv_flags())


def video_decoder_available() -> bool:
    """Whether the clip decoder builds and loads here (it needs opencv4's
    headers and libraries, found through ``pkg-config``)."""
    try:
        video_library()
    except (RuntimeError, OSError):
        return False
    return True


# --- .npy row gather ----------------------------------------------------------

class NpyBatchLoader:
    """Row-gather view over one ``.npy`` file (leading axis = samples),
    through numpy's memory map."""

    def __init__(self, path: str):
        self.path = path
        self._arr = np.load(path, mmap_mode="r")

    @property
    def n_rows(self) -> int:
        return int(self._arr.shape[0])

    @property
    def row_dim(self) -> int:
        return int(np.prod(self._arr.shape[1:]))

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Raw rows (n, row_dim) in the file's dtype. An index outside
        [0, n_rows) raises; a negative one does not count from the end."""
        idx = np.ascontiguousarray(idx, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_rows):
            raise IndexError("row index out of range")
        return np.asarray(self._arr[idx]).reshape(len(idx), -1)

    def gather_normalized(self, idx: np.ndarray, mean: np.ndarray,
                          std: np.ndarray) -> np.ndarray:
        """(x[idx] - mean) / std in float32, ``mean`` and ``std`` broadcast
        to one row."""
        mean = np.broadcast_to(np.asarray(mean, np.float32), (self.row_dim,))
        std = np.broadcast_to(np.asarray(std, np.float32), (self.row_dim,))
        # in place on the gathered copy: each new batch-sized array costs
        # its page faults
        x = self.gather(idx).astype(np.float32, copy=False)
        x -= mean
        x /= std
        return x

    def close(self):
        self._arr = None


# --- clip decoder -----------------------------------------------------------------

def decode_frames(paths, width: int, height: int, n_frames: int, frame_stride: int = 1,
                  start_idx: int = 0, n_threads: int = 0):
    """``decode_clips`` with each clip's count of decoded frames: (out, counts)."""
    lib = video_library()
    n = len(paths)
    out = np.empty((n, n_frames, height, width, 3), np.float32)
    written = np.zeros((n,), np.int32)
    if n == 0:
        return out, written
    cpaths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.e2v_decode_clips(cpaths, n, width, height, n_frames, frame_stride, start_idx,
                         out.ctypes.data, written.ctypes.data, n_threads)
    bad = [os.fspath(p) for p, k in zip(paths, written) if k == 0]
    if bad:
        raise RuntimeError(f"could not decode {len(bad)} clip(s), no frame read: "
                           f"{', '.join(bad[:5])}")
    return out, written


def decode_clips(paths, width: int, height: int, n_frames: int,
                 frame_stride: int = 1, start_idx: int = 0,
                 n_threads: int = 0) -> np.ndarray:
    """Decode videos into one (N, n_frames, H, W, 3) float32 array in
    [-1, 1] with the C++ thread pool (``csrc/video_decoder.cpp``): resize at
    decode (INTER_LINEAR), every ``frame_stride``-th frame from
    ``start_idx``, the first ``n_frames`` of them (the reference's decord
    dataset, dataset.py:41-88). A short clip is zero-padded on the frame
    axis; a clip that yields no frame raises, naming it."""
    return decode_frames(paths, width, height, n_frames, frame_stride, start_idx,
                         n_threads)[0]


# --- GIF encoder ------------------------------------------------------------------

def write_gif_native(path: str, frames: np.ndarray, duration_ms: float) -> None:
    """Write (F, H, W, 3) uint8 frames as a looping GIF via the C++ encoder:
    shared median-cut palette, 5-bit inverse-lattice pixel mapping, threaded
    per-frame LZW. Raises RuntimeError when the library cannot be built or
    the encode fails."""
    lib = gif_library()
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (F, H, W, 3) RGB frames, got {frames.shape}")
    f, h, w, _ = frames.shape
    rc = lib.gif_encode_rgb(frames.ctypes.data_as(ctypes.c_void_p),
                            f, h, w, max(int(round(duration_ms / 10.0)), 1),
                            os.fspath(path).encode())
    if rc != 0:
        raise RuntimeError(f"gif_encode_rgb failed with code {rc}")
