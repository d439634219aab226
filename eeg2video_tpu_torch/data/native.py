"""The native GIF encoder (``csrc/gif_encoder.cpp``), built with ``g++`` at
first use and bound with ctypes.

Counterpart of the GIF half of ``eeg2video_tpu/data/native.py`` (:207-259).
The encoder is host C++, not a device kernel. Its library goes beside the
CUDA kernels' into ``eeg2video_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the source and flags. A failed build
raises: ``native`` either encodes or fails, it never gives way to another
encoder."""

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
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_glib = None
_lock = threading.Lock()  # GIF writer threads may race to the first build


def gif_library():
    """The loaded GIF encoder library, building it first if needed."""
    global _glib
    with _lock:
        if _glib is not None:
            return _glib
        with open(GIF_SOURCE, "rb") as f:
            digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
        out_dir = os.path.join(BUILD_ROOT, digest)
        so = os.path.join(out_dir, "libgifencoder.so")
        if not os.path.exists(so):
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("native gif encoder: no C++ compiler (g++) found")
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run([cxx, *CXX_FLAGS, GIF_SOURCE, "-o", tmp],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                raise RuntimeError(f"native gif encoder: {cxx} failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
        lib = ctypes.CDLL(so)
        lib.gif_encode_rgb.restype = ctypes.c_int
        lib.gif_encode_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_char_p]
        _glib = lib
        return lib


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
