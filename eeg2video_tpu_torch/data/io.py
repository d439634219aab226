"""Inter-stage artifact IO: .npy / .pt loaders and writers.

A copy of the JAX package's ``data/io.py`` (``load_array``, ``save_array``):
the stages of the reference pipeline hand each other .npy feature tensors
and .pt latent tensors on disk; both read into numpy."""

from __future__ import annotations

import os

import numpy as np


def load_array(path: str) -> np.ndarray:
    """Load .npy / .npz or .pt (torch tensor / array) as numpy."""
    path = os.fspath(path)
    if path.endswith((".npy", ".npz")):
        return np.load(path)
    if path.endswith((".pt", ".pth")):
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(obj, "numpy"):
            return obj.detach().cpu().numpy()
        return np.asarray(obj)
    raise ValueError(f"unsupported artifact format: {path}")


def save_array(path: str, arr) -> None:
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(arr)
    if path.endswith(".npy"):
        np.save(path, arr)
    elif path.endswith(".pt"):
        import torch

        torch.save(torch.from_numpy(arr), path)
    else:
        raise ValueError(f"unsupported artifact format: {path}")
