"""Checkpoints of the fine-tune: the train state (f32 parameters, optimizer
state, step) as one torch file, written atomically, restored exactly.

Counterpart of the parts of ``eeg2video_tpu/train/checkpoint.py`` the
video-diffusion trainer uses. Writes are synchronous; the JAX package's
background writer and its preemption guard are not ported.
"""

from __future__ import annotations

import os
import re

import torch

from ..convert.export_diffusion import load_torch_state_dict  # noqa: F401  (re-export)

_NAME = re.compile(r"train_state_(\d+)\.pt$")


def save_train_state(ckpt_dir, tag: int, state):
    """Write ``<ckpt_dir>/train_state_<tag>.pt`` (every parameter in f32, the
    optimizer state, the step) and return its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"train_state_{int(tag)}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(path):
    """``path`` itself if it is a file, else the ``train_state_<n>.pt`` with
    the largest n in that directory (None if there is none)."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        return None
    found = [(int(m.group(1)), f) for f in os.listdir(path) if (m := _NAME.search(f))]
    return os.path.join(path, max(found)[1]) if found else None


def restore_train_state(path, state):
    """Load a file written by ``save_train_state`` (or the newest one of a
    directory) into ``state``; returns the restored step."""
    file = latest_checkpoint(path)
    if file is None:
        raise FileNotFoundError(f"no train-state checkpoint at {path}")
    state.load_state_dict(torch.load(file, map_location="cpu", weights_only=False))
    return state.step
