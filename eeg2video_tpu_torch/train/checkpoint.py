"""Checkpoints of the fine-tune: the train state (f32 parameters, optimizer
state, step) as one torch file, written atomically, restored exactly; a
session that writes them on a background thread; a guard that turns
SIGTERM / SIGINT into a flag the trainer polls.

Counterpart of the parts of ``eeg2video_tpu/train/checkpoint.py`` the
trainers use (``CheckpointSession`` :78, ``PreemptionGuard`` :112).
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import signal
import threading

import torch

from ..convert.export_diffusion import load_torch_state_dict  # noqa: F401  (re-export)

_NAME = re.compile(r"train_state_(\d+)\.pt$")


def _path(ckpt_dir, tag: int):
    return os.path.join(ckpt_dir, f"train_state_{int(tag)}.pt")


def _write(path, obj):
    """``torch.save`` to a temporary name, then rename: a reader never sees
    half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_state(ckpt_dir, tag: int, state):
    """Write ``<ckpt_dir>/train_state_<tag>.pt`` and return its path:
    ``state.state_dict()`` (the fine-tune's train state: every parameter in
    f32, the optimizer state, the step; a model's weights), or ``state`` itself
    when it is a state dict."""
    path = _path(ckpt_dir, tag)
    _write(path, state.state_dict() if hasattr(state, "state_dict") else state)
    return path


def _checkpoints(path):
    """``[(n, file name)]`` of the ``train_state_<n>.pt`` files in ``path``."""
    return sorted((int(m.group(1)), f) for f in os.listdir(path) if (m := _NAME.search(f)))


def latest_checkpoint(path):
    """``path`` itself if it is a file, else the ``train_state_<n>.pt`` with
    the largest n in that directory (None if there is none)."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        return None
    found = _checkpoints(path)
    return os.path.join(path, found[-1][1]) if found else None


def restore_train_state(path, state):
    """Load a file written by ``save_train_state`` (or the newest one of a
    directory) into ``state``; returns the restored step."""
    file = latest_checkpoint(path)
    if file is None:
        raise FileNotFoundError(f"no train-state checkpoint at {path}")
    state.load_state_dict(torch.load(file, map_location="cpu", weights_only=False))
    return state.step


def host_copy(obj):
    """A copy of a state dict on the host that later in-place updates of the
    live state cannot reach."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


class CheckpointSession:
    """Train-state checkpoints written while training goes on.

    ``save`` copies the state to host memory and returns; one background
    thread writes the file (atomically, as ``save_train_state`` does) and
    then deletes all but the newest ``max_to_keep`` files of the directory,
    as the JAX package's orbax manager keeps them. ``wait`` drains the writes
    and raises the first one that failed; ``close`` (or leaving the ``with``
    block) waits and stops the thread."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                           thread_name_prefix="ckpt")
        self._pending = []

    def save(self, step: int, state):
        """Snapshot ``state`` (an object with ``state_dict()``, or a state
        dict) and queue the write of ``train_state_<step>.pt``; returns the
        path it will have."""
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        path = _path(self.directory, step)
        self._pending.append(self._pool.submit(self._write_and_prune, path, host_copy(sd)))
        return path

    def _write_and_prune(self, path, sd):
        _write(path, sd)
        for _, name in _checkpoints(self.directory)[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, name))

    def wait(self):
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PreemptionGuard:
    """SIGTERM / SIGINT set ``preempted`` instead of ending the process; the
    trainer polls it between epochs and saves a resumable state. A second
    signal goes to the handler that was installed before (a double Ctrl-C
    still ends the run). Off the main thread no handler can be installed and
    the guard never trips. Leaving the ``with`` block restores the previous
    handlers."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev = {}
        self.preempted = False

    def _handler(self, signum, frame):
        if self.preempted:  # a second signal: the original handler's turn
            prev = self._prev.get(signum)
            if callable(prev):
                return prev(signum, frame)
            raise KeyboardInterrupt
        self.preempted = True

    def __enter__(self):
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
        except ValueError:  # not the main thread: put back what was set
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev = {}
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False
