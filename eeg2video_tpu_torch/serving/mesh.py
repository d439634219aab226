"""Serving on a mesh of GPUs: rank 0 owns the transport, every rank of the
mesh runs each dispatch.

Counterpart of the mesh block of ``eeg2video_tpu/cli/serve.py`` (:284-311).
JAX is one process that drives every device, so its server calls the sharded
pipeline like any other. Here each GPU has its own process. Rank 0 reads the
requests (stdin or ``--listen``), answers ``ping`` and ``stats``, refuses bad
lines and requests, computes the front half (the semantic predictor, Seq2Seq,
DANA, each clip's noise) and, for each dispatch, sends every rank of the mesh:

- on the control group, a message of fixed size: run or stop, the clip count,
  the negative's rows, the step count, the sampler, the guidance scale, the
  height, width and video length;
- on the mesh's own group, the embeddings, negatives and latents, packed in
  one tensor.

Then every rank calls the sharded pipeline (``EEG2VideoPipeline.shard``),
which splits the clips over dp and gathers the videos; rank 0 alone encodes
them and replies. The other ranks run ``follow``.

Where trouble lies, and what is done about it:

- An idle server. A follower waits for the next message for as long as the
  server idles. The control group is gloo with a wait of ``CONTROL_TIMEOUT``,
  which cannot expire while rank 0 lives (if rank 0 dies, its sockets close
  and the wait raises). The mesh's groups carry tensors only after a message,
  so no NCCL collective waits on an idle server.
- Stopping. Rank 0 sends the stop message once its transport returns (a
  ``shutdown``, the end of stdin, the end of a SIGTERM drain). A follower
  ignores SIGTERM, which ``torchrun`` forwards to every worker: it must not
  leave in the middle of a dispatch, and leaves on the stop that follows
  rank 0's drain. ``--warmup`` is a dispatch like any other.
- Bad requests. Rank 0 checks a dispatch (shapes, sampler, step count, the
  clips over dp) before it sends anything, so a bad request gets its error
  reply and never reaches the other ranks. An error inside the sharded
  forward leaves the ranks out of step, and cannot be answered so: rank 0
  raises ``MeshFailure`` (its replies go out first), a follower raises what
  it met, and either ends its process with a nonzero code; a peer's
  collectives then fail, or time out, and end it too.
- Threads. Every send happens in ``MeshDispatcher.__call__``, on rank 0's
  dispatch thread, in the order the followers run them; the GIF encode
  threads issue no collective.
"""

from __future__ import annotations

import os
import signal
import threading
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..diffusion.schedulers import DDIMSchedule, DPMSolverPPSchedule

# The control group's wait: long enough that an idle server never reaches it.
CONTROL_TIMEOUT = timedelta(days=365)
_SAMPLERS = ("ddim", "dpm++")
_EMB = 77 * 768
_STOP, _RUN = 0.0, 1.0


class MeshFailure(RuntimeError):
    """A dispatch failed inside the sharded forward: the mesh's ranks are out
    of step and the server must end (nonzero)."""


class ControlPlane:
    """The control group over the mesh's ranks (gloo, ``timeout``) and the
    mesh's own group for the tensors. Every rank of the world builds it, in
    the same order as the mesh (``dist.new_group`` is collective)."""

    def __init__(self, mesh, timeout: timedelta = CONTROL_TIMEOUT):
        size = mesh.size("dp") * mesh.size("sp") * mesh.size("tp")
        self.group = dist.new_group(list(range(size)), backend="gloo", timeout=timeout)
        self.data = mesh.members  # None: the whole world
        self.mesh = mesh

    def send(self, fields):
        dist.broadcast(torch.tensor(fields, dtype=torch.float64), 0, group=self.group)

    def receive(self):
        t = torch.empty(9, dtype=torch.float64)
        dist.broadcast(t, 0, group=self.group)
        return t.tolist()


def _check(pipe, mesh, emb, neg, latents, video_length, height, width, steps, sampler):
    """What a dispatch must be before it leaves rank 0 (the pipeline would
    raise on it only after the other ranks had joined)."""
    if sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler '{sampler}' (ddim | dpm++)")
    (DDIMSchedule if sampler == "ddim" else DPMSolverPPSchedule).create(steps)
    dev = pipe.device
    emb = torch.as_tensor(emb, dtype=torch.float32, device=dev).reshape(-1, _EMB)
    b = emb.shape[0]
    dp = mesh.size("dp")
    if b == 0 or b % dp:
        raise ValueError(f"batch {b} not divisible by dp={dp}")
    neg = torch.as_tensor(neg, dtype=torch.float32, device=dev)
    if neg.dim() > 1 and neg.numel() == b * _EMB:  # one negative a clip
        neg = neg.reshape(b, _EMB)
    elif neg.numel() == _EMB:  # one for the whole dispatch
        neg = neg.reshape(_EMB)
    else:
        raise ValueError(f"negative has {neg.numel()} values, expected {_EMB} or {b} x {_EMB}")
    want = (b, video_length, height // 8, width // 8, 4)
    if latents is None:
        raise ValueError("a dispatch on a mesh carries its latents (drawn on rank 0)")
    latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
    if tuple(latents.shape) != want:
        raise ValueError(f"latents shape {tuple(latents.shape)} != {want}")
    return emb, neg, latents


def _exchange(plane, tensors, shapes, device):
    """The dispatch's tensors from rank 0 on every rank: one broadcast of
    their concatenation on the mesh's group."""
    sizes = [int(np.prod(s)) for s in shapes]
    if tensors is None:
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    else:
        flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, 0, group=plane.data)
    return [part.view(shape) for part, shape in zip(flat.split(sizes), shapes)]


def _shapes(b, neg_rows, video_length, height, width):
    neg = (neg_rows, _EMB) if neg_rows else (_EMB,)
    return [(b, _EMB), neg, (b, video_length, height // 8, width // 8, 4)]


class MeshDispatcher:
    """Rank 0's stand-in for the sharded pipeline: the serving code calls it
    as it calls the pipeline. A call checks the dispatch, sends it to every
    rank of the mesh and runs rank 0's share; ``stop`` releases the
    followers."""

    def __init__(self, pipe, plane):
        self.pipe, self.plane = pipe, plane
        self.broken = False
        self.dispatches = 0

    @property
    def device(self):
        return self.pipe.device

    def __call__(self, embeddings, negative, *, latents=None, video_length=6, height=288,
                 width=512, num_inference_steps=50, guidance_scale=7.5, sampler="ddim"):
        if self.broken:
            raise MeshFailure("an earlier dispatch failed inside the sharded forward")
        emb, neg, lat = _check(self.pipe, self.plane.mesh, embeddings, negative, latents,
                               video_length, height, width, num_inference_steps, sampler)
        b, neg_rows = emb.shape[0], (neg.shape[0] if neg.dim() > 1 else 0)
        try:
            self.plane.send([_RUN, b, neg_rows, num_inference_steps, _SAMPLERS.index(sampler),
                             guidance_scale, height, width, video_length])
            emb, neg, lat = _exchange(self.plane, (emb, neg, lat),
                                      _shapes(b, neg_rows, video_length, height, width),
                                      self.device)
            out = self.pipe(emb, neg, latents=lat, video_length=video_length, height=height,
                            width=width, num_inference_steps=num_inference_steps,
                            guidance_scale=guidance_scale, sampler=sampler)
        except Exception as e:
            self.broken = True
            raise MeshFailure(f"dispatch {self.dispatches} failed on the mesh: "
                              f"{type(e).__name__}: {e}") from e
        self.dispatches += 1
        return out

    def stop(self):
        """The stop message (not after a failed dispatch: the followers are
        not listening then)."""
        if not self.broken:
            self.plane.send([_STOP] + [0.0] * 8)


def follow(pipe, plane) -> int:
    """A rank of the mesh other than 0: run each dispatch rank 0 sends, until
    the stop message. Returns 0; an error in a dispatch propagates (and ends
    the process). SIGTERM is ignored meanwhile (see the module docstring)."""
    restore = None
    if threading.current_thread() is threading.main_thread():
        def _note(signum, frame):
            os.write(2, b"serve: SIGTERM on a follower - waiting for rank 0's stop\n")

        restore = signal.signal(signal.SIGTERM, _note)
    try:
        while True:
            op, b, neg_rows, steps, sampler, guidance, height, width, frames = plane.receive()
            if op == _STOP:
                return 0
            b, neg_rows, steps, height, width, frames = (
                int(v) for v in (b, neg_rows, steps, height, width, frames))
            emb, neg, lat = _exchange(plane, None, _shapes(b, neg_rows, frames, height, width),
                                      pipe.device)
            pipe(emb, neg, latents=lat, video_length=frames, height=height, width=width,
                 num_inference_steps=steps, guidance_scale=guidance,
                 sampler=_SAMPLERS[int(sampler)])
    finally:
        if restore is not None:
            signal.signal(signal.SIGTERM, restore)
