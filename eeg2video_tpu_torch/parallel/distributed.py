"""Process-group start-up: one process per GPU, as ``torchrun`` starts them.

Counterpart of ``eeg2video_tpu/parallel/distributed.py``. JAX runs one
controller per host and reads ``JAX_COORDINATOR_ADDRESS``; here each GPU has
its own process and the launcher's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` say where it stands. Without a launcher
nothing starts, as JAX's is a no-op on one process.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_LAUNCHER = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    """NCCL on the card, gloo on the CPU; there is no fallback between them."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda") -> bool:
    """Join the launcher's process group; returns True when it holds more than
    one process. Idempotent: a group that exists already (a launcher, a test,
    an earlier call) is kept. Without the launcher's variables it starts
    nothing and returns False. On the card it binds this process to GPU
    ``LOCAL_RANK`` before the NCCL group is made."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not from_launcher():
        missing = [k for k in _LAUNCHER if k not in os.environ]
        if len(missing) < len(_LAUNCHER):
            raise RuntimeError(f"a launcher's environment is incomplete: {missing} not set")
        return False
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_world_size() > 1


def from_launcher() -> bool:
    """Whether a launcher's environment (``torchrun``'s variables) is set."""
    return all(k in os.environ for k in _LAUNCHER)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's share of a batch split evenly over the world."""
    per = global_batch // world_size()
    lo = per * rank()
    return slice(lo, lo + per)
