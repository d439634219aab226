"""The (dp, sp, tp) mesh over the world's processes, and parameter sharding.

Counterpart of ``eeg2video_tpu/parallel/mesh.py``. JAX's mesh is a grid of
devices that GSPMD partitions one program over; here each GPU runs its own
process, so the mesh is the world's ranks laid out as JAX lays out its
devices, ``reshape(dp, sp, tp)`` with tp the fastest axis, and one process
group per axis line that this rank lies on. The collectives are explicit in
the modules that need them (``ops.ring``, ``models.attention3d``,
``diffusion.pipeline``).

``shard_params`` takes rules ``name -> (dim, axis) | (dim, axis, groups) |
None`` over the port's parameter names. JAX's rules are PartitionSpecs of
flax kernels, which are (in, out); torch's ``weight`` is (out, in), so JAX's
column split ``P(None, "tp")`` is dim 0 here and its row split ``P("tp",
None)`` dim 1. ``groups`` > 1 splits each of that many equal runs of ``dim``
on its own and keeps this rank's piece of each, in order (the GEGLU
projection's hidden and gate halves).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import backend_for, rank, world_size

AXES = ("dp", "sp", "tp")


class Mesh:
    """This rank's place in a (dp, sp, tp) layout of the world and the group
    of each axis line through it (None for an axis of size 1)."""

    def __init__(self, dp, sp, tp, device, groups):
        self.shape = {"dp": dp, "sp": sp, "tp": tp}
        self.device = device
        self.groups = groups
        here = np.argwhere(layout(dp, sp, tp) == rank())[0]
        self.coords = dict(zip(AXES, (int(c) for c in here)))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self):
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, tp={self.shape['tp']})"


def layout(dp: int, sp: int, tp: int):
    """The world's ranks as JAX lays out its devices (mesh.py:30-37):
    ``reshape(dp, sp, tp)``, tp the fastest axis."""
    return np.arange(dp * sp * tp).reshape(dp, sp, tp)


def axis_lines(ranks, axis: str):
    """Every line of ``ranks`` along ``axis`` (the ranks that differ only in
    that coordinate: one process group each), in a fixed order."""
    moved = np.moveaxis(ranks, AXES.index(axis), -1)
    return [list(map(int, line)) for line in moved.reshape(-1, moved.shape[-1])]


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, device="cuda",
              timeout: Optional[timedelta] = None) -> Mesh:
    """A (dp, sp, tp) mesh over the world; ``dp*sp*tp`` must equal the world
    size. Every process of the world calls it. A mesh of size 1 without a
    launcher starts a world of one on a local store (NCCL on the card, gloo
    on the CPU), so that ``--dp 1`` on one GPU takes the mesh path."""
    device = torch.device(device)
    n = world_size()
    if dp * sp * tp != n:
        raise ValueError(f"dp*sp*tp = {dp * sp * tp} != {n} devices (one process per GPU)")
    backend = backend_for(device)
    if not dist.is_initialized():
        kwargs = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                **kwargs)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, but a mesh on "
                         f"{device.type} needs {backend}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ranks = layout(dp, sp, tp)
    me = rank()
    groups = {}
    for axis in AXES:
        groups[axis] = None
        if ranks.shape[AXES.index(axis)] == 1:
            continue
        for line in axis_lines(ranks, axis):  # every process makes every group, in one order
            g = dist.new_group(line, timeout=timeout)
            if me in line:
                groups[axis] = g
    return Mesh(dp, sp, tp, device, groups)


def shard_batch(x, mesh: Mesh):
    """This rank's dp slice of a global batch (JAX's ``batch_sharding``)."""
    dp = mesh.size("dp")
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp={dp}")
    return x.chunk(dp)[mesh.rank("dp")]


def all_gather(x, group, size: int):
    """(size * x.shape[0], ...) from every rank's x, in group-rank order."""
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def gather_batch(x, mesh: Mesh):
    """The global batch from every dp rank's slice, whole on every rank."""
    dp = mesh.size("dp")
    return x if dp == 1 else all_gather(x, mesh.group("dp"), dp)


def shard_params(module, mesh: Mesh, rules=None):
    """Slice, in place, each parameter of ``module`` that ``rules`` names to
    this rank's shard; ``None`` (or no rules) leaves it whole (replicated).
    The module that owns a sliced parameter gets ``shard_specs`` ({param:
    (dim, axis)}) and ``mesh``, which the forward reads; ``module.mesh`` is
    set. Returns ``module``."""
    for name, p in module.named_parameters():
        spec = rules(name) if rules is not None else None
        if spec is None:
            continue
        dim, axis, *rest = spec
        groups = rest[0] if rest else 1
        n, r = mesh.size(axis), mesh.rank(axis)
        if n == 1:
            continue
        if p.shape[dim] % (groups * n):
            raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} does not split into "
                             f"{groups} x {axis}={n}")
        p.data = torch.cat([part.chunk(n, dim)[r] for part in p.data.chunk(groups, dim)], dim)
        owner_name, _, pname = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        owner.shard_specs = {**getattr(owner, "shard_specs", {}), pname: (dim, axis)}
        owner.mesh = mesh
    module.mesh = mesh
    return module


def is_host0() -> bool:
    """Rank 0 writes files and logs below ERROR (the reference's
    ``accelerator.is_main_process``)."""
    return rank() == 0
