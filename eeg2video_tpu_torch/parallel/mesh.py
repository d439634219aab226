"""The (dp, sp, tp) mesh over the world's processes, parameter sharding,
the collectives that differentiate, and fsdp's choice of dimension.

Counterpart of ``eeg2video_tpu/parallel/mesh.py``. JAX's mesh is a grid of
devices that GSPMD partitions one program over; here each GPU runs its own
process, so the mesh is the world's ranks laid out as JAX lays out its
devices, ``reshape(dp, sp, tp)`` with tp the fastest axis, and one process
group per axis line that this rank lies on. The collectives are explicit in
the modules that need them (``ops.ring``, ``models.attention3d``,
``diffusion.pipeline``, ``train.videodiffusion``). Where GSPMD inserts a
collective into the backward implicitly, ``copy_to`` and ``reduce_from``
(Megatron's f and g) put it there by hand.

``shard_params`` takes rules ``name -> (dim, axis) | (dim, axis, groups) |
None`` over the port's parameter names. JAX's rules are PartitionSpecs of
flax kernels, which are (in, out); torch's ``weight`` is (out, in), so JAX's
column split ``P(None, "tp")`` is dim 0 here and its row split ``P("tp",
None)`` dim 1. ``groups`` > 1 splits each of that many equal runs of ``dim``
on its own and keeps this rank's piece of each, in order (the GEGLU
projection's hidden and gate halves).

``fsdp_spec`` picks the dimension that fsdp splits over dp as JAX picks it
(mesh.py:62-81): on the flax layout of the leaf, whose order differs from
torch's (``jax_dim_order``), so that a tie goes to JAX's first dimension.
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
    """This rank's place in a (dp, sp, tp) layout of the world's first
    dp*sp*tp ranks and the group of each axis line through it (None for an
    axis of size 1). ``members`` is the group of all the mesh's ranks (None:
    the whole world); a rank past them is not ``active`` and has no place."""

    def __init__(self, dp, sp, tp, device, groups, members=None):
        self.shape = {"dp": dp, "sp": sp, "tp": tp}
        self.device = device
        self.groups = groups
        self.members = members
        here = np.argwhere(layout(dp, sp, tp) == rank())
        self.coords = dict(zip(AXES, (int(c) for c in here[0]))) if len(here) else None

    @property
    def active(self) -> bool:
        return self.coords is not None

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
              timeout: Optional[timedelta] = None, leave_idle: bool = False) -> Mesh:
    """A (dp, sp, tp) mesh over the world; ``dp*sp*tp`` must equal the world
    size, or with ``leave_idle`` be at most it: the mesh is then the first
    dp*sp*tp ranks (JAX's ``devices[:n]``) and the others get a Mesh that is
    not ``active``, to join none of its work. Every process of the world
    calls it. A mesh of size 1 without a launcher starts a world of one on a
    local store (NCCL on the card, gloo on the CPU), so that ``--dp 1`` on
    one GPU takes the mesh path."""
    device = torch.device(device)
    n, size = world_size(), dp * sp * tp
    if size > n or (size < n and not leave_idle):
        raise ValueError(f"dp*sp*tp = {size} != {n} devices (one process per GPU)")
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
    members = dist.new_group(list(range(size)), timeout=timeout) if size < n else None
    return Mesh(dp, sp, tp, device, groups, members)


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


def gather_cat(x, group, size: int, dim: int):
    """Every rank's x concatenated along ``dim``, in group-rank order (the
    inverse of taking piece ``rank`` of ``x.chunk(size, dim)``)."""
    if group is None:
        return x
    return torch.cat(all_gather(x, group, size).chunk(size), dim=dim)


def split_piece(x, size: int, rank: int, dim: int, groups: int = 1):
    """This rank's piece of x along ``dim``: of each of ``groups`` equal runs,
    its 1/size part, in order (``shard_params``' slicing)."""
    if size == 1:
        return x
    return torch.cat([part.chunk(size, dim)[rank] for part in x.chunk(groups, dim)], dim)


def gather_pieces(x, group, size: int, dim: int, groups: int = 1):
    """The whole tensor from every rank's ``split_piece`` (``group`` None: x,
    the whole already)."""
    if group is None:
        return x
    parts = gather_cat(x, group, size, dim).chunk(size * groups, dim)
    # rank r's piece holds [run 0 part r | run 1 part r | ...]
    return torch.cat([parts[r * groups + g] for g in range(groups) for r in range(size)], dim)


# --- Megatron's f and g: collectives that differentiate -----------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, group):
    """Identity forward, all-reduce (sum) of the gradient over ``group``
    backward: the input of a projection whose output features are split over
    tp, each rank's gradient of it partial (Megatron's f). ``group`` None
    (an axis of size 1) returns x."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """All-reduce (sum) of x over ``group`` forward, identity backward: the
    partial products of a projection whose input features are split over tp
    (Megatron's g). Without autograd x is reduced in place (a fresh product);
    with it, a copy (an in-place reduce under a recomputed block's replay
    corrupts the gradients). ``group`` None returns x."""
    if group is None:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x
    return _ReduceFrom.apply(x, group)


# --- fsdp ----------------------------------------------------------------------

def jax_dim_order(ndim: int):
    """The torch dims of a leaf in the order of its flax layout: a Dense
    kernel is (in, out), torch (out, in); a convolution (kh, kw, in, out),
    torch (out, in, kh, kw) (``convert.export_diffusion``'s transposes); a
    vector is the same in both."""
    return [0] if ndim < 2 else [*range(2, ndim), 1, 0]


def fsdp_spec(shape, base_dim=None, dp: int = 1):
    """The torch dim of a leaf of ``shape`` that fsdp splits over dp, or None
    (JAX's ``fsdp_spec``, mesh.py:62-81): the largest dimension divisible by
    dp (and at least dp) that the tp rule (``base_dim``) leaves free; of two
    equal ones the first in the flax layout, as JAX's ``max`` takes it."""
    cands = [d for d in jax_dim_order(len(shape))
             if d != base_dim and shape[d] % dp == 0 and shape[d] >= dp]
    if not cands:
        return None
    return max(cands, key=lambda d: shape[d])


def shard_params_fsdp(params, mesh: Mesh, base_rules=None):
    """fsdp of a ``{name: tensor}`` dict over the mesh's dp axis (JAX's
    ``shard_params_fsdp``, mesh.py:84-103): ``{name: (this rank's dp piece,
    dim)}``, ``dim`` None (and the tensor whole) where ``fsdp_spec`` finds no
    dimension. ``base_rules`` (name -> (dim, axis[, groups]) or None) are the
    tp rules the tensors were sliced by already; their dim stays out."""
    dp, r = mesh.size("dp"), mesh.rank("dp")
    out = {}
    for name, t in params.items():
        base = base_rules(name) if base_rules is not None else None
        dim = fsdp_spec(tuple(t.shape), None if base is None else base[0], dp)
        out[name] = (t if dim is None else split_piece(t, dp, r, dim), dim)
    return out


def shard_params(module, mesh: Mesh, rules=None):
    """Slice, in place, each parameter of ``module`` that ``rules`` names to
    this rank's shard; ``None`` (or no rules) leaves it whole (replicated).
    The module that owns a sliced parameter gets ``shard_specs`` ({param:
    (dim, axis, groups)}) and ``mesh``, which the forward reads (and
    ``tp_spec``); ``module.mesh`` is set. Returns ``module``."""
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
        p.data = split_piece(p.data, n, r, dim, groups)
        owner_name, _, pname = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        owner.shard_specs = {**getattr(owner, "shard_specs", {}), pname: (dim, axis, groups)}
        owner.mesh = mesh
    module.mesh = mesh
    return module


def tp_spec(module, name: str):
    """``(dim, axis, groups)`` by which ``shard_params`` sliced parameter
    ``name`` of ``module``, or None where it is whole."""
    owner_name, _, pname = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    return getattr(owner, "shard_specs", {}).get(pname)


def is_host0() -> bool:
    """Rank 0 writes files and logs below ERROR (the reference's
    ``accelerator.is_main_process``)."""
    return rank() == 0
