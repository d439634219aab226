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
``PerUseGather`` keeps a module's parameters as those dp pieces and gathers
each unit's weights whole where the unit runs, as GSPMD gathers a weight at
its use.
"""

from __future__ import annotations

import weakref
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


def make_fold_mesh(size: int = 7, device="cuda", timeout: Optional[timedelta] = None) -> Mesh:
    """EEG-VP's fold mesh (JAX's ``Mesh(devices[:7], ("fold",))``,
    cli/eegvp_train_test.py:37-49 there): the world's first ``size`` ranks
    along one axis, the mesh's dp, over which ``train.eegvp.run_benchmark``
    splits the stacked folds as a batch; the ranks past them are not
    ``active``. Every process of the world calls it."""
    return make_mesh(dp=size, device=device, timeout=timeout, leave_idle=True)


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


def _true_div(x, divisor: float):
    """``x / divisor`` rounded as a true division on every device
    (``train.optim.true_div``)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def mean_over(tensors, group, size: int):
    """Each tensor's mean over the group's ``size`` ranks, in f32, from one
    flattened all-reduce."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat = _true_div(flat, float(size))
    return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


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


def gather_wholes(pieces, dims, group, size: int):
    """The whole tensors from every rank's ``split_piece`` of each, piece i
    along ``dims[i]``, in one all-gather, each a fresh contiguous tensor
    (``group`` None: the pieces)."""
    if group is None:
        return list(pieces)
    flat = torch.cat([p.reshape(-1) for p in pieces])
    every = torch.empty((size, flat.numel()), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(every.view(-1), flat, group=group)
    wholes, at = [], 0
    for p, dim in zip(pieces, dims):
        shape = list(p.shape)
        shape[dim] *= size
        parts = every[:, at:at + p.numel()].view(size, *p.shape)
        wholes.append(parts.movedim(0, dim).reshape(shape).contiguous())
        at += p.numel()
    return wholes


def scatter_means(grads, dims, group, size: int):
    """This rank's pieces of the means over the group of every rank's whole
    ``grads`` (grad i split along ``dims[i]``), in f32, in one
    reduce-scatter (``group`` None: the grads in f32)."""
    grads = [g.float() for g in grads]
    if group is None:
        return grads
    rows = [g.movedim(dim, 0).reshape(size, -1) for g, dim in zip(grads, dims)]
    src = torch.cat(rows, dim=1)
    out = torch.empty(src.shape[1], dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src.view(-1), group=group)
    out = _true_div(out, float(size))
    pieces = []
    for g, dim, part in zip(grads, dims, out.split([r.shape[1] for r in rows])):
        moved = g.movedim(dim, 0).shape
        pieces.append(part.view(moved[0] // size, *moved[1:]).movedim(0, dim).contiguous())
    return pieces


class _GatherForUse(torch.autograd.Function):
    """A unit's whole tensors from every dp rank's compute-dtype pieces
    forward (``gather_wholes``); backward the whole gradients reduce-scattered
    in f32 and averaged over dp (``scatter_means``) as the gradients of the
    ``masters`` (each trainable piece's f32 master, whose value the forward
    does not read; None for a frozen one, whose whole takes no gradient)."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        group, size, dims = spec
        n = len(dims)
        masters, pieces = tensors[:n], tensors[n:]
        wholes = gather_wholes(pieces, dims, group, size)
        ctx.spec, ctx.trained = spec, [i for i, m in enumerate(masters) if m is not None]
        ctx.mark_non_differentiable(*(w for w, m in zip(wholes, masters) if m is None))
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        group, size, dims = ctx.spec
        out = [None] * (2 * len(dims))
        means = scatter_means([grads[i] for i in ctx.trained], [dims[i] for i in ctx.trained],
                              group, size)
        for i, g in zip(ctx.trained, means):
            out[i] = g
        return (None, *out)


class _Piece:
    """A parameter that holds its dp piece: where it sits, along which dim,
    its f32 master (None: frozen), the last whole gathered from it."""

    def __init__(self, owner, pname, dim, master):
        self.owner, self.pname, self.dim, self.master = owner, pname, dim, master
        self.param = owner._parameters[pname]
        self.whole = None  # weakref


class _Regather:
    """A saved view of a gathered whole weight, kept as where to gather it
    again: its unit, its place there, and the view's geometry on the whole."""

    def __init__(self, gather, unit, index, view):
        self.gather, self.unit, self.index = gather, unit, index
        self.geometry = (view.size(), view.stride(), view.storage_offset())

    def get(self):
        return self.gather._regathered(self.unit)[self.index].as_strided(*self.geometry)


class PerUseGather:
    """fsdp's per-use gather (JAX's GSPMD gathers each weight where it is
    used): the parameters named in ``pieces`` (``{name: (dim, master or
    None)}``) hold this rank's dp piece, and each of ``units`` (modules that
    do not nest), and ``model`` itself for the parameters no unit holds,
    gathers its pieces into whole, contiguous tensors over ``group`` in one
    all-gather when it is called, and puts the pieces back when it returns,
    so that its whole weights live only while it runs.

    - The gather differentiates where a piece has an f32 ``master``: the
      backward reduce-scatters the unit's whole gradients over dp, averaged,
      in f32, in one call, onto the masters (``master.grad``).
    - A recomputed unit (``torch.utils.checkpoint``) gathers again in its
      recomputation. Elsewhere, while ``model`` runs, a saved-tensor hook
      keeps each saved view of a whole weight as where to gather it again
      (``_Regather``); the backward gathers the unit again when it first
      reads one and holds that one unit's wholes until it reads another's
      or ``release`` is called.
    - ``group`` None (dp = 1): the pieces are whole and nothing is gathered,
      but the gradients still reach the masters through the gather.

    ``gathers`` counts the units' gathers (one all-gather each where dp > 1);
    ``live_wholes()`` the gathered whole tensors still alive."""

    def __init__(self, model, units, pieces, group, size):
        self.group, self.size = group, size
        self.gathers = 0
        self.live = {}  # storage of a whole weight -> (unit, index), while its unit runs
        self._held = None  # (unit, wholes) the backward gathered last
        self._contexts = []
        chosen = set(units)
        prefixes = {name: unit for name, unit in model.named_modules() if unit in chosen}
        self.by_unit = {unit: [] for unit in [model, *units]}
        for name, (dim, master) in pieces.items():
            owner_name, _, pname = name.rpartition(".")
            unit = next((u for prefix, u in prefixes.items()
                         if name.startswith(prefix + ".")), model)
            self.by_unit[unit].append(_Piece(model.get_submodule(owner_name), pname, dim, master))
        self.root = model
        for unit, items in self.by_unit.items():
            if items or unit is model:
                unit.register_forward_pre_hook(self._enter)
                unit.register_forward_hook(self._exit, always_call=True)

    def _gather(self, unit, grad):
        items = self.by_unit[unit]
        spec = (self.group, self.size, [p.dim for p in items])
        data = [p.param.detach() for p in items]
        masters = [p.master for p in items]
        self.gathers += 1
        if grad and torch.is_grad_enabled() and any(m is not None for m in masters):
            wholes = _GatherForUse.apply(spec, *masters, *data)
        else:
            wholes = gather_wholes(data, spec[2], self.group, self.size)
        if self.group is not None:
            for p, w in zip(items, wholes):
                p.whole = weakref.ref(w)
        return wholes

    def _regathered(self, unit):
        if self._held is None or self._held[0] is not unit:
            self._held = None
            self._held = (unit, self._gather(unit, grad=False))
        return self._held[1]

    def release(self):
        """Drop the wholes the backward gathered last."""
        self._held = None

    def _enter(self, unit, args):
        if unit is self.root:
            self.release()
            if self.group is not None:
                ctx = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
                ctx.__enter__()
                self._contexts.append(ctx)
        items = self.by_unit[unit]
        if not items:
            return
        for i, (p, whole) in enumerate(zip(items, self._gather(unit, grad=True))):
            p.owner._parameters[p.pname] = whole
            if self.group is not None:
                self.live[whole.untyped_storage().data_ptr()] = (unit, i)

    def _exit(self, unit, args, out):
        for p in self.by_unit[unit]:
            whole = p.owner._parameters[p.pname]
            p.owner._parameters[p.pname] = p.param
            self.live.pop(whole.untyped_storage().data_ptr(), None)
        if unit is self.root and self._contexts:
            self._contexts.pop().__exit__(None, None, None)

    def _pack(self, t):
        where = self.live.get(t.untyped_storage().data_ptr()) if self.live else None
        return t if where is None else _Regather(self, *where, t)

    @staticmethod
    def _unpack(x):
        return x.get() if isinstance(x, _Regather) else x

    def live_wholes(self, root=True):
        """The gathered whole tensors alive now (of ``model``'s own pieces
        too unless ``root`` is False)."""
        return sum(1 for unit, items in self.by_unit.items() if root or unit is not self.root
                   for p in items if p.whole is not None and p.whole() is not None)


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
