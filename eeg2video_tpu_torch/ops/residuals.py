"""Residuals that a recomputed UNet block keeps instead of recomputing.

Counterpart of the remat policy of ``eeg2video_tpu/models/unet3d.py:139-154``
(``save_only_these_names``) and of the ``checkpoint_name`` marks it reads:

- ``flash_out``: the attention kernels' out and lse, and the temporal
  forward's output (ops/attention.py:1634-1635, ops/temporal.py:329 there);
- ``ff_out``: the outputs of ``ff_ln`` and ``geglu_out`` (ops/geglu.py:167,
  :364);
- ``resnet_conv``: a resnet's conv1 output with the time embedding added,
  and its conv2 output (models/resnet3d.py:296, :336, :356).

``checkpoint_contexts(names)`` makes the ``context_fn`` pair of a
non-reentrant ``torch.utils.checkpoint``: in the block's forward each marked
value is recorded, in program order; in the recomputation the same sites
hand the recorded values back in the same order. So a saved forward runs
once per call site, and everything else is recomputed. Two kinds of site:

- ``forward(name, op, compute)`` inside an ``autograd.Function``'s forward.
  The kernels launch through ctypes, where no dispatcher sees them, so the
  Function asks: the recomputation gets the recorded outputs without a
  launch, and the Function's node is built all the same;
- ``region(name)``, a ``with`` block of library ops (a resnet conv and the
  adds and casts after it). A dispatch mode records the output of the
  block's last op that is not a view. In the recomputation each such op
  returns an unfilled tensor of its recorded layout, and the last one the
  recorded output, so autograd records every op's backward while no
  convolution runs. Only ops whose backward reads no output of the block may
  stand in one: convolutions, adds, casts, copies and views
  (``REGION_OPS``); any other op in a region raises.

``forward_runs`` counts the forward computations at the sites, by op, on any
device: the per-op counter of the CPU path (``_build.launches`` counts the
launches on the card).
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

FLASH_OUT, FF_OUT, RESNET_CONV = "flash_out", "ff_out", "resnet_conv"

_aten = torch.ops.aten
# The non-view ops a region may hold. The backward of none of them reads a
# tensor that the region produced, so the recomputation may hand them
# unfilled stand-ins.
REGION_OPS = frozenset({_aten.convolution, _aten.add, _aten._to_copy, _aten.clone,
                        _aten._unsafe_view})

forward_runs = Counter()
_active = threading.local()


class _Record:
    """The marked values of one checkpointed call, in program order."""

    def __init__(self, names):
        self.names = frozenset(names)
        self.entries = []  # (op, value): a tuple of tensors, or a region's output
        self.replay = False
        self.pos = 0

    def take(self, op):
        if self.pos >= len(self.entries) or self.entries[self.pos][0] != op:
            got = self.entries[self.pos][0] if self.pos < len(self.entries) else "nothing"
            raise RuntimeError(f"saved residuals: the recomputation reached {op} where the "
                               f"forward recorded {got}")
        self.pos += 1
        return self.entries[self.pos - 1][1]


@contextlib.contextmanager
def _use(rec, replay):
    before = getattr(_active, "record", None)
    _active.record, rec.replay, rec.pos = rec, replay, 0
    try:
        yield
    finally:
        _active.record = before


def checkpoint_contexts(names):
    """The (forward, recomputation) context managers of one checkpointed
    call that keeps the values marked with ``names``."""
    rec = _Record(names)
    return _use(rec, False), _use(rec, True)


def _record_for(name):
    rec = getattr(_active, "record", None)
    return rec if rec is not None and name in rec.names else None


def forward(name, op, compute):
    """``compute()`` (a tensor or a tuple of tensors) at a site marked
    ``name``: inside a checkpointed call that keeps ``name``, recorded in its
    forward and handed back in its recomputation; elsewhere computed."""
    rec = _record_for(name)
    if rec is not None and rec.replay:
        value = rec.take(op)
        return tuple(t.detach() for t in value) if isinstance(value, tuple) else value.detach()
    forward_runs[op] += 1
    value = compute()
    if rec is not None:
        rec.entries.append((op, tuple(t.detach() for t in value) if isinstance(value, tuple)
                            else value.detach()))
    return value


class _Region(TorchDispatchMode):
    def __init__(self, rec, op):
        super().__init__()
        self.rec, self.op = rec, op
        self.layouts, self.last = [], None
        if rec.replay:
            self.layouts, self.value, self.version = rec.take(op)
            self.pos = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:
            return func(*args, **kwargs)
        if func.overloadpacket not in REGION_OPS:
            raise RuntimeError(f"saved residuals: {func} may not stand in a {self.op} region: "
                               "its backward could read a tensor the recomputation leaves "
                               "unfilled")
        if not self.rec.replay:
            out = func(*args, **kwargs)
            if not isinstance(out, torch.Tensor):
                raise RuntimeError(f"saved residuals: {func} in a {self.op} region returns "
                                   f"{type(out).__name__}, not one tensor")
            self.layouts.append((tuple(out.shape), out.stride(), out.dtype, out.device))
            self.last = out
            return out
        i, self.pos = self.pos, self.pos + 1
        if i == len(self.layouts) - 1:
            if self.value._version != self.version:
                raise RuntimeError(f"saved residuals: the recorded {self.op} output was "
                                   "modified in place after its forward")
            return self.value.detach()
        shape, stride, dtype, device = self.layouts[i]
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)


@contextlib.contextmanager
def region(name, op):
    """A block of library ops whose last output is marked ``name`` (see the
    module docstring); counted in ``forward_runs`` under ``op`` when it
    computes."""
    rec = _record_for(name)
    if rec is None:
        forward_runs[op] += 1
        yield
        return
    mode = _Region(rec, op)
    if not rec.replay:
        forward_runs[op] += 1
    with mode:
        yield
    if not rec.replay:
        if mode.last is None:
            raise RuntimeError(f"saved residuals: the {op} region ran no op")
        value = mode.last.detach()
        rec.entries.append((op, (mode.layouts, value, value._version)))
    elif mode.pos != len(mode.layouts):
        raise RuntimeError(f"saved residuals: the {op} region ran {mode.pos} ops in its "
                           f"recomputation, {len(mode.layouts)} in its forward")
