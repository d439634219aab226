"""8-bit Adam / AdamW and the cosine schedule of the trainers.

Counterpart of ``eeg2video_tpu/train/optim.py`` (``scale_by_adam8bit`` :51,
``adam8bit`` :145, ``adamw8bit`` :154, ``state_bytes`` :165): both Adam
moments are stored as int8 with one f32 scale per row, cutting the optimizer
state about 4x. The arithmetic
is the JAX package's, step for step:

- m is stored in signed sqrt space (int8 of sign(m) sqrt|m|), v in 4th-root
  space (int8 of v^(1/4)): row-granular linear codes round small coordinates
  to 0 and stall convergence, and a v of 0 blows up m / (sqrt(v) + eps);
- a row runs along the parameter's first axis: JAX's rows run along the last
  axis of flax's layout, which keeps the output features last ((..., in,
  out)), and torch's modules keep them first (``nn.Linear``'s (out, in),
  convolutions' (out, in, kh, kw)), so the rows, and the codes, are JAX's;
- each new scale is a bound anchored to the stored old row maximum,
  ``b1 * max|m_old| + (1 - b1) * max|g|`` (and its 4th-root analog for v),
  so no reduce runs over the new moment; a zero scale becomes 1;
- a scalar parameter is one row of one element;
- where a parameter's first axis is split over ranks (fsdp or a tp column
  split: a shard holds some of its rows), the three maxima over that axis
  are taken over the whole axis, by one all-reduce (MAX) over the groups
  that split it (``Adam8bit.row_groups``), as GSPMD reduces JAX's;
- bias correction is optax's ``scale_by_adam``'s;
- AdamW adds ``weight_decay * p`` to the Adam update and then scales by
  ``-lr`` (optax's ``add_decayed_weights`` then ``scale_by_learning_rate``).

The update is plain PyTorch, about 25 elementwise passes over each leaf: the
JAX version is XLA, not a Pallas kernel, so no hand kernel is owed; a fused
per-row kernel is future work (ROADMAP §2).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# The JAX package's roundings, as XLA compiles its update: a constant divisor
# becomes a multiply by its float32 reciprocal, (m / c1) / d becomes
# m / (c1 * d), and a product added to a product is fused into one
# multiply-add (torch.add with alpha and torch.addcmul are fused multiply-adds
# on the CPU and the card alike)
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def true_div(x, divisor: float):
    """``x / divisor`` rounded as a true division on every device: PyTorch's
    CUDA kernel multiplies by the reciprocal of a Python scalar divisor (which
    XLA keeps only for constants), a 0-dim tensor on x's device it divides by."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def _sqrt(x):
    """The correctly rounded square root that XLA and the card compute:
    torch's CPU sqrt is one unit in the last place off on about 0.6% of
    float32 inputs, float64's rounded to float32 is exact."""
    return x.sqrt() if x.is_cuda else x.double().sqrt().float()


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """optax.cosine_decay_schedule (alpha 0, exponent 1), in float32 as optax
    computes it: ``init * 0.5 * (1 + cos(pi * min(count, T) / T))``."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")
    t = np.float32(decay_steps)

    def schedule(count: int) -> float:
        c = np.minimum(np.float32(count), t)
        cos = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(np.pi) * c / t))
        return float(np.float32(init_value) * cos)

    return schedule


def set_lr(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr


class Adam8bit(torch.optim.Optimizer):
    """Adam (``weight_decay`` 0, the JAX ``adam8bit``) or AdamW (the JAX
    ``adamw8bit``) with int8 moments.

    Each parameter's state holds what ``Adam8State`` holds: ``count`` (an
    int), ``mq`` (int8, the parameter's shape), ``ms`` (f32, ``(1,) +
    shape[1:]``, one scale a row; ``(1,)`` for a scalar), ``vq`` and ``vs``
    likewise for v. The scales start at 0, "empty": they are anchored bounds,
    and a nonzero start would freeze the moments near zero."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        # {parameter: process groups over which its first axis is split}
        self.row_groups = {}

    @staticmethod
    def _init_state(p):
        sshape = (1,) + tuple(p.shape[1:])
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=p.device)
        return {"count": 0, "mq": zeros(p.shape, torch.int8), "ms": zeros(sshape, torch.float32),
                "vq": zeros(p.shape, torch.int8), "vs": zeros(sshape, torch.float32)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                if not self.state[p]:
                    self.state[p] = self._init_state(p)
                st = self.state[p]
                st["count"] += 1
                u, st["mq"], st["ms"], st["vq"], st["vs"] = adam8_update(
                    p.grad, st["mq"], st["ms"], st["vq"], st["vs"], st["count"], b1, b2,
                    group["eps"], self.row_groups.get(p, ()))
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.add_(u * -group["lr"])

    def load_state_dict(self, state_dict):
        """``Optimizer.load_state_dict`` casts every state tensor to its
        parameter's dtype, which would turn the int8 codes into floats: load
        the groups through it and the state here, dtypes kept."""
        saved = state_dict["state"]
        for st in saved.values():
            if set(st) != {"count", "mq", "ms", "vq", "vs"}:
                raise ValueError(f"not an 8-bit Adam state: {sorted(st)}")
        super().load_state_dict({"state": {}, "param_groups": state_dict["param_groups"]})
        params = [p for group in self.param_groups for p in group["params"]]
        for i, p in enumerate(params):
            if i in saved:
                self.state[p] = {k: v.to(p.device) if torch.is_tensor(v) else v
                                 for k, v in saved[i].items()}


def _row_maxima(g, mq, vq, groups):
    """max |g|, max |mq| and max vq over the first axis (keepdim), each over
    the whole axis where ``groups`` split it: one all-reduce (MAX) a group."""
    maxima = [g.abs().amax(dim=0, keepdim=True), mq.float().abs().amax(dim=0, keepdim=True),
              vq.float().amax(dim=0, keepdim=True)]
    if not groups:
        return maxima
    stacked = torch.cat(maxima)
    for group in groups:
        dist.all_reduce(stacked, op=dist.ReduceOp.MAX, group=group)
    return list(stacked.split(1))


def adam8_update(g, mq, ms, vq, vs, count, b1, b2, eps, row_groups=()):
    """One leaf of ``scale_by_adam8bit.update`` (JAX optim.py:74-136), its
    rows along the first axis: returns the Adam update u (g's shape and
    dtype) and the new (mq, ms, vq, vs). ``row_groups``: the process groups
    over which the leaf's first axis is split (its maxima are the whole
    axis's)."""
    gf = g.float()
    shape = g.shape
    if not g.dim():  # a scalar leaf: one row of one element
        gf, mq, vq = gf.reshape(1), mq.reshape(1), vq.reshape(1)
    c1 = np.float32(1.0) - np.float32(b1) ** np.float32(count)
    c2 = np.float32(1.0) - np.float32(b2) ** np.float32(count)
    mq2 = mq.float() * ms
    m = torch.add(b1 * torch.sign(mq2) * mq2 * mq2, gf, alpha=1.0 - b1)
    vq4 = vq.float() * vs  # the 4th-root-space value
    vsq = vq4 * vq4
    v = torch.addcmul(b2 * vsq * vsq, (1.0 - b2) * gf, gf)
    u = m / (float(c1) * (_sqrt(true_div(v, float(c2))) + eps))
    gmax, mqmax, vqmax = _row_maxima(gf, mq, vq, row_groups if g.dim() else ())
    m_oldmax = torch.square(mqmax * ms)
    nms = _sqrt(torch.add(b1 * m_oldmax, gmax, alpha=1.0 - b1)) * _INV127
    nms = torch.where(nms == 0.0, 1.0, nms)
    nmq = torch.clamp(torch.round(torch.sign(m) * _sqrt(m.abs()) / nms),
                      -127.0, 127.0).to(torch.int8)
    w_oldmax = vqmax * vs
    v_oldmax = torch.square(torch.square(w_oldmax))
    nvs = _sqrt(_sqrt(torch.addcmul(b2 * v_oldmax, (1.0 - b2) * gmax, gmax))) * _INV127
    nvs = torch.where(nvs == 0.0, 1.0, nvs)
    nvq = torch.clamp(torch.round(_sqrt(_sqrt(v)) / nvs), 0.0, 127.0).to(torch.int8)
    return (u.reshape(shape).to(g.dtype), nmq.reshape(shape), nms,
            nvq.reshape(shape), nvs)


def state_bytes(optimizer) -> int:
    """Bytes of every tensor of an optimizer's state (the 4x-state tests and
    the trainers' reports)."""
    return sum(v.numel() * v.element_size() for st in optimizer.state.values()
               for v in st.values() if torch.is_tensor(v))
