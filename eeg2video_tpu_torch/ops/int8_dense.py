"""Weight-only int8 dense layer: ``int8_dense`` (CUDA kernel 13), its plain
PyTorch version, and the quantizer.

Counterpart of ``eeg2video_tpu/ops/int8_dense.py``: the five layers of the
semantic MLP keep their weights as per-output-column int8 (absmax / 127
scales), a quarter of the f32 bytes, which is what a layer costs at serving
batch sizes. The layout is the JAX package's: ``w_q`` (Kp, Np) int8 with K
zero-padded to a multiple of 32 and N to a multiple of ``bn`` (padded columns
are all-zero with zero scale), ``scale`` (Np,) f32.

The kernel and its plain version compute the same thing: the activation
rounded to bf16, the int8 values converted exactly, products accumulated in
f32, then ``acc * scale + bias`` in f32. ReLU stays with the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

COL_TILE = 128    # columns one block covers (csrc/int8_dense.cu kBN)
K_STEP = 64       # its step along K (kBK)
TARGET_BLOCKS = 264  # two resident blocks on each of the 132 SMs


def quantize_int8(kernel, bn: int = 512):
    """Per-output-column absmax quantization of a (K, N) dense kernel, on the
    kernel's device: ``(w_q int8 (Kp, Np), scale f32 (Np,))``. Round half to
    even, clip to +-127; an all-zero column gets scale 0 and zeros."""
    w = torch.as_tensor(kernel, dtype=torch.float32)
    absmax = w.abs().amax(dim=0)
    scale = absmax / 127.0
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    w_q = torch.clamp(torch.round(w * inv[None, :]), -127, 127).to(torch.int8)
    k, n = w.shape
    w_q = F.pad(w_q, (0, (-n) % bn, 0, (-k) % 32))
    return w_q.contiguous(), F.pad(scale, (0, (-n) % bn))


def quantize_dense_tree(layers, bn: int = 512, device=None):
    """``{name: (kernel (K, N), bias (N,))}`` -> ``{name: (w_q, scale, bias,
    n_out)}``, the arguments of :func:`int8_dense` (biases stay f32). With
    ``device``, each kernel moves there just before it is quantized, so only
    one layer's f32 weight is on the device at a time."""
    out = {}
    for name, (kernel, bias) in layers.items():
        kernel = torch.as_tensor(kernel)
        if device is not None:
            kernel = kernel.to(device)
        w_q, scale = quantize_int8(kernel, bn=bn)
        out[name] = (w_q, scale, torch.as_tensor(bias).to(w_q.device, torch.float32),
                     int(kernel.shape[1]))
    return out


def _pad_k(x, kp):
    return F.pad(x, (0, kp - x.shape[1])) if x.shape[1] < kp else x


def int8_dense_plain(x, w_q, scale, bias, n_out: int):
    """bf16-rounded x times the int8 values, summed in f32, scale, bias."""
    xr = _pad_k(x.float(), w_q.shape[0]).bfloat16().float()
    y = xr @ w_q[:, :n_out].float()
    return y * scale[:n_out].float() + bias.float()


def k_splits(np_: int, kp: int) -> int:
    """Blocks along K: enough that the grid has about two blocks for each SM,
    at most one for each K step and at most 8."""
    col_blocks = np_ // COL_TILE
    k_steps = -(-kp // K_STEP)
    return max(1, min(TARGET_BLOCKS // col_blocks, k_steps, 8))


def int8_dense(x, w_q, scale, bias, n_out: int):
    """x (M, K) f32 times int8 weights -> (M, n_out) f32. ``w_q`` and
    ``scale`` come from :func:`quantize_int8`, ``bias`` is the layer's (n_out,)
    f32 bias. A CUDA tensor launches the kernel; a CPU tensor takes
    ``int8_dense_plain``."""
    if not x.is_cuda:
        return int8_dense_plain(x, w_q, scale, bias, n_out)
    kernel = "int8_dense"
    req = _build.require
    req(x.dim() == 2 and x.dtype == torch.float32 and x.shape[0] >= 1, kernel,
        "x must be a non-empty (M, K) float32 tensor")
    m, k = x.shape
    kp, np_ = w_q.shape
    req(w_q.dtype == torch.int8 and w_q.is_contiguous() and kp % 32 == 0
        and np_ % COL_TILE == 0 and w_q.data_ptr() % 16 == 0, kernel,
        f"w_q must be contiguous int8 (Kp, Np) with Kp % 32 == 0 and Np % {COL_TILE} == 0")
    req(k <= kp and 1 <= n_out <= np_, kernel, f"K={k} must be <= Kp={kp}, n_out <= Np={np_}")
    req(scale.shape == (np_,) and bias.shape == (n_out,), kernel,
        "scale must be (Np,) and bias (n_out,)")
    for t in (w_q, scale, bias):
        req(t.is_cuda and t.device == x.device, kernel, "all operands must be on x's device")
    xc = x.contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    splits = k_splits(np_, kp)
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    xb = torch.empty((m, kp), dtype=torch.bfloat16, device=x.device)
    part = (torch.empty((splits, m, np_), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    rc = _build.library().e2v_int8_dense(
        xc.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        xb.data_ptr(), _build.ptr(part), m, k, kp, np_, n_out, splits, _build.stream_of(x))
    _build.check(rc, kernel)
    _build.launches[kernel] += 1
    return out
