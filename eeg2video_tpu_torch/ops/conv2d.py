"""GroupNorm-apply + SiLU + 3x3 conv: ``conv3x3_gn_silu`` (CUDA kernel 4) and
its plain PyTorch version.

Counterpart of ``eeg2video_tpu/ops/conv2d.py`` (``fused_conv3x3_t`` and
``fused_conv3x3_t_stats``). NHWC activations; the weight is the PyTorch
(Cout, Cin, 3, 3) Conv2d weight.

Inference only: with ``train=True`` the resnets take the library convolution
(``models.resnet3d``; the JAX package's ``use1/use2 = not train and ...``,
resnet3d.py:227-238, 262, 297, whose kernel has a plain XLA backward), so a
train step launches this kernel 0 times, no backward kernel exists for it,
and the wrapper is not differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "conv3x3_gn_silu"
PIXEL_TILE = 64  # pixels one block covers (csrc/conv3x3.cu kBM)


def eligible(h, w, cin, cout):
    """The convs the JAX package sends to its kernel (conv2d.py:124), with
    the bf16 requirement dropped: level-0 generation shapes."""
    return ((h * w) % 128 == 0 and cout % 128 != 0 and cout % 8 == 0
            and cin % 8 == 0 and h >= 3 and w >= 3
            and (h * w) * 3 * cin * 2 <= 9 * 1024 * 1024)


def conv3x3_gn_silu_plain(x, w, b, scale, shift, temb=None, with_stats=False):
    """conv3x3(silu(x*scale + shift)) + b (+ temb), computed in f32 with the
    prologue rounded to x.dtype. x (N, H, W, Cin); scale/shift (N, Cin);
    temb (N, Cout) or None. With ``with_stats`` also returns the (N, 2, Cout)
    f32 (sum, sum of squares) of the output as stored."""
    a = F.silu(x.float() * scale.float()[:, None, None, :]
               + shift.float()[:, None, None, :])
    a = a.to(x.dtype).float().permute(0, 3, 1, 2)
    out = F.conv2d(a, w.float(), b.float(), padding=1).permute(0, 2, 3, 1)
    if temb is not None:
        out = out + temb.float()[:, None, None, :]
    out = out.to(x.dtype)
    if not with_stats:
        return out
    of = out.float()
    stats = torch.stack([of.sum(dim=(1, 2)), (of * of).sum(dim=(1, 2))], dim=1)
    return out, stats


def conv3x3_gn_silu(x, w, b, scale, shift, temb=None, with_stats=False):
    """Implicit-GEMM 3x3 SAME conv with the silu(x*scale + shift) prologue
    (zero padding applied after it), bias/temb epilogue and optional output
    stats. A CUDA tensor launches the kernel (bf16 x and w, Cin % 8 == 0; with
    stats H*W % 64 == 0: the kernel writes one partial per 64-pixel block and
    the partials of an image are added here in a fixed order, so the stats
    are the same bits every run); a CPU tensor takes
    ``conv3x3_gn_silu_plain``."""
    if not x.is_cuda:
        return conv3x3_gn_silu_plain(x, w, b, scale, shift, temb, with_stats)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    req = _build.require
    req(w.shape == (cout, cin, 3, 3), KERNEL, "w must be (Cout, Cin, 3, 3)")
    req(cin % 8 == 0, KERNEL, f"Cin={cin} must be a multiple of 8")
    req(x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16, KERNEL,
        "x and w must be bf16")
    req(not with_stats or (h * wd) % PIXEL_TILE == 0, KERNEL,
        f"with_stats needs H*W={h * wd} to be a multiple of {PIXEL_TILE}")
    x = x.contiguous()
    wk = w.permute(0, 2, 3, 1).contiguous()  # (Cout, 3, 3, Cin): tap-major K
    bf = b.float().contiguous()
    sc, sh = scale.float().contiguous(), shift.float().contiguous()
    tb = temb.float().contiguous() if temb is not None else None
    for t, shape in ((sc, (n, cin)), (sh, (n, cin)), (tb, (n, cout))):
        req(t is None or tuple(t.shape) == shape, KERNEL,
            f"per-image operand must be {shape}")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    stats = (torch.empty((n * h * wd // PIXEL_TILE, 2, cout), dtype=torch.float32,
                         device=x.device) if with_stats else None)
    ptr = _build.ptr
    rc = _build.library().e2v_conv3x3(
        x.data_ptr(), sc.data_ptr(), sh.data_ptr(), wk.data_ptr(), bf.data_ptr(), ptr(tb),
        out.data_ptr(), ptr(stats), n, h, wd, cin, cout, _build.stream_of(x))
    _build.check(rc, KERNEL)
    _build.launches[KERNEL] += 1
    if not with_stats:
        return out
    return out, stats.view(n, -1, 2, cout).sum(dim=1)
