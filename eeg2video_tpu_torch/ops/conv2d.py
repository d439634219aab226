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
# csrc/conv3x3.cu: a block owns a TILE_ROWS x TILE_COLS pixel tile of one
# image and BLOCK_COUT output channels, and reads the input in CIN_CHUNK slices
TILE_ROWS, TILE_COLS, BLOCK_COUT, CIN_CHUNK = 4, 64, 160, 64


def tiles_per_image(h, w):
    """Pixel tiles of one image: the kernel's per-image stats partials."""
    return -(-h // TILE_ROWS) * -(-w // TILE_COLS)


def l2_read_bytes(n, h, w, cin, cout):
    """Bytes the kernel's blocks copy from L2 in one call, from the tiling:
    every block reads its weight rows (9 Cin bf16 each), scale and shift of
    its image (f32) and its tile's halo (the input pixels inside the image
    within one pixel of the tile, Cin bf16 each)."""
    halo = sum((min(y0 + TILE_ROWS + 1, h) - max(y0 - 1, 0))
               * (min(x0 + TILE_COLS + 1, w) - max(x0 - 1, 0))
               for y0 in range(0, h, TILE_ROWS) for x0 in range(0, w, TILE_COLS))
    cout_blocks = -(-cout // BLOCK_COUT)
    return n * (tiles_per_image(h, w) * (cout * 9 * cin * 2 + cout_blocks * 2 * cin * 4)
                + cout_blocks * halo * cin * 2)


def weight_slabs(w):
    """The kernel's weight layout: the (Cout, Cin, 3, 3) weight zero-padded to
    BLOCK_COUT-row blocks and CIN_CHUNK-channel chunks, as (Cout block, chunk,
    dy, dx, row // 8, channel // 8, row % 8, channel % 8): per (block, chunk,
    tap) a contiguous 160 x 64 slab of the 8 x 8 core matrices that the
    kernel's wgmma reads from shared memory."""
    cout, cin = w.shape[:2]
    cb, nc = -(-cout // BLOCK_COUT), -(-cin // CIN_CHUNK)
    if (cb * BLOCK_COUT, nc * CIN_CHUNK) != (cout, cin):
        w = F.pad(w, (0, 0, 0, 0, 0, nc * CIN_CHUNK - cin, 0, cb * BLOCK_COUT - cout))
    return (w.reshape(cb, BLOCK_COUT // 8, 8, nc, CIN_CHUNK // 8, 8, 3, 3)
            .permute(0, 3, 6, 7, 1, 4, 2, 5).contiguous())


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
    stats. A CUDA tensor launches the kernel (bf16 x and w, Cin % 8 == 0, any
    H and W: tiles never cross an image, the kernel writes one stats partial
    per tile and adds an image's partials in tile order, so an image's output
    and stats are the same bits on every run and whatever else is in the
    batch); a CPU tensor takes ``conv3x3_gn_silu_plain``."""
    if not x.is_cuda:
        return conv3x3_gn_silu_plain(x, w, b, scale, shift, temb, with_stats)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    req = _build.require
    req(w.shape == (cout, cin, 3, 3), KERNEL, "w must be (Cout, Cin, 3, 3)")
    req(cin % 8 == 0, KERNEL, f"Cin={cin} must be a multiple of 8")
    req(x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16, KERNEL,
        "x and w must be bf16")
    x = x.contiguous()
    req(x.data_ptr() % 16 == 0, KERNEL, "x must be 16-byte aligned")
    wk = weight_slabs(w)
    bf = b.float().contiguous()
    sc, sh = scale.float().contiguous(), shift.float().contiguous()
    tb = temb.float().contiguous() if temb is not None else None
    for t, shape in ((sc, (n, cin)), (sh, (n, cin)), (tb, (n, cout))):
        req(t is None or tuple(t.shape) == shape, KERNEL,
            f"per-image operand must be {shape}")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    # the per-tile partials, then the per-image sums the kernel adds from them
    stats = (torch.empty((n * tiles_per_image(h, wd) + n, 2, cout), dtype=torch.float32,
                         device=x.device) if with_stats else None)
    ptr = _build.ptr
    rc = _build.library().e2v_conv3x3(
        x.data_ptr(), sc.data_ptr(), sh.data_ptr(), wk.data_ptr(), bf.data_ptr(), ptr(tb),
        out.data_ptr(), ptr(stats), n, h, wd, cin, cout, _build.stream_of(x))
    _build.check(rc, KERNEL)
    _build.launches[KERNEL] += 1
    if not with_stats:
        return out
    return out, stats[n * tiles_per_image(h, wd):]
