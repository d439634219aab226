"""GIF output of the serving path: grid writer, encoders, background writer
threads, and a GIF reader.

Counterpart of ``eeg2video_tpu/data/video.py`` (``save_videos_grid``,
``_write_gif_fast``, ``AsyncVideoWriter``, ``dispatch_ahead``, ``load_gif``;
:109-114, 165-267). The block-video extraction and the training clip dataset
there are not ported yet. Two differences: ``encoder="native"`` encodes or
raises (it never gives way to ``fast``), and ``load_gif`` decodes GIFs itself,
so reading a GIF back needs neither imageio nor Pillow.
"""

from __future__ import annotations

import os

import numpy as np


def _write_gif_fast(path, frames, duration_ms):
    """Shared-adaptive-palette GIF encode with Pillow: one FASTOCTREE palette
    built from a 4x-subsampled stack of all frames, every frame mapped to it
    without dithering (one quantization instead of imageio's per-frame
    adaptive palettes)."""
    from PIL import Image

    sample = np.concatenate([f[::4, ::4] for f in frames], axis=0)
    pal = Image.fromarray(sample).quantize(colors=256, method=Image.FASTOCTREE)
    qs = [Image.fromarray(f).quantize(colors=256, palette=pal,
                                      dither=Image.Dither.NONE)
          for f in frames]
    qs[0].save(path, save_all=True, append_images=qs[1:],
               duration=int(duration_ms), loop=0)


def save_videos_grid(videos: np.ndarray, path: str, n_rows: int = 4,
                     fps: int = 3, encoder: str = "imageio"):
    """(B, F, H, W, 3) in [0, 1] -> grid GIF (reference tuneavideo/util.py:20-32).

    ``encoder``: "native" (``csrc/gif_encoder.cpp``: shared median-cut
    palette, threaded LZW, no GIL; raises if it cannot be built), "fast"
    (shared Pillow palette, see ``_write_gif_fast``), or "imageio" (the
    reference's mimsave path, per-frame adaptive palettes)."""
    if encoder not in ("native", "fast", "imageio"):
        raise ValueError(f"unknown gif encoder '{encoder}' (native | fast | imageio)")
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    b, f, h, w, c = videos.shape
    cols = min(n_rows, b)
    rows = (b + cols - 1) // cols
    frames = []
    for t in range(f):
        grid = np.zeros((rows * h, cols * w, c), np.float32)
        for i in range(b):
            r, cc = divmod(i, cols)
            grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = videos[i, t]
        frames.append((grid * 255).astype(np.uint8))
    if encoder == "native":
        from .native import write_gif_native

        write_gif_native(path, np.stack(frames), 1000.0 / fps)
    elif encoder == "fast":
        _write_gif_fast(path, frames, 1000.0 / fps)
    else:
        import imageio

        imageio.mimsave(path, frames, duration=1.0 / fps)


class AsyncVideoWriter:
    """Background GIF writer: encodes on worker threads so the device starts
    the next batch while the host writes the previous one. ``submit`` takes a
    host array (the device -> host copy is the caller's, so dispatch the next
    device batch before submitting); ``close`` joins and re-raises the first
    worker error."""

    def __init__(self, workers: int = 2, encoder: str = "imageio"):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = []
        self.encoder = encoder

    def submit(self, videos, path, **kw):
        videos = np.asarray(videos)
        fut = self._pool.submit(
            save_videos_grid, videos, path, encoder=self.encoder, **kw)
        self._futures.append(fut)
        return fut  # callers may stream per-file completion (serving.batching)

    def close(self):
        try:
            for f in self._futures:
                f.result()
        finally:
            self._pool.shutdown(wait=True)


def dispatch_ahead(batches, run, flush):
    """Overlap device compute with host transfer/encode: call ``run`` on
    batch s+1 before ``flush``-ing batch s's result (the flush is where the
    device -> host sync happens), so the device does not idle on host work.
    The final pending result is flushed even if ``run`` raises mid-loop;
    callers wrap this in try/finally around their AsyncVideoWriter.close().

    ``run(batch) -> result``; ``flush(result, batch)`` consumes it."""
    pending = None
    try:
        for b in batches:
            out = run(b)
            if pending is not None:
                p, pending = pending, None
                flush(*p)
            pending = (out, b)
    finally:
        if pending is not None:
            flush(*pending)


# --- reading a GIF back --------------------------------------------------------

def _sub_blocks(buf, pos):
    """Concatenated data sub-blocks starting at ``pos``; returns (bytes, pos
    after the terminator)."""
    out = bytearray()
    while True:
        n = buf[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos
        out += buf[pos:pos + n]
        pos += n


def _lzw_decode(data, min_code, n_pixels):
    """GIF-LZW (variable width, LSB first) -> ``n_pixels`` palette indices."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, width, prev = list(base), min_code + 1, None
    out = bytearray()
    acc = nbits = 0
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= width:
            code = acc & ((1 << width) - 1)
            acc >>= width
            nbits -= width
            if code == clear:
                table, width, prev = list(base), min_code + 1, None
                continue
            if code == eoi:
                return np.frombuffer(bytes(out[:n_pixels]), np.uint8)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                if len(table) < 4096:  # a full table stays until the next clear
                    table.append(prev + entry[:1])
            elif code == len(table) < 4096:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"corrupt GIF: LZW code {code} past the table")
            out += entry
            prev = entry
            if len(table) == (1 << width) and width < 12:
                width += 1
    return np.frombuffer(bytes(out[:n_pixels]), np.uint8)


def load_gif(path: str) -> np.ndarray:
    """GIF -> (F, H, W, 3) uint8: every frame composed onto the logical
    screen (sub-rectangles, transparency, disposal to background)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:6] not in (b"GIF89a", b"GIF87a"):
        raise ValueError(f"{path} is not a GIF")
    width, height = int.from_bytes(buf[6:8], "little"), int.from_bytes(buf[8:10], "little")
    flags, pos = buf[10], 13
    gct = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        gct = np.frombuffer(buf[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n
    canvas = np.zeros((height, width, 3), np.uint8)
    frames, transparent, disposal = [], None, 0
    while pos < len(buf):
        kind = buf[pos]
        pos += 1
        if kind == 0x3B:  # trailer
            break
        if kind == 0x21:  # extension
            label = buf[pos]
            pos += 1
            data, pos = _sub_blocks(buf, pos)
            if label == 0xF9:  # graphic control: applies to the next image
                disposal = (data[0] >> 2) & 7
                transparent = data[3] if data[0] & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError(f"corrupt GIF: unknown block 0x{kind:02x} at byte {pos - 1}")
        x, y, w, h = (int.from_bytes(buf[pos + i:pos + i + 2], "little") for i in (0, 2, 4, 6))
        iflags = buf[pos + 8]
        pos += 9
        palette = gct
        if iflags & 0x80:
            n = 3 << ((iflags & 7) + 1)
            palette = np.frombuffer(buf[pos:pos + n], np.uint8).reshape(-1, 3)
            pos += n
        if iflags & 0x40:
            raise ValueError("interlaced GIFs are not supported")
        if palette is None:
            raise ValueError("corrupt GIF: image without a color table")
        min_code = buf[pos]
        data, pos = _sub_blocks(buf, pos + 1)
        idx = _lzw_decode(data, min_code, w * h)
        if idx.size != w * h:
            raise ValueError(f"corrupt GIF: frame {len(frames)} has {idx.size} of {w * h} pixels")
        idx = idx.reshape(h, w)
        region = canvas[y:y + h, x:x + w]
        before = region.copy()
        rgb = palette[np.minimum(idx, len(palette) - 1)]
        if transparent is None:
            region[...] = rgb
        else:
            keep = idx == transparent
            region[...] = np.where(keep[..., None], region, rgb)
        frames.append(canvas.copy())
        if disposal == 2:
            region[...] = 0
        elif disposal == 3:
            region[...] = before
        transparent, disposal = None, 0
    if not frames:
        raise ValueError(f"{path} holds no frames")
    return np.stack(frames)
