"""Video IO: block-video -> per-clip GIF extraction (the ``gif`` stage),
the training clip loader, GIF output of the serving path (grid writer,
encoders, background writer threads) and a GIF reader.

Counterpart of ``eeg2video_tpu/data/video.py`` (``clip_frame_schedule``,
``read_video_frames``, ``extract_gifs_from_block``, ``VideoClipDataset``,
``save_videos_grid``, ``_write_gif_fast``, ``AsyncVideoWriter``,
``dispatch_ahead``, ``load_gif``). Differences:
``extract_gifs_from_block`` writes its GIFs with the native encoder (JAX:
imageio), so it needs cv2 to read the block video and nothing else;
``VideoClipDataset.load_all`` decodes clip by clip with cv2, which needs
only the Python package, where JAX takes the C++ decoder
(``native.decode_clips``: ported, but it links opencv4's development files,
which a host with only the Python package lacks); it raises on a clip
shorter than asked for, as ``__getitem__`` does, where JAX's zero-pads it;
``encoder="native"`` encodes or raises (it never gives way to ``fast``);
and ``load_gif`` decodes GIFs itself, so reading a GIF back needs neither
imageio nor Pillow.
"""

from __future__ import annotations

import os

import numpy as np

from . import meta


def clip_frame_schedule(fps: int = meta.VIDEO_FPS, n_concepts: int = meta.N_CONCEPTS,
                        reps: int = meta.N_REPS):
    """Per-frame clip id of one block video: 0 for the hint before each
    concept (discarded), 1..reps for its clips (reference extract_gif.py:42-45)."""
    per_concept = [0] * (meta.BASELINE_SEC * fps)
    for rep in range(1, reps + 1):
        per_concept += [rep] * (meta.CLIP_SEC * fps)
    return np.tile(np.asarray(per_concept, np.int32), n_concepts)


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading video files needs the cv2 module (opencv-python), which "
            "is not installed") from e
    return cv2


def read_video_frames(path: str, resize_hw=None):
    """Decode all frames of a video as RGB uint8 (cv2), (N, H, W, 3);
    ``resize_hw`` (h, w) resizes at decode. A file that yields no frame gives
    a shape-correct empty array."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if resize_hw is not None:
            h, w = resize_hw
            frame = cv2.resize(frame, (w, h))
        frames.append(frame)
    cap.release()
    if frames:
        return np.stack(frames)
    h, w = resize_hw if resize_hw is not None else (0, 0)
    return np.zeros((0, h, w, 3), np.uint8)


def extract_gifs_from_block(video_path: str, out_dir: str, height: int = meta.GIF_HEIGHT,
                            width: int = meta.GIF_WIDTH, take_every: int = 8,
                            duration: float = 0.333):
    """One block video -> a GIF per clip (reference extract_gif.py): walk the
    frames along ``clip_frame_schedule``, convert BGR -> RGB, resize to
    (width, height), and of each clip's frames keep every ``take_every``-th,
    the first ``meta.GIF_FRAMES`` of them, written as ``{clip_index}.gif``
    in presentation order, ``duration`` seconds a frame. Returns the written
    indices."""
    from .native import write_gif_native

    cv2 = _cv2()
    os.makedirs(out_dir, exist_ok=True)
    schedule = clip_frame_schedule()
    written, clip_frames = [], []

    def flush():
        sel = np.stack(clip_frames[::take_every][:meta.GIF_FRAMES])
        write_gif_native(os.path.join(out_dir, f"{len(written)}.gif"), sel, duration * 1000.0)
        written.append(len(written))

    cap = cv2.VideoCapture(video_path)
    prev_id = 0
    for cid in schedule:
        ok, frame = cap.read()
        if not ok:
            break
        if cid != prev_id and clip_frames:
            flush()
            clip_frames = []
        if cid > 0:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            clip_frames.append(cv2.resize(rgb, (width, height)))
        prev_id = cid
    cap.release()
    if clip_frames:
        flush()
    return written


class VideoClipDataset:
    """Training clip loader (the reference's TuneMultiVideoDataset,
    dataset.py:52-88): per item decode a video, resize to (width, height),
    take every ``sample_frame_rate``-th frame, the first ``n_sample_frames``
    of them, scale to [-1, 1]. Items are channels-last (F, H, W, 3) float32
    with the index of their prompt."""

    def __init__(self, video_paths, prompt_ids, width=512, height=288,
                 n_sample_frames=6, sample_frame_rate=8, sample_start_idx=0):
        if len(video_paths) != len(prompt_ids):
            raise ValueError("one prompt id per video path")
        self.video_paths = list(video_paths)
        self.prompt_ids = np.asarray(prompt_ids)
        self.width, self.height = width, height
        self.n_sample_frames = n_sample_frames
        self.sample_frame_rate = sample_frame_rate
        self.sample_start_idx = sample_start_idx

    def __len__(self):
        return len(self.video_paths)

    def __getitem__(self, i):
        frames = read_video_frames(self.video_paths[i], resize_hw=(self.height, self.width))
        idx = np.arange(self.sample_start_idx, len(frames), self.sample_frame_rate)
        idx = idx[: self.n_sample_frames]
        if len(idx) < self.n_sample_frames:
            # fail here with the path, not at a far-away shape mismatch
            raise ValueError(
                f"{self.video_paths[i]}: decoded {len(frames)} frames, "
                f"need {self.n_sample_frames} at stride "
                f"{self.sample_frame_rate} from {self.sample_start_idx}")
        clip = frames[idx].astype(np.float32) / 127.5 - 1.0
        return {"pixel_values": clip, "prompt_ids": self.prompt_ids[i]}

    def load_all(self):
        """Decode every clip once, clip by clip with cv2 as ``__getitem__``
        does: (N, F, H, W, 3) float32 in [-1, 1] and the prompt ids, for the
        resident-dataset trainer."""
        pixels = np.stack([self[i]["pixel_values"] for i in range(len(self))])
        return pixels, self.prompt_ids


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
