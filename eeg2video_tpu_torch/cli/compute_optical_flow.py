"""CLI: per-clip optical-flow motion scores for DANA, on the card.

Counterpart of ``eeg2video_tpu/cli/compute_optical_flow.py``: writes the
(blocks, clips) ``All_video_optical_flow_score.npy`` table that DANA's
``add_noise`` reads (reference EEG2Video_New/DANA/add_noise.py:103, which
ships it with no producer). Reads the per-block GIF directories that
``cli.extract_gif`` writes (``Block{i}/{idx}.gif``, presentation order, the
order of the table) with the port's ``load_gif`` and scores them with the
batched Horn-Schunck estimator of ``data.optical_flow`` on ``--device``
(default ``cuda``).

Scores are mean flow magnitude in pixels per frame step at GIF resolution;
their scale differs from the shipped table's unpublished estimator, so
re-anchor ``cli.add_noise --threshold`` when feeding them in.
"""

import argparse
import os

import numpy as np

from ..data import meta
from ..data.io import save_array
from ..data.optical_flow import score_clips
from ..data.video import load_gif
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gif_dir", default="./data/Video_gifs",
                   help="directory with Block{i}/ GIF subdirectories")
    p.add_argument("--out", default="./data/meta_info/All_video_optical_flow_score.npy")
    p.add_argument("--blocks", type=int, default=meta.N_BLOCKS)
    p.add_argument("--alpha", type=float, default=1.0, help="Horn-Schunck smoothness weight")
    p.add_argument("--iters", type=int, default=100, help="iterations per pyramid level")
    p.add_argument("--levels", type=int, default=3, help="pyramid levels")
    p.add_argument("--chunk", type=int, default=25, help="clips per device batch")
    p.add_argument("--device", default="cuda",
                   help="the card by default (fails where there is none); 'cpu' for a dry run")
    return p


def block_frames(block_dir):
    """A block's GIFs as one (clips, frames, H, W, 3) uint8 array, in index
    order. Duplicate consecutive frames collapse when a GIF is written, so a
    clip that reads shorter gets its last frame repeated up to the longest
    (a collapsed duplicate is zero motion, and its pairs score 0)."""
    names = sorted((f for f in os.listdir(block_dir) if f.endswith(".gif")),
                   key=lambda f: int(os.path.splitext(f)[0]))
    expected = meta.N_CONCEPTS * meta.N_REPS
    if len(names) != expected:
        log.warning("%s has %d clips (expected %d)", block_dir, len(names), expected)
    clips = [load_gif(os.path.join(block_dir, f)) for f in names]
    n_frames = max(c.shape[0] for c in clips)
    clips = [np.concatenate([c] + [c[-1:]] * (n_frames - c.shape[0]))
             if c.shape[0] < n_frames else c for c in clips]
    return np.stack(clips)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    all_scores = []
    for b in range(args.blocks):
        frames = block_frames(os.path.join(args.gif_dir, f"Block{b}"))
        n = len(frames)
        if frames.shape[1] == 1:  # every clip fully static
            scores = np.zeros(n, np.float32)
        else:
            scores = score_clips(frames, alpha=args.alpha, n_iter=args.iters, levels=args.levels,
                                 chunk=min(args.chunk, n), device=device)
        all_scores.append(scores)
        log.info("Block%d: %d clips, score mean %.3f min %.3f max %.3f",
                 b, n, scores.mean(), scores.min(), scores.max())
    table = np.stack(all_scores).astype(np.float32)
    save_array(args.out, table)
    log.info("flow scores %s -> %s", table.shape, args.out)
    return table


if __name__ == "__main__":
    main()
