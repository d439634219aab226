"""CLI: block videos -> per-clip 6-frame 288x512 GIFs (the ``gif`` stage).

Counterpart of ``eeg2video_tpu/cli/extract_gif.py`` (the contract of the
reference's EEG2Video/extract_gif.py): ``{video_dir}/{b+1}.mp4`` ->
``{out_root}/Block{b}/{idx}.gif`` through ``data.video.extract_gifs_from_block``,
which reads with cv2 and writes with the port's native GIF encoder.
"""

import argparse
import os

from ..data.video import extract_gifs_from_block
from ..utils import get_logger

log = get_logger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--video_dir", default="./data/Video")
    p.add_argument("--out_root", default="./data/Video_gifs")
    p.add_argument("--blocks", type=int, nargs="*", default=list(range(7)))
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    written = {}
    for blk in args.blocks:
        src = os.path.join(args.video_dir, f"{blk + 1}.mp4")
        out = os.path.join(args.out_root, f"Block{blk}")
        written[blk] = extract_gifs_from_block(src, out)
        log.info("block %d: %d gifs -> %s", blk, len(written[blk]), out)
    return written


if __name__ == "__main__":
    main()
