"""Model FLOPs of the clips the measured window served, over its time and
the card's dense bf16 peak, in %: a clip is ``steps`` UNet forwards on its
guidance pair and the decode of its frames (``count/work.clip_flops``). Read
from the untraced window of the ``--trace 1`` run, so the profiler's cost
is not in it."""

from perfbench.count import work

LAYER = "pipeline / UNet"
MOVES = "clips_per_s"


def read(run):
    c = run.counters
    if not c.get("window_clips"):
        return None
    cfg = run.config
    flops = work.clip_flops(cfg["unet"], cfg["vae"], c["steps"], c["frames"], c["height"],
                            c["width"])
    return 100.0 * c["window_clips"] * flops / c["window_s"] / work.PEAK_FLOPS
