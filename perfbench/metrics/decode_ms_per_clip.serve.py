"""Device ms of the VAE decode per clip: kernels launched under
``perfbench.decode`` (one span a frame) over the clips decoded in the
traced window (spans over the frames a clip has)."""

from perfbench.harness.readers import ms_per

LAYER = "decode and encode"
MOVES = "clips_per_s"


def read(run):
    t = run.trace
    if t is None:
        return None
    clips = t.count("perfbench.decode") / run.counters["frames"]
    return ms_per(run, "perfbench.decode", per=clips) if clips else None
