"""Device ms per UNet forward at the served batch (the guidance pair of
every clip of a dispatch): kernels launched under ``perfbench.unet``, the
span around ``pipe.unet``'s forward, over the forwards in the traced
window."""

from perfbench.harness.readers import ms_per

LAYER = "pipeline / UNet"
MOVES = "clips_per_s"


def read(run):
    return ms_per(run, "perfbench.unet")
