"""Spatial attention's share of its roofline in serving, in %: the least
time of the sparse-causal and cross attention calls of the UNet forwards in
the traced window (``count/work.attention_calls`` at the served batch),
over the device time of the kernels whose names match PATTERNS: the port's
flash kernels and the names PyTorch's own attention kernels carry, so that a
route elsewhere is counted against the same work. Temporal attention, which
serving runs as library GEMMs, is in neither."""

from perfbench.harness.readers import latent_shape, roofline, work

LAYER = "kernels"
MOVES = "clips_per_s"
PATTERNS = ("flash_fwd_", "flash_bwd_", "flash", "fmha", "sdpa", "attention")


def read(run):
    if run.trace is None:
        return None
    b, f, h, w = latent_shape(run)
    per_forward = work.least_seconds(work.attention_calls(run.config["unet"], b, f, h, w))
    return roofline(run, run.trace.count("perfbench.unet") * per_forward, PATTERNS)
