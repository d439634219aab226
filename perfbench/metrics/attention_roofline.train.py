"""Attention's share of its roofline in the fine-tune step, in %: the least
time of the traced steps' spatial (sparse-causal, cross) and temporal
attention, forward and backward (the backward's four GEMMs, twice the
forward's FLOPs; no recomputation), from ``count/work.attention_calls``,
over the device time of the kernels whose names match PATTERNS: the port's
flash and temporal kernels and the names PyTorch's own attention kernels
carry."""

from perfbench.harness.readers import latent_shape, roofline, work

LAYER = "kernels"
MOVES = "step_s"
PATTERNS = ("flash_fwd_", "flash_bwd_", "temporal_", "flash", "fmha", "sdpa", "attention")


def read(run):
    steps = run.counters.get("traced_steps")
    if run.trace is None or not steps:
        return None
    b, f, h, w = latent_shape(run)
    calls = work.attention_calls(run.config["unet"], b, f, h, w, train=True, temporal=True)
    return roofline(run, steps * work.least_seconds(calls), PATTERNS)
