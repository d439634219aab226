"""The feed-forward pair's share of its roofline in the fine-tune step, in
%: the least time of the traced steps' feed-forward calls at the widths the
fused ``ff_ln`` / ``ff_ln_bwd`` pair serves (LayerNorm, GEGLU, the out
projection, forward and the activations' backward; no recomputation), from
``count/work.ff_calls``, over the device time of the kernels whose names
match PATTERNS."""

from perfbench.harness.readers import latent_shape, roofline, work

LAYER = "kernels"
MOVES = "step_s"
PATTERNS = ("ff_ln_",)
WIDTHS = (320, 640)


def read(run):
    steps = run.counters.get("traced_steps")
    if run.trace is None or not steps:
        return None
    b, f, h, w = latent_shape(run)
    calls = work.ff_calls(run.config["unet"], b, f, h, w, WIDTHS, train=True)
    return roofline(run, steps * work.least_seconds(calls), PATTERNS)
