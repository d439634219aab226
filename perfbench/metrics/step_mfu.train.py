"""Model FLOPs of a fine-tune step (forward, the backward for the
activations, the trainable mask's weight gradients; no recomputation:
``count/work.train_step_flops``) over (step time x the card's dense bf16
peak), in %, the step time from the untraced window of the ``--trace 1``
run."""

from perfbench.count import work
from perfbench.harness.readers import train_flops_per_step

LAYER = "trainer"
MOVES = "step_s"


def read(run):
    c = run.counters
    if not c.get("window_steps"):
        return None
    step_s = c["window_s"] / c["window_steps"]
    return 100.0 * train_flops_per_step(run) / step_s / work.PEAK_FLOPS
