"""Share of the measured training window in which no kernel ran on the
card, in %: the traced steps' busy time per step against the untraced
window's step time (``harness/readers.idle_share``)."""

from perfbench.harness.readers import idle_share

LAYER = "device"
MOVES = "step_s"


def read(run):
    return idle_share(run, "window_steps", run.counters.get("traced_steps"))
