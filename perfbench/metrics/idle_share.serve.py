"""Share of the measured serving window in which no kernel ran on the card,
in %: the traced dispatches' busy time per dispatch against the untraced
window's time per dispatch (``harness/readers.idle_share``)."""

from perfbench.harness.readers import idle_share

LAYER = "device"
MOVES = "clips_per_s"


def read(run):
    return idle_share(run, "window_dispatches", run.counters.get("traced_dispatches"))
