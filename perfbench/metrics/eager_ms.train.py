"""Device ms per traced step of the kernels no group of the port or the
libraries claims: PyTorch's own elementwise, reduction and other kernels
(``harness/trace.OTHER_GROUP``)."""

from perfbench.harness.readers import OTHER_GROUP, group_ms_per

LAYER = "pipeline / UNet (in training)"
MOVES = "step_s"


def read(run):
    return group_ms_per(run, OTHER_GROUP, run.counters.get("traced_steps"))
