"""Device ms of the semantic predictor (the int8 MLP over a request's
features file) per request: kernels launched under the benchmark's
``perfbench.semantic`` span around the ``semantic_predict`` handed to
``serve()``, over the spans in the traced window."""

from perfbench.harness.readers import ms_per

LAYER = "semantic predictor"
MOVES = "clips_per_s"


def read(run):
    return ms_per(run, "perfbench.semantic")
