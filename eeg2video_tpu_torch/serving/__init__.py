"""Serving subsystem: warm runtimes, batch dispatch, transports.

Counterpart of ``eeg2video_tpu/serving``: ``runtimes`` (the semantic loader,
request assembly, the knob policy), ``batching`` (single + coalesced
dispatch), ``transport`` (stdin/TCP readers, the shared queue, backpressure,
stats). The CLI entry point and the protocol are in
``eeg2video_tpu_torch.cli.serve``.
"""

from . import batching, runtimes, transport  # noqa: F401
