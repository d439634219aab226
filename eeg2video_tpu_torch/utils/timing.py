"""Timing and metric accumulation (the reference's EEG-VP/EEG_VP_train_test.py
:59-86 ``Accumulator`` / ``Timer``), and a profiler trace region.

Counterpart of ``eeg2video_tpu/utils/timing.py`` (:10-60); the trace region
is ``torch.profiler``'s, written as a Chrome trace (``utils.profiling``)."""

from __future__ import annotations

import time

from .profiling import trace


class Accumulator:
    """Accumulate sums over n variables."""

    def __init__(self, n: int):
        self.data = [0.0] * n

    def add(self, *args):
        self.data = [a + float(b) for a, b in zip(self.data, args)]

    def reset(self):
        self.data = [0.0] * len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]


class Timer:
    """Record multiple running times on the host clock (the caller
    synchronizes the card where device work must be inside a time)."""

    def __init__(self):
        self.times = []
        self.start()

    def start(self):
        self.tik = time.time()

    def stop(self):
        self.times.append(time.time() - self.tik)
        return self.times[-1]

    def sum(self):
        return sum(self.times)

    def avg(self):
        return sum(self.times) / len(self.times) if self.times else 0.0


# JAX's name for the trace region (its utils/timing.py:47): a Chrome trace
# into ``logdir``, nothing at all with None
profile_trace = trace
