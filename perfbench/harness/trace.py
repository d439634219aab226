"""The traced window: ``torch.profiler`` over a steady stretch of whole
dispatches or steps, its Chrome trace read back into kernels and spans.

``Tracer.start`` opens the profiler and the ``perfbench.window`` span;
``stop`` synchronizes the card, closes both, writes the trace under a
scratch directory and parses it into a ``Trace``:

- ``kernels``: device kernels, copies and sets, (start, end, name, launch
  time, launching thread) in microseconds of the profiler's clock; the launch
  comes from the runtime call with the same correlation id;
- ``spans``: the host's ``record_function`` ranges by name;
- ``window``: the ``perfbench.window`` span.

A kernel lies under a span when its launch falls inside the span on the same
thread. ``GROUPS`` names device kernels by what launched them: the port's
kernel name patterns first, then the libraries'; it is the benchmark's copy
of the grouping in the program's ``utils/profiling.py``.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from collections import defaultdict

import torch

WINDOW = "perfbench.window"

GROUPS = (
    ("flash_attention_bwd_f32", ("flash_f32_dq_", "flash_f32_dkv_", "flash_f32_dbias_")),
    ("flash_attention_fwd_f32", ("flash_f32_fwd_",)),
    ("ff_ln_bwd_f32", ("ff_f32_bwd_",)), ("ff_ln_f32", ("ff_f32_",)),
    ("geglu_out_bwd_f32", ("geglu_f32_bwd_",)), ("geglu_out_f32", ("geglu_f32_",)),
    ("flash_attention_bwd", ("flash_bwd_",)), ("flash_attention_fwd", ("flash_fwd_",)),
    ("temporal_attention_fwd", ("temporal_fwd_",)), ("temporal_attention_bwd", ("temporal_bwd_",)),
    ("ff_ln_bwd", ("ff_ln_bwd_",)), ("ff_ln", ("ff_ln_",)),
    ("geglu_out_bwd", ("geglu_out_bwd_",)), ("geglu_out", ("geglu_out_",)),
    ("conv3x3_gn_silu", ("conv3x3_",)), ("int8_dense", ("int8_dense_",)),
    ("sos_filtfilt", ("sos_filtfilt_",)),
    ("library conv / GEMM", ("cudnn", "cutlass", "gemm", "nvjet", "xmma", "wgrad", "dgrad",
                             "conv", "cublas", "gemv")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
)
COPY_GROUP = "memcpy / memset"
OTHER_GROUP = "PyTorch elementwise / reduce / other"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def group_of(name: str) -> str:
    lower = name.lower()
    if lower.startswith("memcpy") or lower.startswith("memset"):
        return COPY_GROUP
    return next((g for g, keys in GROUPS if any(k in lower for k in keys)), OTHER_GROUP)


def matches(name: str, patterns) -> bool:
    lower = name.lower()
    return any(p in lower for p in patterns)


class Trace:
    def __init__(self, events):
        launches = {}
        self.kernels, self.spans = [], defaultdict(list)
        ops = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat"), float(e.get("ts", 0.0))
            end = ts + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.kernels.append([ts, end, e.get("name", ""),
                                     (e.get("args") or {}).get("correlation")])
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.spans[e.get("name", "")].append((ts, end, e.get("tid")))
            elif cat == "cpu_op":
                ops[e.get("tid")].append((ts, end, e.get("name", "")))
        for k in self.kernels:
            k[3:4] = launches.get(k[3], (None, None))
        self.kernels.sort()
        if not self.spans.get(WINDOW):
            raise RuntimeError("the trace holds no perfbench.window span")
        w = self.spans[WINDOW][0]
        self.window = (w[0], w[1])
        self._top_ops = {tid: _outermost(v) for tid, v in ops.items()}

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self):
        a, b = self.window
        return [k for k in self.kernels if k[1] > a and k[0] < b]

    def busy_s(self, kernels=None):
        """Seconds in which at least one of ``kernels`` (default: all in the
        window) ran, inside the window."""
        a, b = self.window
        total, cur_s, cur_e = 0.0, None, None
        for s, e, *_ in (self.in_window() if kernels is None else kernels):
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def device_s(self, kernels):
        """Summed kernel seconds (overlaps counted once per kernel)."""
        return sum(k[1] - k[0] for k in kernels) / 1e6

    def under(self, span: str, kernels=None):
        """The kernels launched inside a ``span`` range, on its thread."""
        ranges = defaultdict(list)
        for s, e, tid in self.spans.get(span, ()):
            ranges[tid].append((s, e))
        starts = {tid: [r[0] for r in sorted(v)] for tid, v in ranges.items()}
        ranges = {tid: sorted(v) for tid, v in ranges.items()}
        out = []
        for k in (self.in_window() if kernels is None else kernels):
            t, tid = k[3], k[4]
            if t is None or tid not in ranges:
                continue
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and ranges[tid][i][1] >= t:
                out.append(k)
        return out

    def count(self, span: str) -> int:
        a, b = self.window
        return sum(1 for s, e, _ in self.spans.get(span, ()) if s >= a and e <= b)

    def by_group(self):
        groups = defaultdict(float)
        for k in self.in_window():
            groups[group_of(k[2])] += (k[1] - k[0]) / 1e6
        return dict(groups)

    def host_label(self, t, tid):
        """What the host was doing at ``t``: the innermost span around it and
        the outermost op then running on ``tid``."""
        spans = [(e - s, name) for name, v in self.spans.items() if name != WINDOW
                 for s, e, _ in v if s <= t <= e]
        label = min(spans)[1] if spans else "no span"
        ops = self._top_ops.get(tid)
        if ops:
            i = bisect.bisect_right(ops[0], t) - 1
            if i >= 0 and ops[1][i][1] >= t:
                return f"{label} / {ops[1][i][2]}"
        return f"{label} / host between ops"

    def idle_gaps(self):
        """{label: seconds} of the device's idle time in the window, each gap
        labelled by what the host was doing when it began, on the thread that
        launched the kernel that ended it."""
        a, b = self.window
        gaps, cur = defaultdict(float), a
        for k in self.in_window():
            if k[0] > cur:
                gaps[self.host_label(cur, k[4])] += (k[0] - cur) / 1e6
            cur = max(cur, k[1])
        if b > cur:
            gaps["after the last kernel"] += (b - cur) / 1e6
        return dict(gaps)

    def breakdown(self, top=10):
        ops = sorted(self.by_group().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _outermost(ops):
    """Sorted starts and ops of those not inside another op of the thread."""
    ops.sort(key=lambda o: (o[0], -o[1]))
    keep, end = [], float("-inf")
    for o in ops:
        if o[0] >= end:
            keep.append(o)
            end = o[1]
    return [o[0] for o in keep], keep


class Tracer:
    """One profiled window. ``start`` and ``stop`` may be called from any
    thread, ``stop`` from the one that called ``start``'s span."""

    def __init__(self, scratch, device):
        self.dir = tempfile.mkdtemp(prefix="trace", dir=scratch)
        self.cuda = torch.device(device).type == "cuda"
        self.prof = self.span = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        self.span = torch.autograd.profiler.record_function(WINDOW)
        self.span.__enter__()

    def stop(self):
        self._sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> Trace:
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        shutil.rmtree(self.dir, ignore_errors=True)
        return Trace(events)
