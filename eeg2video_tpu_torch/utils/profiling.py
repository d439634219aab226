"""Profiling on ``torch.profiler``: traces, their parsing, and the grouping of
device time by the port's kernels.

Counterpart of ``eeg2video_tpu/utils/profiling.py`` (:33-143). ``trace``
records a region and writes it as a Chrome trace into a directory;
``load_trace`` reads the newest one back as op events (the device's kernels
and copies when the trace has any, the host's ops otherwise); ``bucket_of``
names the group of an op and ``summarize`` prints the per-iteration time by
group and the top ops; ``profile_fn`` does all four for one function.

``_KERNEL_GROUPS`` is the one grouping of the port's device kernels by what
launched them: ``device_time_by_group`` applies it to a profile's events,
for ``chip_smoke.py`` and any timing harness, so every report uses the
same group names.

Typical use::

    from eeg2video_tpu_torch.utils import profiling
    with profiling.trace("/tmp/my_trace"):
        for _ in range(3):
            out = step_fn(...)
    events = profiling.load_trace("/tmp/my_trace")
    print(profiling.summarize(events, n_iters=3))
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import time
from dataclasses import dataclass
from typing import List

# device kernels of a train step or a generation forward, grouped by what
# launched them (substrings of the kernel names; the port's own kernels first)
_KERNEL_GROUPS = (
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
# the Chrome-trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_time_by_group(events):
    """Device time of a ``torch.profiler.profile``'s ``events()`` by group.
    Returns ``(ms by group, number of kernels and copies, first start, last
    end)``, the times in microseconds of the profiler's clock; no groups when
    the profiler recorded no device activity."""
    from torch.autograd import DeviceType

    groups, n, first, last = {}, 0, float("inf"), 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        first, last = min(first, e.time_range.start), max(last, e.time_range.end)
        group = bucket_of(e.name)
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
        n += 1
    return groups, n, first, last


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the block with ``torch.profiler`` (the host's ops, and the
    card's kernels where there is one) and write its Chrome trace into
    ``logdir``. Yields the profile; with ``logdir`` None, records nothing and
    yields None."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


@dataclass
class OpEvent:
    name: str
    dur_us: float
    long_name: str = ""


def load_trace(logdir: str, device_only: bool = True) -> List[OpEvent]:
    """The newest ``*.json`` Chrome trace under ``logdir`` -> op events. Where
    the trace holds device work, its kernels and copies (with
    ``device_only=False`` the host's ops too); else the host's ops
    (``cpu_op``). ``long_name`` is the op's category."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {logdir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    host = [e for e in events if e.get("cat") == "cpu_op"]
    keep = (device if device_only else device + host) if device else host
    return [OpEvent(e.get("name", ""), float(e.get("dur", 0.0)), e.get("cat", ""))
            for e in keep]


def bucket_of(name: str, long_name: str = "") -> str:
    """The group of a device kernel or copy by its name (``_KERNEL_GROUPS``,
    then copies, then everything else); a host op (``long_name`` "cpu_op", as
    ``load_trace`` gives it) is its own bucket."""
    if long_name == "cpu_op":
        return name
    lower = name.lower()
    if lower.startswith("memcpy") or lower.startswith("memset"):
        return COPY_GROUP
    return next((g for g, keys in _KERNEL_GROUPS if any(k in lower for k in keys)),
                OTHER_GROUP)


def summarize(events: List[OpEvent], n_iters: int = 1, top: int = 15) -> str:
    """Human-readable per-iteration attribution: bucket totals + top ops."""
    total = sum(e.dur_us for e in events)
    buckets = collections.Counter()
    per_op = collections.defaultdict(float)
    for e in events:
        buckets[bucket_of(e.name, e.long_name)] += e.dur_us
        per_op[e.name] += e.dur_us
    lines = [f"total {total / n_iters / 1e3:.2f} ms/iter "
             f"({len(events)} op events / {n_iters} iters)"]
    for k, v in buckets.most_common():
        lines.append(f"  {v / n_iters / 1e3:8.2f} ms  {k}")
    lines.append("top ops:")
    for name, d in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        short = re.sub(r"\s+", " ", name)[:90]  # kernel names carry template lists
        lines.append(f"  {d / n_iters / 1e3:8.3f} ms  {short}")
    return "\n".join(lines)


def profile_fn(fn, *args, logdir: str, iters: int = 3, warmup: bool = True) -> str:
    """Warm ``fn`` up, trace ``iters`` calls, return the summary."""
    if warmup:
        fn(*args)
    with trace(logdir):
        for _ in range(iters):
            fn(*args)
    return summarize(load_trace(logdir), n_iters=iters)

