"""What the harness hands a traffic driver, and what the driver hands back."""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional

import torch


@dataclasses.dataclass
class Context:
    root: str
    cell: dict          # the cell's entry in BENCHMARK.json
    workload: dict      # perfbench/workloads/<cell>.json
    config: dict        # the configuration's file
    seed: int
    seconds: float
    trace: bool
    device: str
    scratch: str        # a directory under TMPDIR, removed after the run
    started: float      # time.time() when the process began

    @property
    def params(self):
        return self.workload["params"]

    def log(self, msg):
        print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """A driver's result: end-to-end values, counts, the check's numbers
    [(name, value, limit)], and for per-layer readers the trace and the
    driver's counters."""
    e2e: dict
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    counters: dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None
    config: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)
    detail: dict = dataclasses.field(default_factory=dict)  # the check's other readings


def dataclass_of(cls, d):
    """A config dataclass of the program from a configuration group: the
    fields it has, lists as tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device):
    if is_cuda(device):
        torch.cuda.synchronize()


def reset_peak(device):
    """The peak so far, in bytes, then a fresh peak from here."""
    if not is_cuda(device):
        return 0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak


def peak(device):
    return torch.cuda.max_memory_allocated() if is_cuda(device) else 0


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| in float64 (0 when both are 0)."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def free_device_memory():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
