"""Arithmetic that the per-layer metric readers share. Each reader in
``perfbench/metrics`` holds its own layer, end-to-end metric, name patterns
and counts; a reader that finds nothing to read returns None."""

from __future__ import annotations

from perfbench.count import work
from perfbench.harness.trace import OTHER_GROUP, group_of, matches


def latent_shape(run):
    """(batch, frames, h, w) of the UNet calls a cell makes."""
    c = run.counters
    return c["unet_batch"], c["frames"], c["height"] // 8, c["width"] // 8


def ms_per(run, span, per=None):
    """Device ms of the kernels launched under ``span``, per span (or per
    ``per`` units)."""
    t = run.trace
    if t is None:
        return None
    n = t.count(span) if per is None else per
    kernels = t.under(span)
    if not n or not kernels:
        return None
    return 1e3 * t.device_s(kernels) / n


def roofline(run, least_s, patterns):
    """100 x ``least_s`` over the device time of the window's kernels whose
    names match ``patterns``."""
    t = run.trace
    if t is None or not least_s:
        return None
    kernels = [k for k in t.in_window() if matches(k[2], patterns)]
    if not kernels:
        return None
    return 100.0 * least_s / t.device_s(kernels)


def idle_share(run, units, traced_units):
    """100 x the share of the untraced window with no kernel running: one
    minus the card's busy time per unit (step, dispatch) in the traced
    window over the untraced window's time per unit. The profiler slows the
    host, and with it a launch-bound step (1.7x for the EEG2Video step), so
    the traced window's own idle share would read the profiler's cost."""
    t, c = run.trace, run.counters
    if t is None or not c.get(units) or not traced_units:
        return None
    return 100.0 * (1.0 - (t.busy_s() / traced_units) / (c["window_s"] / c[units]))


def group_ms_per(run, group, units):
    t = run.trace
    if t is None or not units:
        return None
    ms = sum(k[1] - k[0] for k in t.in_window() if group_of(k[2]) == group) / 1e3
    return ms / units if ms else None


def train_flops_per_step(run):
    b, f, h, w = latent_shape(run)
    return work.train_step_flops(run.config["unet"], b, f, h, w)


__all__ = ["OTHER_GROUP", "group_ms_per", "idle_share", "latent_shape", "ms_per", "roofline",
           "train_flops_per_step", "work"]
