"""What the per-name readers in ``benchmark/metrics/`` share.

A reader of an end-to-end metric reads the run's driver (its records of the
window); a reader of a per-layer metric reads the traced window
(``trace.Context``). A reader that finds nothing to read returns None, and
the harness leaves the metric out of the line.
"""

from __future__ import annotations

import numpy as np

import roofline


def mean_ms(drv) -> float:
    """The window's time over its calls or requests, ms: one client's calls
    back to back, so every request and every gap between them counts."""
    return drv.window_s / len(drv.records) * 1e3


def p95_ms(ctx):
    """95th percentile of every call's or request's time in the traced
    window; None when it holds none."""
    if not len(ctx.latency_ms):
        return None
    return float(np.percentile(ctx.latency_ms, 95))


def roofline_pct(ctx, work_key: str, kernel: str):
    """% of its roofline that a kernel reaches over the traced calls: the
    least time of their work (``roofline.py``, under ``work_key``) over the
    device time of every kernel whose name contains ``kernel``; None when
    the trace has no such kernel."""
    seconds = ctx.kernel_seconds(kernel)
    work = ctx.work.get(work_key)
    if not seconds or not work or not ctx.peaks:
        return None
    return 100.0 * roofline.least_seconds(work, ctx.peaks) / seconds


def idle_pct(ctx):
    """% of the traced window in which no kernel, copy or memset ran on the
    card (the profiler's device activity, merged)."""
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
