"""Stage timing and device traces.

The reference has only ad-hoc wall-clock prints (``examples/bench.rs:34``,
``web/worker.mjs:166``); here the equivalent surface is:

- ``StageTimes`` and ``stage_timer``: named wall-clock stages collected
  into a dict (the corpus pipelines record into ``batch.PIPELINE_TIMES``
  when a caller installs one), with ``*_bytes`` keys counting transfer
  bytes;
- ``device_trace``: a context manager around ``torch.profiler`` that writes
  a Chrome trace of the host and device activity when ``SEA_PROFILE`` (or
  an explicit path) names an output directory.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


class StageTimes(defaultdict):
    """Seconds per stage name, and bytes per ``*_bytes`` name."""

    def __init__(self):
        super().__init__(float)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        """Thread-safe accumulate (the corpus pipeline's fetch thread
        records into the same StageTimes as the main thread)."""
        with self._lock:
            self[name] += seconds

    def report(self) -> str:
        # keys ending in _bytes are transfer-byte counters, not seconds
        times = {k: v for k, v in self.items() if not k.endswith("_bytes")}
        total = sum(times.values())
        lines = [f"{k:>20}: {v * 1e3:9.2f} ms ({v / total * 100:5.1f}%)" for k, v in times.items()]
        lines.append(f"{'total':>20}: {total * 1e3:9.2f} ms")
        lines += [f"{k:>20}: {v / 1e6:9.1f} MB" for k, v in self.items() if k.endswith("_bytes")]
        return "\n".join(lines)


@contextlib.contextmanager
def stage_timer(times: StageTimes, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace (host and, with a card, CUDA
    activity) into ``log_dir`` or the directory ``SEA_PROFILE`` names; a
    no-op when neither is set."""
    log_dir = log_dir or os.environ.get("SEA_PROFILE")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
