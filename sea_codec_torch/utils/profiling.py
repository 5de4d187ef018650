"""Stage timing and device traces.

The reference has only ad-hoc wall-clock prints (``examples/bench.rs:34``,
``web/worker.mjs:166``); here the equivalent surface is:

- ``StageTimes`` and ``stage_timer``: named wall-clock stages collected
  into a dict (the corpus pipelines and ``batch.decode_range`` record into
  ``batch.PIPELINE_TIMES`` when a caller installs one), with ``*_bytes``
  keys counting transfer bytes and ``*_count`` keys counting events (kernel
  launches). Each stage is also a ``torch.profiler.record_function`` range,
  so a profiler running around it records the stage on its own clock,
  nested under the caller's ranges and mirrored onto the device timeline.
  Nothing synchronises the card: a stage times the host's part of its work;
  the device's part is in the profiler's device trace;
- ``device_trace``: a context manager around ``torch.profiler`` that writes
  a Chrome trace of the host and device activity, the stages included,
  when ``SEA_PROFILE`` (or an explicit path) names an output directory.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

_COUNTERS = ("_bytes", "_count")


class StageTimes(defaultdict):
    """Seconds per stage name, bytes per ``*_bytes`` name and an integer
    per ``*_count`` name."""

    def __init__(self):
        super().__init__(float)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        """Thread-safe accumulate (the corpus pipeline's fetch thread
        records into the same StageTimes as the main thread)."""
        with self._lock:
            self[name] += seconds

    def count(self, name: str, n: int) -> None:
        """Thread-safe add of ``n`` to the integer counter ``name`` (which
        ends in ``_count``). It does not go through ``add``: a subclass
        that keeps an interval for each ``add`` sees none for a count."""
        if not name.endswith("_count"):
            raise ValueError(f"a counter's name ends in _count, got {name!r}")
        with self._lock:
            self[name] = self.get(name, 0) + int(n)

    def report(self) -> str:
        # keys ending in _bytes and _count are counters, not seconds
        times = {k: v for k, v in self.items() if not k.endswith(_COUNTERS)}
        total = sum(times.values())
        lines = [f"{k:>20}: {v * 1e3:9.2f} ms ({v / total * 100:5.1f}%)" for k, v in times.items()]
        lines.append(f"{'total':>20}: {total * 1e3:9.2f} ms")
        lines += [f"{k:>20}: {v / 1e6:9.1f} MB" for k, v in self.items() if k.endswith("_bytes")]
        lines += [f"{k:>20}: {int(v):9d}" for k, v in self.items() if k.endswith("_count")]
        return "\n".join(lines)


@contextlib.contextmanager
def stage_timer(times: StageTimes, name: str):
    """Time the block into ``times[name]``, inside a profiler range of the
    same name."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            times.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace (host and, with a card, CUDA
    activity) into ``log_dir`` or the directory ``SEA_PROFILE`` names; a
    no-op when neither is set. While it records, ``batch.PIPELINE_TIMES``
    holds a ``StageTimes`` (the caller's, or a new one put back to None
    afterwards), so the trace carries the program's stages."""
    log_dir = log_dir or os.environ.get("SEA_PROFILE")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from .. import batch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    installed = batch.PIPELINE_TIMES
    if installed is None:
        batch.PIPELINE_TIMES = StageTimes()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        batch.PIPELINE_TIMES = installed
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
