"""The traced run: the profiler over the measured window, the program's
stage spans, and what the per-layer readers read from them.

``torch.profiler`` records host operations and device activity (kernels,
copies, memsets) over the window; the events are read from its results in
memory, and no trace file is written. The program's corpus stages come from
``batch.PIPELINE_TIMES``, its documented hook: ``Spans`` is the program's
``StageTimes`` that also keeps when each stage ended, so that an idle gap
on the device can be named by what the host was doing.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from sea_codec_torch.utils.profiling import StageTimes

WINDOW_RANGE = "bench.window"
TOP = 10


class Spans(StageTimes):
    """The program's stage seconds (``*_bytes``: bytes), and each stage's
    interval on the ``perf_counter_ns`` clock."""

    def __init__(self):
        super().__init__()
        self.intervals: list[tuple[str, int, int]] = []

    def add(self, name: str, seconds: float) -> None:
        super().add(name, seconds)
        if not name.endswith("_bytes"):
            end = time.perf_counter_ns()
            self.intervals.append((name, end - int(seconds * 1e9), end))


def _is_annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else int(getattr(e, f"{what}_us")() * 1000)


@dataclass
class Context:
    """What a per-layer reader reads: the traced window's device time by
    kernel, its busy and window seconds, the program's stage seconds, the
    calls or requests completed in it, and the work they carried."""

    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: dict = field(default_factory=dict)  # name -> seconds
    idle_gaps: list = field(default_factory=list)  # (host activity, seconds), longest first
    stages: dict = field(default_factory=dict)  # PIPELINE_TIMES
    calls: int = 0
    latency_ms: list = field(default_factory=list)  # each traced call's or request's time on the host clock
    work: dict = field(default_factory=dict)  # roofline counts of the calls, see roofline.py
    peaks: dict = field(default_factory=dict)

    def kernel_seconds(self, name: str) -> float:
        """Device seconds of every kernel whose name contains ``name``."""
        return sum(s for op, s in self.device_ops.items() if name in op)

    def per_call_ms(self, stage: str):
        if stage not in self.stages or not self.calls:
            return None
        return self.stages[stage] / self.calls * 1e3


class Tracer:
    """Profiles the block it wraps; ``context()`` reads the result."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile

        self.spans = Spans()
        self.cuda = cuda
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=activities)
        self._range = None

    def __enter__(self):
        self._prof.__enter__()
        self._anchor = time.perf_counter_ns()
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)

    def context(self) -> Context:
        events = self._prof.profiler.kineto_results.events()
        host, dev = [], []
        win = None
        for e in events:
            name = e.name()
            start = _ns(e, "start")
            rec = (name, start, start + _ns(e, "duration"))
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a host range is mirrored on the device's timeline as an annotation, not work
                if not _is_annotation(e) and name != WINDOW_RANGE:
                    dev.append(rec)
            elif name == WINDOW_RANGE:
                win = rec
            else:
                host.append(rec)
        if win is None:
            raise RuntimeError("the profiler recorded no window range")
        lo, hi = win[1], win[2]
        offset = lo - self._anchor
        host += [(n, a + offset, b + offset) for n, a, b in self.spans.intervals]
        ops: dict[str, float] = defaultdict(float)
        busy = []
        for name, a, b in dev:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                ops[name] += (b - a) / 1e9
                busy.append((a, b))
        merged = []
        for a, b in sorted(busy):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_ns = sum(b - a for a, b in merged)
        gaps, t = [], lo
        for a, b in merged + [[hi, hi]]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [(self._doing(host, (a + b) // 2), (b - a) / 1e9) for a, b in gaps[:TOP]]
        return Context(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9, device_ops=dict(ops),
                       idle_gaps=named, stages=dict(self.spans))

    @staticmethod
    def _doing(host, t) -> str:
        """The innermost host ranges open at ``t``: a program stage or the
        benchmark's call range, and the innermost host operation."""
        open_ = [(b - a, n) for n, a, b in host if a <= t < b]
        if not open_:
            return "host (no range open)"
        open_.sort()
        ops = [n for _d, n in open_ if n.startswith("aten::") or n.startswith("cuda")]
        ranges = [n for _d, n in open_ if not (n.startswith("aten::") or n.startswith("cuda"))]
        parts = ranges[:1] + ops[:1]
        return " / ".join(parts) if parts else open_[0][1]


def breakdown(ctx: Context) -> dict:
    top = sorted(ctx.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in ctx.idle_gaps]}
