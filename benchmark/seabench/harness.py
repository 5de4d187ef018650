"""One run of one cell: set-up, the measured window, the check, the result."""

from __future__ import annotations

import gc
import resource
import sys
import time
import traceback

import numpy as np
import torch

import roofline

from . import spec, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "sea_codec_tpu")
TRACE_SECONDS = 10.0  # the traced run profiles this much of its window (the call in flight completes)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_program(device) -> tuple:
    """The port, with its kernels and host library loaded from the build
    cache (built there by the first run of a checkout); returns the
    package and the seconds it took."""
    t0 = time.perf_counter()
    import sea_codec_torch
    import sea_codec_torch.batch  # noqa: F401  (the entries the drivers call)

    if torch.device(device).type == "cuda":
        from sea_codec_torch import native
        from sea_codec_torch.ops import cuda_build

        cuda_build.build_all()
        for name in cuda_build.KERNEL_SOURCES:
            cuda_build.load(name)
        native.available()
    return sea_codec_torch, time.perf_counter() - t0


def make_mesh(chips: int, device):
    """None on one card; else the program's mesh over ``chips`` cards (on
    the CPU, ``chips`` entries of the one device)."""
    if chips <= 1:
        return None
    from sea_codec_torch.parallel.pipeline import make_mesh as program_mesh

    cuda = torch.device(device).type == "cuda"
    return program_mesh(chips, devices=None if cuda else [torch.device(device)] * chips)


def device_info(device, count: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i)) for i in range(count))}


def host_probe() -> str:
    """A fixed piece of host work, timed: a Python loop (the interpreter's
    speed), 256 MiB written into fresh pages (page faults, as the program's
    new arrays and ``bytes`` take them) and 256 MiB copied between touched
    arrays (memory bandwidth). Beside each window in the log, it tells a
    run on a slow or busy host from a slow program."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i
    t1 = time.perf_counter()
    a = np.ones(1 << 28, np.uint8)
    t2 = time.perf_counter()
    b = np.empty_like(a)
    b[:] = 0
    t3 = time.perf_counter()
    b[:] = a
    t4 = time.perf_counter()
    return f"loop {(t1 - t0) * 1e3:.1f} ms, fresh pages {(t2 - t1) * 1e3:.1f} ms, copy {(t4 - t3) * 1e3:.1f} ms"


class HostLoad:
    """This process's CPU seconds over a window, and ``host_probe`` before
    and after it, for the run's log."""

    def __enter__(self):
        self._probe = host_probe()
        self._ru, self._t = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
        return self

    def __exit__(self, *exc):
        ru, wall = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter() - self._t
        a = self._ru
        self.note = (f"host over {wall:.3f} s: process user {ru.ru_utime - a.ru_utime:.3f} s "
                     f"sys {ru.ru_stime - a.ru_stime:.3f} s; probe before: {self._probe}; after: {host_probe()}")


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             control: bool = False, log=print) -> dict:
    """Run ``cell`` once; returns the result line's object. ``t_start`` is
    the process's start on the ``perf_counter`` clock; ``control`` replaces
    the answers the check reads with the reference's float32 ones. The
    traced run profiles the first ``TRACE_SECONDS`` of its window."""
    port, load_s = load_program(device)
    driver = spec.entry_driver(cell.traffic["entry"])
    t0 = time.perf_counter()
    tr = traffic.make(cell.config, cell.traffic, seed, device, driver.inputs)
    gen_s = time.perf_counter() - t0
    drv = driver(port, tr, device, seed, mesh=make_mesh(cell.chips, device))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for i in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    drv.warm()
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: program and kernels {load_s:.3f} s, traffic {gen_s:.3f} s, "
        f"warm-up {warm_s:.3f} s", file=sys.stderr)

    ctx = None
    with HostLoad() as host:
        if traced:
            tracer = trace.Tracer(cuda)
            port.batch.PIPELINE_TIMES = tracer.spans
            with tracer:
                drv.run_window(min(seconds, TRACE_SECONDS), traced=True)
            port.batch.PIPELINE_TIMES = None
        else:
            drv.run_window(seconds)
    if traced:
        ctx = tracer.context()
    dev_info = device_info(device, cell.chips)
    log(f"window {drv.window_s:.3f} s: {drv.timing_note()}", file=sys.stderr)
    log(host.note, file=sys.stderr)

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        checks, attempted, failed = drv.check(control=control)
    except Exception:  # a malformed answer the reference cannot read: not correct
        traceback.print_exc()
        checks, attempted, failed = {"check_raised": (1, 0)}, len(drv.records), 0
    check_s = time.perf_counter() - t0
    correct = all(limit is None or value <= limit for value, limit in checks.values())

    metrics = {}
    if traced:
        ctx.calls = len(drv.records)
        ctx.latency_ms = list(drv.latency_ms())
        ctx.work = drv.work(drv.records)
        if cuda:
            ctx.peaks = roofline.peaks(torch.cuda.get_device_properties(0).multi_processor_count,
                                       roofline.max_sm_clock_mhz())
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else spec.metric_reader(m["name"])(drv)
            if value is None:
                raise RuntimeError(f"{cell.name} reports {m['name']}, and its reader found nothing to read")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log(f"check took {check_s:.3f} s", file=sys.stderr)
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev_info}
    if traced:
        out["breakdown"] = trace.breakdown(ctx)
    out["checks"] = {name: {"value": value, "limit": limit} for name, (value, limit) in checks.items()}
    return out
