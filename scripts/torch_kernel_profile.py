#!/usr/bin/env python3
"""Profile the window search and the fused CBR decode kernels on one CUDA card.

Run from the repository root: ``python3 scripts/torch_kernel_profile.py``.
For each kernel at a main-path shape (search: a stereo signal of ``--chunks``
chunks of 5,120 frames at sfb 4 / sff 20 / rs 3, CBR form, and one chunk in
the ranks-only and per-window forms; decode: [chunks, 5120, 2] and one chunk)
it prints

- what ``torch.profiler`` records of the launch: device time, grid, block,
  registers per thread, shared memory, the profiler's occupancy estimate;
- the time by CUDA events, and from it cycles per window (search) or per
  frame (decode) at the card's highest SM clock;
- the kernel's SASS instruction count (``cuobjdump -sass`` of the built
  library), written in full under ``--out`` (default ``build/kernel_profile``)
  for reading the inner loop.

Prints the card's name and power limit with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, label, out_dir):
    """Run ``fn`` once under torch.profiler; the launch records of its CUDA
    kernels as dictionaries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(out_dir, f"trace_{label}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows = []
    for e in events:
        if e.get("cat") == "kernel":
            a = e.get("args", {})
            rows.append({
                "kernel": e["name"][:60], "device_us": e.get("dur"), "grid": a.get("grid"),
                "block": a.get("block"), "registers_per_thread": a.get("registers per thread"),
                "shared_memory": a.get("shared memory"),
                "occupancy_pct": a.get("est. achieved occupancy %"),
                "blocks_per_sm": a.get("blocks per SM"), "warps_per_sm": a.get("warps per SM"),
            })
    os.remove(path)
    return rows


def sass_counts(out_dir):
    """SASS instruction count of each kernel in the two built libraries."""
    from sea_codec_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    counts = {}
    for name in ("window_search", "fused_decode_cbr"):
        lib = cuda_build._lib_path(name)
        try:
            sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout
        except (OSError, subprocess.SubprocessError) as e:
            counts[name] = f"cuobjdump failed: {e}"
            continue
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
            f.write(sass)
        fn, per = None, {}
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                per[fn] = 0
            elif fn and re.match(r"\s*/\*[0-9a-f]{4,5}\*/\s+\S", line):
                per[fn] += 1
        counts[name] = per
    return counts


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=310, help="chunks of 5,120 stereo frames")
    ap.add_argument("--label", default="profile", help="subdirectory of --out for this run")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "kernel_profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import music_signal
    from sea_codec_torch.ops import cuda_build, lms
    from sea_codec_torch.ops.fused_decode import decode_cbr_fused
    from sea_codec_torch.ops.window_search import window_search

    out_dir = os.path.join(args.out, args.label)
    os.makedirs(out_dir, exist_ok=True)
    cuda_build.build_all(("window_search", "fused_decode_cbr"))
    card = smi("name,power.limit")
    clock = float(smi("clocks.max.sm"))
    print(f"card: {card} W; clocks.max.sm {clock} MHz; torch {torch.__version__}")

    nc, f, c, sff = args.chunks, 5120, 2, 20
    wpc = f // sff
    x = torch.from_numpy(music_signal(nc * f, seed=2024).reshape(nc * f, c)).cuda()
    init = (lms.initial_history(c, "cuda"), lms.initial_weights(c, "cuda"),
            torch.zeros(c, dtype=torch.int32, device="cuda"))
    rng = np.random.default_rng(3)
    rs_w = torch.from_numpy(rng.integers(1, 5, (wpc, c)).astype(np.uint8)).cuda()
    forms = {
        "search_cbr_file": (lambda: window_search(x, None, *init, sfb=4, rs=3, sff=sff, wpc=wpc), nc * wpc, 1),
        "search_ranks_only_chunk": (
            lambda: window_search(x[:f], None, *init, sfb=4, rs=3, sff=sff, wpc=wpc, ranks_only=True), wpc, 20),
        "search_per_window_chunk": (
            lambda: window_search(x[:f], None, *init, sfb=4, rs=rs_w, sff=sff, wpc=wpc), wpc, 20),
    }
    for label, (fn, windows, reps) in forms.items():
        ms = event_ms(fn, reps)
        cyc = ms * 1e-3 * clock * 1e6 / windows
        print(f"{label}: {ms:.4f} ms by events, {windows} windows in order per channel, "
              f"{cyc:.0f} cycles per window of {sff} frames ({cyc / sff:.0f} per sample step); card {card} W")
        for row in profiled(fn, label, out_dir):
            print(f"  profiler: {row}")

    n = 1550
    res = torch.from_numpy(rng.integers(0, 256, (n, f * c * 3 // 8), dtype=np.uint8)).cuda()
    sf = torch.from_numpy(rng.integers(0, 16, (n, wpc, c), dtype=np.uint8)).cuda()
    hist = torch.from_numpy(rng.integers(-3000, 3000, (n, c, 4)).astype(np.int32)).cuda()
    wts = torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, (n, c, 4)).astype(np.int32)).cuda()
    for label, k in (("decode_cbr_1550_chunks", n), ("decode_cbr_one_chunk", 1)):
        fn = lambda k=k: decode_cbr_fused(res[:k], sf[:k], hist[:k], wts[:k], sfb=4, rs=3, sff=sff, frames=f)
        ms = event_ms(fn, 20)
        cyc = ms * 1e-3 * clock * 1e6 / f
        print(f"{label}: {ms:.4f} ms by events, {cyc:.0f} cycles per frame of one stream; card {card} W")
        for row in profiled(fn, label, out_dir):
            print(f"  profiler: {row}")
    print("SASS instructions per kernel:", json.dumps(sass_counts(out_dir), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
