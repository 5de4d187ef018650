#!/usr/bin/env python3
"""Profile the window search and the three decode kernels on one CUDA card.

Run from the repository root: ``python3 scripts/torch_kernel_profile.py``.
For each kernel at a main-path shape (search: a stereo signal of ``--chunks``
chunks of 5,120 frames at sfb 4 / sff 20 / rs 3, CBR form, and one chunk in
the ranks-only and per-window forms; the fused CBR and VBR decodes and the
LMS recurrence: [``--decode-chunks``, 5120, 2] and one chunk, the VBR sizes
2 to 4 bits as at a 2.5-bit target) it prints

- what ``torch.profiler`` records of the launch: device time, grid, block,
  registers per thread, shared memory, the profiler's occupancy estimate;
- the time by CUDA events, and from it cycles per window (search) or per
  frame (decode) at the card's highest SM clock;
- the kernel's SASS instruction count (``cuobjdump -sass`` of the built
  library), written in full under ``--out`` (default ``build/kernel_profile``)
  for reading the inner loop.

``--parts`` picks kernels (search, cbr, vbr, lms) and ``session``: the wall
time of ``SeaDecoder`` decoding a 101-chunk stereo VBR file (2.5 bits) a
chunk per call, five times. ``--root`` profiles the
``sea_codec_torch`` of another checkout (an earlier commit unpacked with
``git archive``), so that two versions are timed in one call, in turns;
``--idle-warps on`` (or ``off``) profiles a copy of the package under
``--out`` in which every decode kernel leaves (or does not leave) the
recurrence warp's scheduler to it: its ``kIsolate`` constant set so;
``default`` keeps each kernel's own. Run the script once per setting, in
turns, to compare them.
Prints the card's name and power limit with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
KERNELS = {"search": "window_search", "cbr": "fused_decode_cbr", "vbr": "fused_decode_vbr", "lms": "lms_decode",
           "session": "fused_decode_vbr"}
RING_KERNELS = ("fused_decode_cbr", "fused_decode_vbr", "lms_decode")
ISOLATE = re.compile(r"constexpr bool kIsolate = (true|false);")


def isolated_copy(root, dest, isolate=None):
    """``root``'s sea_codec_torch copied under ``dest``, with every ring
    kernel's ``kIsolate`` set to ``isolate`` (None keeps each one's own);
    returns the root of the copy."""
    pkg = os.path.join(dest, "sea_codec_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(root, "sea_codec_torch"), pkg, ignore=shutil.ignore_patterns("__pycache__"))
    for name in RING_KERNELS if isolate is not None else ():
        path = os.path.join(pkg, "csrc", f"{name}.cu")
        with open(path) as f:
            src = f.read()
        src, hits = ISOLATE.subn(f"constexpr bool kIsolate = {'true' if isolate else 'false'};", src)
        if hits != 1:
            raise SystemExit(f"{path}: no kIsolate constant to set")
        with open(path, "w") as f:
            f.write(src)
    return dest


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


def sass_counts(out_dir, names):
    """SASS instruction count of each kernel in the named built libraries."""
    from sea_codec_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    counts = {}
    for name in names:
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


def decode_forms(parts, n, f, c, sff, rng):
    """(label, fn) pairs timing the decode kernels on random inputs."""
    import torch

    from sea_codec_torch.ops import fused_decode, fused_decode_vbr, lms_decode

    wpc = f // sff
    cuda = lambda a: torch.from_numpy(a).cuda()
    sf = cuda(rng.integers(0, 16, (n, wpc, c), dtype=np.uint8))
    hist = cuda(rng.integers(-3000, 3000, (n, c, 4)).astype(np.int32))
    wts = cuda(rng.integers(-(1 << 14), 1 << 14, (n, c, 4)).astype(np.int32))
    forms = []
    if "cbr" in parts:
        res = cuda(rng.integers(0, 256, (n, f * c * 3 // 8), dtype=np.uint8))
        forms += [(label, lambda k=k: fused_decode.decode_cbr_fused(res[:k], sf[:k], hist[:k], wts[:k], sfb=4, rs=3,
                                                        sff=sff, frames=f))
                  for label, k in (("decode_cbr", n), ("decode_cbr_one_chunk", 1))]
    if "vbr" in parts:
        sizes = rng.choice(np.array([2, 3, 4], np.uint8), (n, wpc, c), p=[0.83, 0.16, 0.01])
        res_v = cuda(rng.integers(0, 256, (n, int(sizes.sum(axis=(1, 2)).max()) * sff // 8 + 1), dtype=np.uint8))
        rs_v = cuda(sizes)
        forms += [(label, lambda k=k: fused_decode_vbr.decode_vbr_fused(res_v[:k], sf[:k], rs_v[:k], hist[:k], wts[:k], sfb=4,
                                                        sff=sff, frames=f))
                  for label, k in (("decode_vbr", n), ("decode_vbr_one_chunk", 1))]
    if "lms" in parts:
        dq = cuda(rng.integers(-3000, 3000, (f, n, c)).astype(np.int16))
        dq1 = dq[:, :1].contiguous()
        forms += [("lms_decode", lambda: lms_decode.lms_decode(dq, hist, wts)),
                  ("lms_decode_one_chunk", lambda: lms_decode.lms_decode(dq1, hist[:1], wts[:1]))]
    return forms


def session_walls(card):
    """Wall time of a 101-chunk VBR file through SeaDecoder, a chunk a call."""
    import io
    import time

    import torch

    from chip_smoke import music_signal
    from sea_codec_torch import EncoderSettings, SeaDecoder, sea_encode

    frames = 100 * 5120 + 1777
    enc = sea_encode(music_signal(frames, seed=77), 44100, 2, EncoderSettings(vbr=True, residual_bits=2.5))
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = SeaDecoder(io.BytesIO(enc), io.BytesIO())
        while dec.decode_frame():
            pass
        dec.finalize()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"session_vbr_decode (101 chunks): walls {[round(w, 4) for w in walls]} s, "
          f"median {sorted(walls)[2]:.4f} s; card {card} W")


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=310, help="search: chunks of 5,120 stereo frames")
    ap.add_argument("--decode-chunks", type=int, default=1550, help="decode: chunks of 5,120 stereo frames")
    ap.add_argument("--parts", default="search,cbr,vbr,lms", help="kernels to profile")
    ap.add_argument("--root", default=HERE, help="the checkout whose sea_codec_torch to profile")
    ap.add_argument("--idle-warps", default="default", choices=("default", "on", "off"),
                    help="decode kernels: each one's own setting, or idle warps on or off in a copy")
    ap.add_argument("--label", default="profile", help="subdirectory of --out for this run")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "kernel_profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if args.idle_warps != "default":
        root = isolated_copy(root, os.path.join(args.out, f"idle_{args.idle_warps}"), args.idle_warps == "on")
    sys.path.insert(0, root)
    from chip_smoke import music_signal
    from sea_codec_torch.ops import cuda_build, lms
    from sea_codec_torch.ops.window_search import window_search

    parts = args.parts.split(",")
    names = sorted({KERNELS[p] for p in parts})
    out_dir = os.path.join(args.out, args.label)
    os.makedirs(out_dir, exist_ok=True)
    cuda_build.build_all(names)
    card = smi("name,power.limit")
    clock = float(smi("clocks.max.sm"))
    print(f"card: {card} W; clocks.max.sm {clock} MHz; torch {torch.__version__}; "
          f"package {os.path.dirname(cuda_build.CSRC)}")

    nc, f, c, sff = args.chunks, 5120, 2, 20
    wpc = f // sff
    rng = np.random.default_rng(3)
    if "search" in parts:
        x = torch.from_numpy(music_signal(nc * f, seed=2024).reshape(nc * f, c)).cuda()
        init = (lms.initial_history(c, "cuda"), lms.initial_weights(c, "cuda"),
                torch.zeros(c, dtype=torch.int32, device="cuda"))
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

    n = args.decode_chunks
    suffix = "" if args.idle_warps == "default" else f"_idle_{args.idle_warps}"
    for label, fn in decode_forms(parts, n, f, c, sff, rng):
        label += suffix
        ms = event_ms(fn, 20)
        cyc = ms * 1e-3 * clock * 1e6 / f
        print(f"{label}: {ms:.4f} ms by events, {cyc:.0f} cycles per frame of one stream; card {card} W")
        for row in profiled(fn, label, out_dir):
            print(f"  profiler: {row}")
    if "session" in parts:
        session_walls(card)
    print("SASS instructions per kernel:", json.dumps(sass_counts(out_dir, names), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
