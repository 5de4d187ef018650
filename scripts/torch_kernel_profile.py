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

``--parts`` picks kernels (search, cbr, vbr, lms, and the two-kernel
decode's dequant prologs dequant_cbr and dequant_vbr: the whole wrapper
call, [``--decode-chunks``, 5120, 2] and one chunk, VBR sizes as above),
``host`` (the dequant wrappers' host time a call, step by step) and
``session``: the wall
time of ``SeaDecoder`` decoding a 101-chunk stereo VBR file (2.5 bits) a
chunk per call, five times. ``--root`` profiles the
``sea_codec_torch`` of another checkout (an earlier commit unpacked with
``git archive``), so that two versions are timed in one call, in turns;
``--idle-warps on`` (or ``off``) profiles a copy of the package under
``--out`` in which every decode kernel leaves (or does not leave) the
recurrence warp's scheduler to it: its ``kIsolate`` constant set so;
``default`` keeps each kernel's own. Run the script once per setting, in
turns, to compare them. ``--dequant-sweep`` times the dequant prologs of
this tree at other launch shapes (threads a block; for VBR, chunks a
block), set in the wrapper module for the run.
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
           "dequant_cbr": "dequant_cbr", "dequant_vbr": "dequant_vbr", "session": "fused_decode_vbr",
           "host": "dequant_vbr"}
# (threads, VBR chunks a block, VBR tiles of the ring's tile_frames) tried by --dequant-sweep
DEQUANT_SHAPES = ((128, 2, 1), (128, 2, 2), (128, 2, 4), (128, 4, 4), (256, 2, 4), (256, 4, 2), (256, 4, 4),
                  (256, 8, 4), (512, 8, 4), (64, 1, 4))
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


def host_us(fn, reps=20):
    """Host time of one call of ``fn`` (the wrapper's Python and the launch),
    over ``reps`` calls enqueued without waiting for the card."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


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

    from sea_codec_torch.ops import dequant, fused_decode, fused_decode_vbr, lms_decode

    wpc = f // sff
    cuda = lambda a: torch.from_numpy(a).cuda()
    sf = cuda(rng.integers(0, 16, (n, wpc, c), dtype=np.uint8))
    hist = cuda(rng.integers(-3000, 3000, (n, c, 4)).astype(np.int32))
    wts = cuda(rng.integers(-(1 << 14), 1 << 14, (n, c, 4)).astype(np.int32))
    res = cuda(rng.integers(0, 256, (n, f * c * 3 // 8), dtype=np.uint8))
    sizes = rng.choice(np.array([2, 3, 4], np.uint8), (n, wpc, c), p=[0.83, 0.16, 0.01])
    res_v = cuda(rng.integers(0, 256, (n, int(sizes.sum(axis=(1, 2)).max()) * sff // 8 + 1), dtype=np.uint8))
    rs_v = cuda(sizes)
    forms = []
    if "cbr" in parts:
        forms += [(label, lambda k=k: fused_decode.decode_cbr_fused(res[:k], sf[:k], hist[:k], wts[:k], sfb=4, rs=3,
                                                        sff=sff, frames=f))
                  for label, k in (("decode_cbr", n), ("decode_cbr_one_chunk", 1))]
    if "vbr" in parts:
        forms += [(label, lambda k=k: fused_decode_vbr.decode_vbr_fused(res_v[:k], sf[:k], rs_v[:k], hist[:k], wts[:k], sfb=4,
                                                        sff=sff, frames=f))
                  for label, k in (("decode_vbr", n), ("decode_vbr_one_chunk", 1))]
    if "dequant_cbr" in parts:
        forms += [(label, lambda k=k: dequant.unpack_dequant_cbr(res[:k], sf[:k], sfb=4, rs=3, sff=sff, frames=f))
                  for label, k in (("dequant_cbr", n), ("dequant_cbr_one_chunk", 1))]
    if "dequant_vbr" in parts:
        forms += [(label, lambda k=k: dequant.unpack_dequant_vbr(res_v[:k], sf[:k], rs_v[:k], sfb=4, sff=sff, frames=f))
                  for label, k in (("dequant_vbr", n), ("dequant_vbr_one_chunk", 1))]
    if "lms" in parts:
        dq = cuda(rng.integers(-3000, 3000, (f, n, c)).astype(np.int16))
        dq1 = dq[:, :1].contiguous()
        forms += [("lms_decode", lambda: lms_decode.lms_decode(dq, hist, wts)),
                  ("lms_decode_one_chunk", lambda: lms_decode.lms_decode(dq1, hist[:1], wts[:1]))]
    return forms


def host_split(f, c, sff, rng, card):
    """Host time of each step of one dequant wrapper call on one chunk (its
    Python, the table lookup, the output's allocation, the device and
    stream, the launcher through ctypes), over 200 calls enqueued without
    waiting for the card."""
    import time

    import torch

    from sea_codec_torch.ops import dequant, tables

    forms = dict(decode_forms(("dequant_cbr", "dequant_vbr"), 1, f, c, sff, rng))
    wpc = f // sff
    dev = torch.device("cuda", torch.cuda.current_device())
    sf = torch.zeros((1, wpc, c), dtype=torch.uint8, device=dev)
    res = torch.zeros((1, f * c), dtype=torch.uint8, device=dev)
    out = torch.empty((f, 1, c), dtype=torch.int16, device=dev)
    dqt = tables.dq_table(4, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cbr, vbr = dequant._cbr_launch(1, c, f), dequant._vbr_launch(1, c, sff, f)
    steps = {
        "dequant_cbr call": forms["dequant_cbr_one_chunk"],
        "dequant_vbr call": forms["dequant_vbr_one_chunk"],
        "_check (VBR)": lambda: dequant._check(res, (("sf_codes", sf), ("rs", sf)), 4, sff, f),
        "tables.dq_table": lambda: tables.dq_table(4, dev),
        "torch.empty": lambda: torch.empty((f, 1, c), dtype=torch.int16, device=dev),
        "launch geometry (VBR)": lambda: dequant._vbr_launch(1, c, sff, f),
        "device and stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "with torch.cuda.device": lambda: torch.cuda.device(dev).__enter__(),
        "CBR launcher alone": lambda: dequant._cbr_launcher()(
            res.data_ptr(), sf.data_ptr(), dqt.data_ptr(), out.data_ptr(), 1, f * c, f * c * 3 // 8, c, wpc,
            f, 16, 3, sff, cbr["tile"], cbr["group"], cbr["threads"], cbr["smem"], stream),
        "VBR launcher alone": lambda: dequant._vbr_launcher()(
            res.data_ptr(), sf.data_ptr(), sf.data_ptr(), dqt.data_ptr(), out.data_ptr(), 1, f * c, c, wpc,
            f, 16, sff, vbr["tile"], vbr["group"], vbr["threads"], vbr["nwmax"], vbr["smem"], stream),
    }
    for label, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"host {label}: {(t1 - t0) / 200 * 1e6:.1f} us a call; card {card} W")


def dequant_sweep(n, f, c, sff, rng, card, out_dir):
    """The dequant prologs' times at each launch shape of DEQUANT_SHAPES,
    set in this tree's wrapper module (the kernels read their shape from the
    wrapper), each checked equal to the default shape's output."""
    import torch

    from sea_codec_torch.ops import dequant

    from sea_codec_torch.ops.decode_ring import tile_frames

    default = (dequant.CBR_THREADS, dequant.VBR_THREADS, dequant.vbr_chunks_per_block, dequant.vbr_tile_frames)
    forms = dict(decode_forms(("dequant_cbr", "dequant_vbr"), n, f, c, sff, rng))
    want = {label: forms[label]() for label in ("dequant_cbr", "dequant_vbr")}
    try:
        for threads, group, tiles in DEQUANT_SHAPES:
            dequant.CBR_THREADS = dequant.VBR_THREADS = threads
            dequant.vbr_chunks_per_block = lambda _c, g=group: g
            dequant.vbr_tile_frames = lambda c_, m=tiles: m * tile_frames(c_)
            for label, fn in forms.items():
                if label in want and not torch.equal(fn(), want[label]):
                    raise SystemExit(f"{label} at {threads} threads, {group} VBR chunks a block: output differs")
                ms = event_ms(fn, 20)
                dev = sum(row["device_us"] for row in profiled(fn, label, out_dir))
                shape = f", {group} chunks a block, tiles of {tiles * tile_frames(c)} frames" if "vbr" in label else ""
                print(f"{label} at {threads} threads a block{shape}: {ms:.4f} ms by events, "
                      f"{dev:.1f} us on the card by the profiler; card {card} W")
    finally:
        dequant.CBR_THREADS, dequant.VBR_THREADS, dequant.vbr_chunks_per_block, dequant.vbr_tile_frames = default


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
    ap.add_argument("--dequant-sweep", action="store_true",
                    help="time the dequant prologs at the launch shapes of DEQUANT_SHAPES")
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
        print(f"{label}: {ms:.4f} ms by events, {cyc:.0f} cycles per frame of one stream, "
              f"{host_us(fn):.1f} us of host time a call; card {card} W")
        for row in profiled(fn, label, out_dir):
            print(f"  profiler: {row}")
    if "host" in parts:
        host_split(f, c, sff, rng, card)
    if args.dequant_sweep:
        dequant_sweep(n, f, c, sff, rng, card, out_dir)
    if "session" in parts:
        session_walls(card)
    print("SASS instructions per kernel:", json.dumps(sass_counts(out_dir, names), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
