#!/usr/bin/env python3
"""Where the cycles of the shared decode ring go, on one CUDA card.

Run from the repository root: ``python3 scripts/torch_ring_probe.py``.
``ncu`` is not at hand, so the script copies ``sea_codec_torch`` twice
under ``build/ring_probe/`` and, in the copies only, wraps the phases of
``csrc/decode_ring.cuh`` in ``clock64()`` readings: per producer warp, the
cycles of each tile's ``prepare`` (the VBR window tables), the wait for a
free dq slot, ``fill`` and the PCM copy-out; for the recurrence warp, its
whole loop and its waits for a full dq slot or a free PCM slot. It decodes
[``--chunks``, 5120, 2] with the fused CBR and VBR kernels (random bytes,
VBR sizes 2 to 4 bits as at a 2.5-bit target) and ``lms_decode``, in one
copy with the idle warps that leave the recurrence warp's scheduler to it
and in the other without (every kernel's ``kIsolate`` set so), and prints the phases of blocks 0 and 50, summed over tiles and
averaged over their producer warps, with the card's name and power limit.
In the same copies it times the VBR dequant prolog's tile walk
(``csrc/dequant_vbr.cu``, every warp a producer): per warp, each tile's
``prepare``, ``fill``, the wait at the barrier before the copy-out and the
copy-out, at [``--chunks``, 5120, 2] and for one chunk alone.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from torch_kernel_profile import isolated_copy

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRODUCE = """  for (int i = 0; i <= r.ntiles; ++i) {
    if (i < r.ntiles) {
      const int slot = i % kSlots;
      p.prepare(i);
      if (i >= kSlots) mbar_wait(r.dq_empty(slot), ((i / kSlots) - 1) & 1);
      p.fill(i, r.dq + slot * r.dq_slot);
      mbar_arrive(r.dq_full(slot));
    }
    if (i >= 1) copy_out(r, i - 1, r.ptid, out);
  }"""
PRODUCE_PROBED = """  long long tp = 0, tw = 0, tf = 0, tc = 0;
  const long long t0 = clock64();
  for (int i = 0; i <= r.ntiles; ++i) {
    if (i < r.ntiles) {
      const int slot = i % kSlots;
      const long long a = clock64();
      p.prepare(i);
      const long long b = clock64();
      if (i >= kSlots) mbar_wait(r.dq_empty(slot), ((i / kSlots) - 1) & 1);
      const long long c = clock64();
      p.fill(i, r.dq + slot * r.dq_slot);
      const long long d = clock64();
      tp += b - a; tw += c - b; tf += d - c;
      mbar_arrive(r.dq_full(slot));
    }
    const long long e = clock64();
    if (i >= 1) copy_out(r, i - 1, r.ptid, out);
    tc += clock64() - e;
  }
  if ((blockIdx.x == 0 || blockIdx.x == 50) && r.ptid % 32 == 0)
    printf("PROBE producer %d %d %lld %lld %lld %lld %lld\\n", blockIdx.x, r.ptid / 32,
           clock64() - t0, tp, tw, tf, tc);"""
WAIT = """    mbar_wait(r.dq_full(slot), (t / kSlots) & 1);
    if (t >= kSlots) mbar_wait(r.pcm_empty(slot), ((t / kSlots) - 1) & 1);"""
WAIT_PROBED = """    const long long a = clock64();
    mbar_wait(r.dq_full(slot), (t / kSlots) & 1);
    if (t >= kSlots) mbar_wait(r.pcm_empty(slot), ((t / kSlots) - 1) & 1);
    tw += clock64() - a;"""
LOOP = "  for (int t = 0; t < r.ntiles; ++t) {"
LOOP_PROBED = "  long long tw = 0;\n  const long long t0 = clock64();\n" + LOOP
REC_END = """    mbar_arrive(r.dq_empty(slot));
    mbar_arrive(r.pcm_full(slot));
  }
}"""
REC_END_PROBED = """    mbar_arrive(r.dq_empty(slot));
    mbar_arrive(r.pcm_full(slot));
  }
  if ((blockIdx.x == 0 || blockIdx.x == 50) && threadIdx.x == 0)
    printf("PROBE recurrence %d %lld %lld\\n", blockIdx.x, clock64() - t0, tw);
}"""
# the VBR dequant prolog's tile walk (dequant_vbr.cu): every warp a producer
DEQUANT = """  for (int i = 0; i < ntiles; ++i) {
    p.prepare(i);  // waits until every thread is done with tile i - 1
    p.fill(i, slot);
    __syncthreads();
    store_rows(t, slot, i * tile, p.nf, out, stride, vec);
  }"""
DEQUANT_PROBED = """  long long tp = 0, tf = 0, tw = 0, ts = 0;
  const long long t0 = clock64();
  for (int i = 0; i < ntiles; ++i) {
    const long long a = clock64();
    p.prepare(i);
    const long long b = clock64();
    p.fill(i, slot);
    const long long d = clock64();
    __syncthreads();
    const long long e = clock64();
    store_rows(t, slot, i * tile, p.nf, out, stride, vec);
    tp += b - a; tf += d - b; tw += e - d; ts += clock64() - e;
  }
  if ((blockIdx.x == 0 || blockIdx.x == 50) && threadIdx.x % 32 == 0)
    printf("PROBE dequant %d %d %lld %lld %lld %lld %lld\\n", blockIdx.x, threadIdx.x / 32,
           clock64() - t0, tp, tf, tw, ts);"""



def probed_copy(dest, isolate):
    """sea_codec_torch copied to ``dest`` with the ring's phases timed and
    every ring kernel's ``kIsolate`` set to ``isolate``."""
    isolated_copy(HERE, dest, isolate)
    path = os.path.join(dest, "sea_codec_torch", "csrc", "decode_ring.cuh")
    with open(path) as f:
        src = f.read()
    for old, new in ((PRODUCE, PRODUCE_PROBED), (WAIT, WAIT_PROBED), (LOOP, LOOP_PROBED),
                     (REC_END, REC_END_PROBED), ("#include <cstdint>", "#include <cstdint>\n#include <cstdio>")):
        if src.count(old) != 1:
            raise SystemExit(f"torch_ring_probe: decode_ring.cuh no longer has the text to probe: {old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    path = os.path.join(dest, "sea_codec_torch", "csrc", "dequant_vbr.cu")
    with open(path) as f:
        src = f.read()
    for old, new in ((DEQUANT, DEQUANT_PROBED), ("#include <cstdint>", "#include <cstdint>\n#include <cstdio>")):
        if src.count(old) != 1:
            raise SystemExit(f"torch_ring_probe: dequant_vbr.cu no longer has the text to probe: {old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


CHILD = r"""
import ctypes
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from sea_codec_torch.ops import dequant, fused_decode, fused_decode_vbr, lms_decode
n, f, c, sff = int(sys.argv[2]), 5120, 2, 20
wpc = f // sff
rng = np.random.default_rng(3)
cuda = lambda a: torch.from_numpy(a).cuda()
sf = cuda(rng.integers(0, 16, (n, wpc, c), dtype=np.uint8))
hist = cuda(rng.integers(-3000, 3000, (n, c, 4)).astype(np.int32))
wts = cuda(rng.integers(-(1 << 14), 1 << 14, (n, c, 4)).astype(np.int32))
res = cuda(rng.integers(0, 256, (n, f * c * 3 // 8), dtype=np.uint8))
sizes = rng.choice(np.array([2, 3, 4], np.uint8), (n, wpc, c), p=[0.83, 0.16, 0.01])
res_v = cuda(rng.integers(0, 256, (n, int(sizes.sum(axis=(1, 2)).max()) * sff // 8 + 1), dtype=np.uint8))
rs_v = cuda(sizes)
dq = cuda(rng.integers(-3000, 3000, (f, n, c)).astype(np.int16))
runs = {
    "fused_decode_cbr": lambda: fused_decode.decode_cbr_fused(res, sf, hist, wts, sfb=4, rs=3, sff=sff, frames=f),
    "fused_decode_vbr": lambda: fused_decode_vbr.decode_vbr_fused(res_v, sf, rs_v, hist, wts, sfb=4, sff=sff, frames=f),
    "lms_decode": lambda: lms_decode.lms_decode(dq, hist, wts),
    "dequant_vbr": lambda: dequant.unpack_dequant_vbr(res_v, sf, rs_v, sfb=4, sff=sff, frames=f),
    "dequant_vbr_one_chunk": lambda: dequant.unpack_dequant_vbr(res_v[:1], sf[:1], rs_v[:1], sfb=4, sff=sff, frames=f),
}
libc = ctypes.CDLL(None)  # the kernels' printf goes through C's stdout


def run(label, fn):
    print(label, flush=True)
    fn()
    torch.cuda.synchronize()
    libc.fflush(None)


for name, fn in runs.items():
    run("WARM", fn)
    run(f"RUN {name} idle_warps={sys.argv[3]}", fn)
"""


def summarize(log):
    """Per run and block: the recurrence's cycles and waits, and the
    producer warps' mean phases."""
    out, run, rows = [], None, []

    def flush():
        if run is None:
            return
        for blk in sorted({r[1] for r in rows}):
            rec = [r for r in rows if r[0] == "recurrence" and r[1] == blk]
            prod = [r[3:] for r in rows if r[0] == "producer" and r[1] == blk]
            mean = [sum(col) / len(prod) for col in zip(*prod)] if prod else []
            deq = [r[3:] for r in rows if r[0] == "dequant" and r[1] == blk]
            line = f"{run} block {blk}:"
            if deq:
                d = [sum(col) / len(deq) for col in zip(*deq)]
                out.append(f"{line} {len(deq)} warps, mean total {d[0]:.0f}: prepare {d[1]:.0f}, fill {d[2]:.0f}, "
                           f"barrier {d[3]:.0f}, copy-out {d[4]:.0f}")
                continue
            if rec:
                line += f" recurrence {rec[0][2]} cycles, waiting {rec[0][3]}"
            if mean:
                line += (f"; {len(prod)} producer warps, mean total {mean[0]:.0f}: prepare {mean[1]:.0f}, "
                         f"wait for a free slot {mean[2]:.0f}, fill {mean[3]:.0f}, copy-out {mean[4]:.0f}")
            out.append(line)

    for line in log.splitlines():
        if line.startswith(("RUN ", "WARM")):
            flush()
            run, rows = (line[4:] if line.startswith("RUN ") else None), []
        elif line.startswith("PROBE ") and run is not None:
            parts = line.split()
            rows.append((parts[1], int(parts[2]), *map(int, parts[3:])))
    flush()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=1550, help="chunks of 5,120 stereo frames")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "ring_probe"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ring_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    for idle in ("on", "off"):
        dest = os.path.join(args.out, idle)
        probed_copy(dest, idle == "on")
        child = subprocess.run([sys.executable, "-c", CHILD, dest, str(args.chunks), idle],
                               capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            print(child.stdout[-4000:], child.stderr[-4000:], file=sys.stderr)
            return 1
        for line in summarize(child.stdout):
            print(f"{line}; card {card}")
    print(f"[{args.chunks}, 5120, 2]: sums over a block's 20 tiles of 256 frames (the VBR dequant: over "
          f"its own tiles, ops/dequant.py vbr_tile_frames); card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
