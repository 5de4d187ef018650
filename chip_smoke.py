#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sea_codec_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, in order; any failure exits non-zero:

1. Build the six CUDA kernels from ``sea_codec_torch/csrc`` (one nvcc
   each, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the same inputs,
   bit for bit (tolerance 0: an integer codec): the fused CBR decode over
   rs 1..8 x sfb {1,4,8} x C {1,2,8,255} with random bytes and LMS states;
   the fused VBR decode over random per-window sizes 1..8 x sfb {1,4,8} x
   C {1,2,8,255} with partial last windows, then sff 1 and 255, C 3, 5, 17,
   31 and 33, batches of 1 to 33 chunks that fill no whole number of blocks,
   and malformed size and scale-factor tables; for both, an exhaustive dequant
   check against the table build; the window search over sfb 1..8 x rs
   1..8 on clipping stress signals, at sff 20 (the unrolled loop) and 16,
   with and without a ragged tail, from entry weights on both sides of the
   weights penalty's bound and at the int32 ends, and in its VBR forms
   (per-window sizes; ranks-only, also against the full form); and with
   valid counts per (window, lane), the corpus encode's form, in all three
   forms at sfb 1, 4, 8, sff 20 and 13 and 1 to 600 lanes, the per-window
   sizes with only a size range's table rows staged.
   The kernels of the two-kernel decode: the LMS recurrence on random dq
   streams (1 to 80,000 streams, C 1 to 255, 300 and 480, frame counts off every
   tile, extreme weights, each stream also 2 bytes off its alignment); the
   CBR dequant over rs 1..8 x sfb {1,4,8} x C {1,2,3,8,255} and the VBR
   dequant over random size tables, both with full and partial last
   windows, both on the fused VBR decode's edge cases with malformed tables
   and on batches across their blocks' boundaries, and both against the
   table build for every (sfb, rs, sf, code);
   and CBR and VBR batches whose rows exceed a block's shared memory, which
   the fused kernels stream tile by tile and the two-kernel path decodes as
   well.
3. The committed CBR and VBR fixtures: ``sea_encode`` gives their bytes and
   ``sea_decode`` their PCM, through the batch engine and through the
   sessions (``engine="session"``); ``SeaDecoder.seek`` and ``decode_range``
   at ranges inside chunks and into the tail; tail-only 255-channel files
   equal to plain.
4. The main paths at real size, each checked against a plain decode on the
   CPU, with the kernels' launch counts set to 0 just before each path and
   read just after. (a) A 3-minute 44.1 kHz stereo signal (7,938,000
   frames: 1,550 full chunks and a ragged tail) through ``sea_encode`` then
   ``sea_decode`` on the card, once with default settings (CBR) and once
   with VBR at 2.5 bits. (b) ``decode_corpus`` on a corpus of 34 files,
   ~180 Msamples: CBR defaults and VBR at 2.5 bits, stereo and 3-channel
   files of differing ragged lengths and a tail-only 255-channel file per
   mode, once with the default routing (every group on the fused kernels,
   no two-kernel launch) and once with the fused kernels off
   (``SEA_FUSED_PROLOG=0``: every batch on the two-kernel path); every
   file's PCM equal to ``decode_sea``'s; then once with
   ``batch.PIPELINE_TIMES`` set, for its stage report. (c) ``encode_corpus``,
   both modes, on bench.py's corpus shape (256 stereo files of 7-8 chunks
   CBR, 64 VBR) and on (b)'s files by channel count, bytes equal to
   per-file ``sea_encode``, the search launched lane-packed, with its
   stage report and the summed per-file walls. (d) The device transcodes
   (``parse_device``) of (a)'s full-chunk rows, PCM equal to
   ``decode_sea``'s, with no wait for the card before the result. (e) One
   file per mode through ``SeaEncoder``/``SeaDecoder`` chunk by chunk, bytes
   equal to the batch engine's.
5. The kernels at the main-path shapes: each decode kernel equal to its
   plain version on all full chunks, timed there and on one chunk alone (the
   recurrence on the CBR and the VBR dq stream); the search kernel equal to the CBR
   file's scale factors, codes and chunk states, and to its plain version
   on the first two chunks and on the masked tail; its VBR forms equal to
   the VBR file (the host pack of their outputs giving its bytes), to the
   plain version on the first two chunks and on the tail. Times of each
   kernel and its plain version, beside two least times for the same work:
   the roofline (bytes or operations) and the serial chain at the highest
   SM clock; the VBR host pack's time on its own line. The two-kernel
   decode's kernels at the same shape [1550, 5120, 2] (``torch.profiler``
   records one CUDA kernel for one call of each dequant wrapper), and its
   total beside the fused kernel's time, taken in turns. The search's
   per-window form at 132, 264 and 528 lanes with every size's table rows
   staged and with 1..4's, in turns, and the blocks an SM holds of each
   form the corpus encode launches.
6. The front ends and the mesh pipelines (run between phases 4 and 5, so
   that their launches count in the kernels line), each with its launch
   counts and wall: (a) ``seaconv`` (``cli.main``) on phase 4's 3-minute
   signal written to a ``.wav``, CBR (``-b 3``) and VBR (``-v -b 2.5``),
   bytes equal to the main path's files and the ``.wav`` written back to
   ``sea_decode``'s PCM, then ``python -m sea_codec_torch`` in a child
   process; (b) the batch CLI on bench.py's corpus shape as ``.wav`` files
   (256 CBR, 64 VBR), bytes equal to ``encode_corpus``'s and PCM written
   back to ``decode_corpus``'s, with its stage report; (c) meshes of
   repeated ``cuda:0`` entries: ``encode_corpus`` on (b)'s corpora and
   ``decode_corpus`` on phase 4's 34-file corpus over 2 entries, equal to
   ``mesh=None`` (walls in turns), ``corpus_transcode_step`` at [8, 194,
   5120, 2] over 2 x 2 entries, PCM equal to per-file ``sea_encode`` then
   ``sea_decode``, and ``decode_chunk_batch_sharded`` on the main path's
   1,550 chunks, equal to ``decode_chunks``, from host arrays and again
   from tensors on the card still being written on the current stream
   (each entry's stream must wait for them); (d) two ``batch_cli
   --distributed`` processes on ``cuda:0`` with a coordinator on
   ``localhost``, on 16 of (b)'s files: their union equal to the
   single-process bytes. Child processes run with the checkout on
   ``PYTHONPATH`` and load the kernels phase 1 built, each under a timeout.
7. The serving artifacts (``aot.py``) and the kernel build cache (run after
   phase 6 and before phase 5, so that their launches count in the kernels
   line): (a) the rows decoders of phase 4 (a)'s full chunks ([1550,
   chunk_size], CBR at rs 3 and VBR at the first chunk header's anchor)
   exported on the card, saved to bytes, loaded in this process and run:
   PCM equal to ``decode_sea``'s, one fused launch a call; (b) the same
   exported with ``SEA_FUSED_PROLOG=0``: one dequant and one ``lms_decode``
   launch a call; (c) the loaded artifacts timed against the eager device
   transcodes in turns, and each decode wrapper's host time a call beside
   its op's and its CUDA kernel function's; (d) a child process with no
   ``nvcc`` to be found loads both artifacts from files and decodes from
   the build cache phase 1 built into (``SEA_TORCH_CACHE``), building
   nothing, and the same child with an empty cache fails with
   ``cuda_build``'s "nvcc not found".

The last lines are the kernels' JSON line, the card line and the result
line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, data sheet
# That f32 rate counts an FMA as two operations on 128 lanes per SM: an SM
# issues 128 instructions of any type per clock (half the f32 rate), and
# has 64 int32 lanes (a quarter of it).
H100_ISSUE_PER_S = H100_F32_OPS_PER_S / 2
H100_INT32_OPS_PER_S = H100_F32_OPS_PER_S / 4
# (int32, f32) instructions per sample (decode) and per candidate-sample
# (search): the function's own work, counted from the kernels' inner loops in
# sea_codec_torch/csrc where those do no more than it needs.
# The three decode kernels share the recurrence of csrc/decode_ring.cuh: per
# sample 23 on the recurrence thread (the dot, shift, add, clamp, the weight
# step, a shared-memory load and store) and ~2 of the producers' PCM copy-out.
RECURRENCE_OPS_PER_SAMPLE = 25
# The unpack + dequant (the dequant prologs' whole function, the fused
# decodes' share), see unpack_dequant_ops: per byte of packed codes its load,
# shift and or; per sample the code's shift and mask and its value read from
# the reference table dqt[sf][code], whose entries carry the sign (the
# address and the load); per eight samples one 16-byte store and its
# address; per (window, channel) entry the scale factor's load. VBR adds per
# sample the running bit position and the mask from the code's size, and per
# entry the size's load and the prefix's add. None of it is f32. How a kernel
# groups this work (divisions, window bookkeeping, table scans, the copy to
# the time-major stream) is its own overhead, not the function's.
UNPACK_OPS_PER_BYTE, UNPACK_OPS_PER_SAMPLE, UNPACK_OPS_PER_GROUP8, UNPACK_OPS_PER_ENTRY = 3, 4, 2, 1
VBR_UNPACK_OPS_PER_SAMPLE, VBR_UNPACK_OPS_PER_ENTRY = 2, 2
# Search, the unrolled table step: the carried dot (8 multiply-adds), sea_div
# (2), the clamp and its limits (6), the lookup (2), the reconstruction (3),
# the rank (3), the weight step (4), the sign (2), the code store and the
# sample load (2); f32: the penalty guard (4 I2F, FMUL, 3 FFMA, FMNMX).
SEARCH_OPS_PER_STEP = (32, 9)
# the standalone recurrence: the shared 25 plus the producers' copy in
# 8-byte lines (~3 a sample: the division into frame and line, two addresses,
# the load, the store, the loop, per four samples); no f32
LMS_OPS_PER_SAMPLE = (RECURRENCE_OPS_PER_SAMPLE + 3, 0)


def code_bytes(b, frames):
    """Bytes of packed codes that the chunks of ``b`` (parse_full_chunks,
    ``frames`` a chunk) hold: each (window, channel) entry's size (clamped
    to 1..8, as the kernels read it; CBR's is constant) for the window's
    frames, a chunk's bits rounded up to bytes."""
    _n, w, _c = b.sf.shape
    fiw = np.minimum(b.scale_factor_frames, frames - np.arange(w) * b.scale_factor_frames)
    bits = (np.clip(b.rs.astype(np.int64), 1, 8).sum(axis=2) * fiw).sum(axis=1)
    return int(((bits + 7) // 8).sum())


def unpack_dequant_ops(b, frames):
    """(int32, f32) operations of the unpack + dequant of the chunks of
    ``b``, by the counts above."""
    n, w, c = b.sf.shape
    samples, entries = n * frames * c, n * w * c
    vbr = b.residual_size == 0
    per_sample = UNPACK_OPS_PER_SAMPLE + (VBR_UNPACK_OPS_PER_SAMPLE if vbr else 0)
    per_entry = UNPACK_OPS_PER_ENTRY + (VBR_UNPACK_OPS_PER_ENTRY if vbr else 0)
    return (UNPACK_OPS_PER_BYTE * code_bytes(b, frames) + per_sample * samples
            + UNPACK_OPS_PER_GROUP8 * -(-samples // 8) + per_entry * entries, 0)


def decode_ops(b, frames):
    """(int32, f32) operations of a fused decode of the chunks of ``b``:
    the unpack + dequant, then the recurrence."""
    n, _w, c = b.sf.shape
    unpack = unpack_dequant_ops(b, frames)
    return (unpack[0] + n * frames * c * RECURRENCE_OPS_PER_SAMPLE, unpack[1])


# The serial chain each kernel walks, as (integer/f32 instructions,
# shared-memory loads, shuffles or barriers) that depend on each other in
# turn, at an assumed Hopper latency of 4 and 23 cycles. Its least time is
# the chain of one stream at the card's highest SM clock.
ALU_CYCLES, SMEM_CYCLES = 4, 23
# decode, one frame: recon(t-1) is h3 -> the dot's last IMAD (w3*h3 plus the
# other three products) -> SHF >>13 -> IADD +dq -> 2 IMNMX (clamp) -> recon(t);
# the code fetch and the dequant do not depend on the chain
DECODE_FRAME_CHAIN = (5, 0)
# search, one sample step of a candidate (the unrolled table step): the
# carried dot's last IMAD, SHF >>13, the residual times 8 (one IMAD), sea_div
# (IMAD.HI), 2 (clamp), IMAD (the table address), the table load, pred +
# (word >> 8) in one LEA, 2 (clamp)
SEARCH_STEP_CHAIN = (10, 1)
# search, once per window at S <= 32: three warp minima (redux) with a
# compare-select pair between them, the winner's index (2), one shuffle (the
# eight state words travel side by side)
SEARCH_WINDOW_CHAIN = (6, 3 + 1)
# the same two as the kernel had them before its redesign (its f32 dequant
# on the chain, five shuffle levels and three block barriers a window): the
# yardstick its earlier times were held against
SEARCH_STEP_CHAIN_BEFORE = (26, 1)
SEARCH_WINDOW_CHAIN_BEFORE = (5 * 3 + 3, 5 + 3 + 2)


def chain_cycles(chain):
    alu, smem = chain
    return alu * ALU_CYCLES + smem * SMEM_CYCLES


def bounds(k, clock_mhz):
    """Roofline bound (bytes or operations) and chain bound of a kernel."""
    t_bytes = k["bytes"] / H100_BYTES_PER_S * 1e3
    int_ops, f32_ops = k["ops"]
    t_ops = max(int_ops / H100_INT32_OPS_PER_S, (int_ops + f32_ops) / H100_ISSUE_PER_S) * 1e3
    k["bound_ms"] = max(t_bytes, t_ops)
    k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    k["chain_ms"] = k.pop("chain_cycles") / (clock_mhz * 1e6) * 1e3
    if "chain_cycles_before" in k:
        k["chain_ms_before"] = k.pop("chain_cycles_before") / (clock_mhz * 1e6) * 1e3
    # the least time the kernel could take: no stream's dependent steps can
    # be spread over more threads, whatever the roofline allows
    k["least_ms"] = max(k["bound_ms"], k["chain_ms"])
    k["clock_mhz"] = clock_mhz
    k["library_ms"] = None


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def smi(query, units=""):
    """First card's answer to ``nvidia-smi --query-gpu=<query>``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", f"--format=csv,noheader{units}"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}") from e


def card_line():
    return smi("name,power.limit")


def max_abs(a, b):
    import torch

    if a.shape != b.shape:
        raise SmokeFailure(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    if a.dtype == torch.int64:  # u64 ranks: any difference counts as one
        return int((a.cpu() != b.cpu()).any())
    return int((a.cpu().long() - b.cpu().long()).abs().max())


def cuda_ms(fn, reps):
    """(ms per call, the last call's result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def kernels_recorded(fn, here, attempts=3):
    """(name, device microseconds) of each CUDA kernel that ``torch.profiler``
    records for one call of ``fn`` after a warm-up call (its trace kept
    under ``build/``). CUPTI has been seen to deliver no kernel record at
    all for a profiled call, on one run in six: an empty recording is
    profiled again, up to ``attempts`` times in all, and returned empty if
    every attempt is; any other recording is returned as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [(e["name"], e["dur"]) for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
        log(f"[phase 5] torch.profiler recorded no CUDA kernel (attempt {attempt} of {attempts})")
    return kernels


def worst_of(got, want, what):
    """Largest difference over paired outputs; fails unless all are 0."""
    worst = 0
    for g, p in zip(got, want, strict=True):
        err = max_abs(g, p)
        check(err == 0, f"{what}: kernel != plain")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def decode_sweep(rng):
    import torch

    from sea_codec_torch.ops.fused_decode import decode_cbr_fused, decode_cbr_plain

    worst = 0
    cases = 0
    for rs in range(1, 9):
        for sfb in (1, 4, 8):
            for c in (1, 2, 8, 255):
                n, frames = 3, 200
                sff = (20, 7, 1)[cases % 3]
                w = -(-frames // sff)
                res = rng.integers(0, 256, (n, -(-frames * c * rs // 8)), dtype=np.uint8)
                sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
                hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
                lim = (1 << 14, 1 << 24, 1 << 31)[cases % 3]  # large weights too
                wts = rng.integers(-lim, lim, (n, c, 4)).astype(np.int32)
                cpu = [torch.from_numpy(a) for a in (res, sf, hist, wts)]
                kw = dict(sfb=sfb, rs=rs, sff=sff, frames=frames)
                got = decode_cbr_fused(*[t.cuda() for t in cpu], **kw)
                want = decode_cbr_plain(*cpu, **kw)
                err = max_abs(got, want)
                check(err == 0, f"decode rs={rs} sfb={sfb} c={c}: kernel != plain")
                worst = max(worst, err)
                cases += 1
    torch.cuda.synchronize()
    log(f"[phase 2] fused decode == plain on {cases} configs (rs 1..8 x sfb 1,4,8 x C 1,2,8,255)")
    return worst


def dequant_exhaustive():
    """Frame 0 of a stream with zero LMS state is its dequantized value, so
    streams enumerating every (sf, code) read the kernel's dequant back."""
    import torch

    from sea_codec_torch.ops import bitpack, tables
    from sea_codec_torch.ops.fused_decode import decode_cbr_fused, decode_cbr_plain

    worst = 0
    for sfb in range(1, 9):
        for rs in range(1, 9):
            s, m = 1 << sfb, 1 << rs
            sf_all = np.repeat(np.arange(s), m)
            code_all = np.tile(np.arange(m), s)
            c = 255
            n = -(-sf_all.size // c)
            pad = n * c - sf_all.size
            sf = np.concatenate([sf_all, np.zeros(pad, np.int64)]).reshape(n, 1, c)
            codes = np.concatenate([code_all, np.zeros(pad, np.int64)]).reshape(n, c)
            res = np.stack([bitpack.pack_bits(row, rs) for row in codes])
            zeros = np.zeros((n, c, 4), np.int32)
            cpu = [
                torch.from_numpy(a)
                for a in (res, sf.astype(np.uint8), zeros, zeros.copy())
            ]
            kw = dict(sfb=sfb, rs=rs, sff=1, frames=1)
            got = decode_cbr_fused(*[t.cuda() for t in cpu], **kw).cpu()
            dq = got[:, 0, :].reshape(-1)[: sf_all.size].numpy().astype(np.int64)
            want = tables.dqt(rs, sfb)[sf_all, code_all]
            check(np.array_equal(dq, want), f"dequant sfb={sfb} rs={rs} != tables.dqt")
            worst = max(worst, max_abs(got, decode_cbr_plain(*cpu, **kw)))
    log("[phase 2] kernel dequant == tables.dqt for every (sfb, rs, sf, code)")
    return worst


def random_vbr_batch(rng, n, c, sfb, frames, sff):
    """Random VBR chunks: per-(window, channel) sizes 1..8, rows as long as
    the size table needs (the last window partial when sff does not divide
    frames), random scale factors and LMS entry states."""
    w = -(-frames // sff)
    rs = rng.integers(1, 9, (n, w, c), dtype=np.uint8)
    fiw = np.clip(frames - np.arange(w) * sff, 0, sff)
    bits = (rs.astype(np.int64) * fiw[None, :, None]).sum(axis=(1, 2))
    res = rng.integers(0, 256, (n, int(-(-bits.max() // 8))), dtype=np.uint8)
    sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 24), 1 << 24, (n, c, 4)).astype(np.int32)
    return res, sf, rs, hist, wts


def malform_vbr_tables(rng, sf, rs, sfb):
    """The same batch with malformed tables: sizes 0, 9 and 255 among the
    legal ones and scale factors at or past 2^sfb (the kernels clamp and
    mask them as they read them, and so does the plain version)."""
    rs = rs.copy()
    bad = rng.random(rs.shape) < 0.3
    rs[bad] = rng.choice(np.array([0, 9, 255], np.uint8), int(bad.sum()))
    return malform_sf(rng, sf, sfb), rs


def malform_sf(rng, sf, sfb):
    """Scale factors with random bits set at and past 2^sfb (none at sfb 8)."""
    return sf | (rng.integers(1, 256 >> sfb, sf.shape) << sfb).astype(np.uint8) if sfb < 8 else sf.copy()


# (chunks, channels, frames, sff) beyond the grid: sff 1 (a window a frame)
# and 255 (longer than a tile), channel counts that leave a warp part-empty
# or overflow it, batches that are not a multiple of a block's chunks, one
# chunk alone
VBR_EDGE_CASES = (
    (5, 2, 600, 1), (3, 1, 513, 1), (2, 3, 700, 255), (7, 3, 257, 2), (1, 17, 130, 20),
    (2, 31, 200, 3), (2, 33, 97, 1), (1, 255, 40, 255), (17, 2, 5120, 20), (1, 2, 5120, 20),
    (11, 5, 300, 7), (33, 1, 64, 20),
)


def vbr_decode_sweep(rng):
    import torch

    from sea_codec_torch.ops.fused_decode_vbr import decode_vbr_fused, decode_vbr_plain

    worst = 0
    cases = []
    for sfb in (1, 4, 8):
        for c in (1, 2, 8, 255):
            for frames, sff in ((200, 20), (197, 20), (61, 7), (40, 1)):
                if c == 255 and frames > 61:
                    continue
                cases.append((3, c, frames, sff, sfb, False))
    cases += [(n, c, frames, sff, (1, 4, 8)[i % 3], i % 2 == 1)
              for i, (n, c, frames, sff) in enumerate(VBR_EDGE_CASES)]
    for n, c, frames, sff, sfb, malformed in cases:
        res, sf, rs, hist, wts = random_vbr_batch(rng, n, c, sfb, frames, sff)
        if malformed:
            sf, rs = malform_vbr_tables(rng, sf, rs, sfb)
        cpu = [torch.from_numpy(a) for a in (res, sf, rs, hist, wts)]
        kw = dict(sfb=sfb, sff=sff, frames=frames)
        got = decode_vbr_fused(*[t.cuda() for t in cpu], **kw)
        want = decode_vbr_plain(*cpu, **kw)
        worst = max(worst, worst_of([got], [want], f"vbr decode n={n} c={c} sfb={sfb} frames={frames} "
                                                   f"sff={sff} malformed={malformed}"))
    torch.cuda.synchronize()
    log(f"[phase 2] fused VBR decode == plain on {len(cases)} configs (sizes 1..8 per window x "
        "sfb 1,4,8 x C 1,2,8,255, partial last windows; sff 1 and 255, C 3, 5, 17, 31, 33, "
        "batches of 1 to 33 chunks across the blocks' 32 // C, tables with sizes 0, 9, 255 "
        "and scale factors past 2^sfb)")
    return worst


def vbr_dequant_exhaustive():
    """The VBR kernel's dequant for every (sfb, rs, sf, code): frame 0 of
    zero-state streams, each channel its own size within one window."""
    import torch

    from sea_codec_torch.ops import bitpack, tables
    from sea_codec_torch.ops.fused_decode_vbr import decode_vbr_fused, decode_vbr_plain

    worst = 0
    c = 255
    for sfb in range(1, 9):
        s = 1 << sfb
        items = [(rs, sf, q) for rs in range(1, 9) for sf in range(s) for q in range(1 << rs)]
        items += [(1, 0, 0)] * (-len(items) % c)
        rs_a, sf_a, q_a = (np.asarray(v).reshape(-1, c) for v in zip(*items))
        n = rs_a.shape[0]
        rows = [bitpack.pack_bits(q, r) for q, r in zip(q_a, rs_a)]
        res = np.zeros((n, max(len(r) for r in rows)), np.uint8)
        for i, r in enumerate(rows):
            res[i, : len(r)] = r
        zeros = np.zeros((n, c, 4), np.int32)
        cpu = [torch.from_numpy(a) for a in (
            res, sf_a.astype(np.uint8)[:, None], rs_a.astype(np.uint8)[:, None], zeros, zeros.copy())]
        kw = dict(sfb=sfb, sff=1, frames=1)
        got = decode_vbr_fused(*[t.cuda() for t in cpu], **kw).cpu()
        want = np.array([tables.dqt(r, sfb)[f, q] for r, f, q in zip(rs_a.ravel(), sf_a.ravel(), q_a.ravel())])
        check(np.array_equal(got[:, 0, :].reshape(-1).numpy(), want), f"vbr dequant sfb={sfb} != tables.dqt")
        worst = max(worst, max_abs(got, decode_vbr_plain(*cpu, **kw)))
    log("[phase 2] VBR kernel dequant == tables.dqt for every (sfb, rs, sf, code)")
    return worst


def stress_signal(rng, frames, c):
    """Clipping stress: full-scale noise, then full-scale square waves."""
    half = frames // 2
    noise = rng.integers(-32768, 32768, (half, c))
    t = np.arange(frames - half)[:, None]
    period = rng.integers(3, 40, c)[None, :]
    square = np.where((t % period) < period // 2, 32767, -32768)
    return np.concatenate([noise, square]).astype(np.int16)


def tail_windows(pcm_tail, sff):
    """A ragged tail int16[frames, C] as the tail-chunk encode hands it to the
    search: zero-padded to whole windows, with each window's valid frames."""
    import torch

    frames, c = pcm_tail.shape
    w = -(-frames // sff)
    xt = np.zeros((w * sff, c), np.int16)
    xt[:frames] = pcm_tail
    nv = np.clip(frames - np.arange(w) * sff, 0, sff).astype(np.int32)
    return torch.from_numpy(xt), torch.from_numpy(nv)


# The weights penalty of the search's rank is 0 below sum(w^2) = 0x900 << 18
# = 24576^2: entry weights just below the kernel's guard, between the guard
# and the bound, at the bound (penalty 1), above it, and at the int32 ends.
PENALTY_EDGE_WEIGHTS = (
    (0, 0, -8, 24574), (0, 0, 0, 24575), (0, 0, 0, -24576), (12288, 12288, -12288, 12288),
    (20000, -20000, 3, 1), (2**31 - 1, -(2**31 - 1), 2**31 - 1, -(2**31)),
)


def penalty_edge_weights(c, shift=0):
    """int32[c, 4] entry weights cycling through PENALTY_EDGE_WEIGHTS."""
    import torch

    rows = [PENALTY_EDGE_WEIGHTS[(ch + shift) % len(PENALTY_EDGE_WEIGHTS)] for ch in range(c)]
    return torch.tensor(rows, dtype=torch.int64).to(torch.int32)


def search_sweep(rng):
    import torch

    from sea_codec_torch.ops import lms
    from sea_codec_torch.ops.window_search import _table_rows, window_search, window_search_plain

    def fits_smem(s, sff, ranks_only, rs):
        try:
            _table_rows(s, sff, ranks_only, rs)
        except ValueError:
            return False
        return True

    # (sfb, rs, channels, frames per chunk): the full sfb x rs grid on small
    # channel counts, then 255 channels at sfb 8 on a shorter chunk; two of
    # three configs at sff 20 (the unrolled loop where the lookup table fits
    # shared memory), the third at sff 16 (the run-time loop)
    grid = [(sfb, rs, (1, 2, 3, 8)[i % 4], 1024)
            for i, (sfb, rs) in enumerate((b, r) for b in range(1, 9) for r in range(1, 9))]
    grid += [(8, 3, 255, 64), (8, 8, 255, 64), (4, 3, 255, 80)]
    # windows longer than the sample registers a thread keeps ahead (sff 300),
    # and the longest that fits a block's shared memory at sfb 8
    longest = max(sff for sff in range(1, 2000) if fits_smem(256, sff, False, 3))
    long_windows = {len(grid): 300, len(grid) + 1: longest}
    grid += [(2, 4, 2, 600), (8, 3, 1, longest)]
    worst = 0
    for cases, (sfb, rs, c, fpc) in enumerate(grid):
        sff = long_windows.get(cases, 16 if cases % 3 == 1 else 20)
        wpc = fpc // sff
        fpc = wpc * sff
        ragged = (cases // 4) % 2 == 1  # every C both with and without
        tail = 300 * fpc // 1024 if ragged else 0
        x = stress_signal(rng, 2 * fpc + tail, c)
        hist = lms.initial_history(c)
        wts = lms.initial_weights(c)
        prev = torch.zeros(c, dtype=torch.int32)
        if cases % 3 == 2:  # a mid-stream state with large weights
            hist = torch.from_numpy(rng.integers(-32768, 32768, (c, 4)).astype(np.int32))
            wts = torch.from_numpy(rng.integers(-(1 << 22), 1 << 22, (c, 4)).astype(np.int32))
            prev = torch.from_numpy(rng.integers(0, 1 << sfb, c).astype(np.int32))
        if cases % 4 == 1:  # entry weights on both sides of the penalty's bound
            wts = penalty_edge_weights(c, shift=cases)
        kw = dict(sfb=sfb, rs=rs, sff=sff)
        full = torch.from_numpy(x[: 2 * fpc])
        got = window_search(full.cuda(), None, hist.cuda(), wts.cuda(), prev.cuda(), wpc=wpc, **kw)
        want = window_search_plain(full, None, hist, wts, prev, wpc=wpc, **kw)
        what = f"search sfb={sfb} rs={rs} c={c} ragged={ragged}"
        worst = max(worst, worst_of(got, want, what))
        if ragged:
            xt, nv = tail_windows(x[2 * fpc :], sff)
            got_t = window_search(xt.cuda(), nv.cuda(), *got[5:], wpc=nv.numel(), **kw)
            want_t = window_search_plain(xt, nv, *want[5:], wpc=nv.numel(), **kw)
            worst = max(worst, worst_of(got_t, want_t, what))
    torch.cuda.synchronize()
    log(f"[phase 2] window search == plain on {len(grid)} configs "
        "(sfb 1..8 x rs 1..8 at C 1,2,3,8; sfb 4 and 8 at C 255; sff 20 and 16, 300, and the "
        f"longest that fits at sfb 8, {longest}; entry weights across the penalty's bound and at the int32 ends)")
    return worst


def search_sweep_vbr(rng):
    """The search's VBR forms: random per-(window, channel) sizes 1..8, and
    the ranks-only form at a constant size, each equal to its plain version
    (ranks-only has no codes), and ranks-only equal to the full form in sf,
    ranks and state; with and without a masked ragged tail."""
    import torch

    from sea_codec_torch.ops.window_search import window_search, window_search_plain

    grid = [(sfb, (1, 2, 3, 8)[sfb % 4], 256) for sfb in range(1, 9)]
    grid += [(8, 255, 32), (4, 2, 320), (5, 3, 320), (4, 255, 40)]
    worst = 0
    for i, (sfb, c, fpc) in enumerate(grid):
        sff = 16 if i % 3 == 1 else 20
        wpc = fpc // sff
        x = stress_signal(rng, 2 * wpc * sff, c)
        nw = 2 * wpc
        n_valid = None
        if i % 2:  # the last window ragged
            n_valid = torch.full((nw,), sff, dtype=torch.int32)
            n_valid[-1] = sff - 5
        hist = torch.from_numpy(rng.integers(-32768, 32768, (c, 4)).astype(np.int32))
        wts = torch.from_numpy(rng.integers(-(1 << 22), 1 << 22, (c, 4)).astype(np.int32))
        if i % 4 == 2:
            wts = penalty_edge_weights(c, shift=i)
        prev = torch.from_numpy(rng.integers(0, 1 << sfb, c).astype(np.int32))
        rs = torch.from_numpy(rng.integers(1, 9, (nw, c)).astype(np.uint8))
        cpu = (torch.from_numpy(x), n_valid, hist, wts, prev)
        gpu = tuple(None if t is None else t.cuda() for t in cpu)
        what = f"vbr search sfb={sfb} c={c} ragged={n_valid is not None}"
        for form in (dict(rs=rs), dict(rs=1 + i % 8, ranks_only=True)):
            kw = dict(form, sfb=sfb, sff=sff, wpc=wpc)
            got = window_search(*gpu, **dict(kw, rs=kw["rs"].cuda() if torch.is_tensor(kw["rs"]) else kw["rs"]))
            want = window_search_plain(*cpu, **kw)
            check((got[1] is None) == (want[1] is None), f"{what}: codes presence")
            keep = [j for j in range(8) if got[j] is not None]
            worst = max(worst, worst_of([got[j] for j in keep], [want[j] for j in keep], what))
            if form.get("ranks_only"):
                full = window_search(*gpu, **dict(kw, ranks_only=False))
                worst = max(worst, worst_of([got[j] for j in keep], [full[j] for j in keep],
                                            f"{what}: ranks-only != full form"))
    torch.cuda.synchronize()
    log(f"[phase 2] window search, VBR forms == plain on {len(grid)} configs "
        "(per-window sizes 1..8; ranks-only == plain and == the full form; sfb 1..8, C up to 255; "
        "sff 20 and 16; entry weights across the penalty's bound)")
    return worst


def search_sweep_lanes(rng):
    """The search's per-lane valid-length form (n_valid int32[W, lanes], the
    corpus encode's), in all three forms: a constant size, ranks-only, and
    per-window sizes with only a size range's table rows staged; lanes 1
    to 600, past the format's 255 channels; per lane, counts that mix full
    windows, partial windows and 0 (prefix lengths on even lanes, any count
    per window on odd ones). Each equal to the plain version on the same
    inputs on the card."""
    import torch

    from sea_codec_torch.ops.window_search import window_search, window_search_plain

    grid = [(sfb, sff, lanes) for sfb in (1, 4, 8) for sff in (20, 13) for lanes in (1, 2, 133, 300, 600)]
    ranges = ((1, 4), (2, 5), (5, 8))
    worst = 0
    for i, (sfb, sff, lanes) in enumerate(grid):
        nw, wpc = 5, 2
        x = stress_signal(rng, nw * sff, lanes)
        length = rng.integers(0, nw * sff + 1, lanes)
        length[0] = nw * sff
        if lanes > 1:
            length[1] = 0
        nv = np.clip(length[None, :] - np.arange(nw)[:, None] * sff, 0, sff)
        nv[:, 3::2] = rng.integers(0, sff + 1, (nw, len(range(3, lanes, 2))))
        hist = torch.from_numpy(rng.integers(-32768, 32768, (lanes, 4)).astype(np.int32))
        wts = torch.from_numpy(rng.integers(-(1 << 22), 1 << 22, (lanes, 4)).astype(np.int32))
        if i % 4 == 2:
            wts = penalty_edge_weights(lanes, shift=i)
        prev = torch.from_numpy(rng.integers(0, 1 << sfb, lanes).astype(np.int32))
        lo, hi = ranges[i % 3]
        sizes = torch.from_numpy(rng.integers(lo, hi + 1, (nw, lanes)).astype(np.uint8)).cuda()
        args = tuple(t.cuda() for t in (torch.from_numpy(x), torch.from_numpy(nv.astype(np.int32)), hist, wts, prev))
        what = f"per-lane search sfb={sfb} sff={sff} lanes={lanes}"
        for form in (dict(rs=1 + i % 8), dict(rs=1 + i % 8, ranks_only=True), dict(rs=sizes, rs_range=(lo, hi))):
            kw = dict(form, sfb=sfb, sff=sff, wpc=wpc)
            got = window_search(*args, **kw)
            want = window_search_plain(*args, **kw)
            keep = [j for j in range(8) if want[j] is not None]
            check((got[1] is None) == (want[1] is None), f"{what}: codes presence")
            worst = max(worst, worst_of([got[j] for j in keep], [want[j] for j in keep], what))
    torch.cuda.synchronize()
    log(f"[phase 2] window search, per-lane valid counts == plain on {len(grid)} configs x 3 forms "
        "(sfb 1,4,8 x sff 20,13 x lanes 1,2,133,300,600; counts full, partial and 0 per lane; "
        "per-window sizes with the rows of 1..4, 2..5 or 5..8 staged)")
    return worst


def lms_sweep(rng):
    """The recurrence kernel on random dq streams and entry states: 1 to
    80,000 streams, channel counts that fill a block's warp or not (1, 2, 3,
    8, 17, 255, and past the format up to the most one block holds), frame
    counts that are multiples of nothing and of no tile,
    weights up to the whole int32 range, and streams whose rows and base
    start off every copy width's alignment (N*C odd, a base 2 bytes past a
    16-byte boundary)."""
    import torch

    from sea_codec_torch.ops import lms_decode as lms_decode_mod
    from sea_codec_torch.ops.lms_decode import lms_decode, lms_decode_plain

    shapes = [(1, 1, 1), (1, 37, 1), (3, 200, 2), (17, 333, 3), (2, 65, 255),
              (600, 97, 8), (40000, 33, 2), (7, 300, 3), (3, 257, 17), (3, 70, 255),
              (33, 513, 1), (5, 95, 2), (2, 40, 300), (2, 45, lms_decode_mod.MAX_CHANNELS)]
    worst = 0
    for i, (n, f, c) in enumerate(shapes):
        lim = (1 << 14, 1 << 24, 1 << 31)[i % 3]
        dq = rng.integers(-27090, 27091, (f, n, c)).astype(np.int16)
        hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
        wts = rng.integers(-lim, lim, (n, c, 4)).astype(np.int32)
        cpu = [torch.from_numpy(a) for a in (dq, hist, wts)]
        want = lms_decode_plain(*cpu)
        gpu = [t.cuda() for t in cpu]
        got = lms_decode(*gpu)
        worst = max(worst, worst_of([got], [want], f"lms_decode n={n} f={f} c={c}"))
        # the same stream one int16 past an aligned allocation
        flat = torch.empty(dq.size + 1, dtype=torch.int16, device="cuda")
        moved = flat[1:].view(f, n, c)
        moved.copy_(gpu[0])
        check(moved.data_ptr() % 16 == 2, "the shifted stream is aligned")
        got = lms_decode(moved, gpu[1], gpu[2])
        worst = max(worst, worst_of([got], [want], f"lms_decode n={n} f={f} c={c} at a 2-byte offset"))
    torch.cuda.synchronize()
    log(f"[phase 2] LMS recurrence == plain on {len(shapes)} shapes, each also at a 2-byte offset "
        f"(streams {shapes[0][0] * shapes[0][2]}..{shapes[6][0] * shapes[6][2]}, C 1, 2, 3, 8, 17, 255 "
        f"and past the format's 255: 300 and {lms_decode_mod.MAX_CHANNELS}, the most a block's warps hold, "
        "frames off every tile, weights to 2^31)")
    return worst


def dequant_sweeps(rng):
    """Both dequant kernels against their plain versions: CBR over rs 1..8 x
    sfb 1,4,8 x C 1,2,3,8,255, VBR over random size tables 1..8, each with
    full and partial last windows; then both on VBR_EDGE_CASES (sff 1 and
    255, C up to 255, frames over many tiles, malformed tables on every
    other case: CBR scale factors past 2^sfb, VBR sizes 0, 9, 255 too) and on
    batches of one chunk fewer, as many and one more than a block of each
    kernel takes, and two blocks and one; returns (cbr worst, vbr worst)."""
    import torch

    from sea_codec_torch.ops import dequant
    from sea_codec_torch.ops.decode_ring import chunks_per_block

    def cbr_case(n, c, frames, sff, sfb, rs, malformed):
        res = rng.integers(0, 256, (n, -(-frames * c * rs // 8)), dtype=np.uint8)
        sf = rng.integers(0, 1 << sfb, (n, -(-frames // sff), c), dtype=np.uint8)
        if malformed:
            sf = malform_sf(rng, sf, sfb)
        cpu = [torch.from_numpy(a) for a in (res, sf)]
        kw = dict(sfb=sfb, rs=rs, sff=sff, frames=frames)
        got = dequant.unpack_dequant_cbr(*[t.cuda() for t in cpu], **kw)
        want = dequant.unpack_dequant_cbr_plain(*cpu, **kw)
        return worst_of([got], [want], f"dequant_cbr n={n} c={c} frames={frames} sff={sff} sfb={sfb} "
                                       f"rs={rs} malformed={malformed}")

    def vbr_case(n, c, frames, sff, sfb, malformed):
        res, sf, rs = random_vbr_batch(rng, n, c, sfb, frames, sff)[:3]
        if malformed:
            sf, rs = malform_vbr_tables(rng, sf, rs, sfb)
        cpu = [torch.from_numpy(a) for a in (res, sf, rs)]
        kw = dict(sfb=sfb, sff=sff, frames=frames)
        got = dequant.unpack_dequant_vbr(*[t.cuda() for t in cpu], **kw)
        want = dequant.unpack_dequant_vbr_plain(*cpu, **kw)
        return worst_of([got], [want], f"dequant_vbr n={n} c={c} frames={frames} sff={sff} sfb={sfb} "
                                       f"malformed={malformed}")

    geoms = ((200, 20), (197, 20), (61, 7), (40, 1))  # (frames, sff)
    worst_c = cases_c = 0
    for rs in range(1, 9):
        for sfb in (1, 4, 8):
            for c in (1, 2, 3, 8, 255):
                frames, sff = geoms[cases_c % 4]
                worst_c = max(worst_c, cbr_case(3, c, frames, sff, sfb, rs, False))
                cases_c += 1
    worst_v = cases_v = 0
    for sfb in (1, 4, 8):
        for c in (1, 2, 3, 8, 255):
            for frames, sff in geoms:
                worst_v = max(worst_v, vbr_case(3, c, frames, sff, sfb, False))
                cases_v += 1
    edges = [(n, c, frames, sff, (1, 4, 8)[i % 3], i % 2 == 1)
             for i, (n, c, frames, sff) in enumerate(VBR_EDGE_CASES)]
    for i, (n, c, frames, sff, sfb, malformed) in enumerate(edges):
        worst_c = max(worst_c, cbr_case(n, c, frames, sff, sfb, 1 + i % 8, malformed))
        worst_v = max(worst_v, vbr_case(n, c, frames, sff, sfb, malformed))
    # batches across the blocks' boundaries, each kernel its own chunks a block
    blocks = 0
    for c, frames, sff in ((1, 300, 20), (2, 530, 20), (3, 100, 7), (17, 70, 1)):
        for group, case in ((chunks_per_block(c), "cbr"), (dequant.vbr_chunks_per_block(c), "vbr")):
            for n in sorted({max(1, group - 1), group, group + 1, 2 * group + 1}):
                blocks += 1
                if case == "cbr":
                    worst_c = max(worst_c, cbr_case(n, c, frames, sff, 4, 3, blocks % 2 == 1))
                else:
                    worst_v = max(worst_v, vbr_case(n, c, frames, sff, 4, blocks % 2 == 1))
    torch.cuda.synchronize()
    log(f"[phase 2] CBR dequant == plain on {cases_c} configs (rs 1..8 x sfb 1,4,8 x C 1,2,3,8,255), "
        f"VBR dequant == plain on {cases_v} configs (sizes 1..8 per window x sfb 1,4,8 x C 1,2,3,8,255); "
        f"full and partial last windows; both on the {len(edges)} VBR edge cases (sff 1 and 255, C 1 to "
        f"255, 1 to 33 chunks, frames over many tiles, malformed tables on every other one) and on "
        f"{blocks} batches across the blocks' boundaries")
    return worst_c, worst_v


def dequant_kernels_exhaustive():
    """Both dequant kernels against the table build for every (sfb, rs, sf,
    code): one frame, one window, one (sf, code) per stream; the VBR kernel
    with each stream's own size."""
    import torch

    from sea_codec_torch.ops import bitpack, dequant, tables

    c = 255
    for sfb in range(1, 9):
        s = 1 << sfb
        items = [(rs, sf, q) for rs in range(1, 9) for sf in range(s) for q in range(1 << rs)]
        for rs in range(1, 9):
            mine = [(sf, q) for r, sf, q in items if r == rs]
            mine += [(0, 0)] * (-len(mine) % c)
            sf_a, q_a = (np.asarray(v).reshape(-1, c) for v in zip(*mine))
            res = np.stack([bitpack.pack_bits(row, rs) for row in q_a])
            got = dequant.unpack_dequant_cbr(
                torch.from_numpy(res).cuda(), torch.from_numpy(sf_a.astype(np.uint8)[:, None]).cuda(),
                sfb=sfb, rs=rs, sff=1, frames=1).cpu().numpy()
            check(np.array_equal(got[0], tables.dqt(rs, sfb)[sf_a, q_a]),
                  f"dequant_cbr sfb={sfb} rs={rs} != tables.dqt")
        items += [(1, 0, 0)] * (-len(items) % c)
        rs_a, sf_a, q_a = (np.asarray(v).reshape(-1, c) for v in zip(*items))
        rows = [bitpack.pack_bits(q, r) for q, r in zip(q_a, rs_a)]
        res = np.zeros((rs_a.shape[0], max(len(r) for r in rows)), np.uint8)
        for i, r in enumerate(rows):
            res[i, : len(r)] = r
        got = dequant.unpack_dequant_vbr(
            *(torch.from_numpy(a).cuda() for a in (res, sf_a.astype(np.uint8)[:, None], rs_a.astype(np.uint8)[:, None])),
            sfb=sfb, sff=1, frames=1).cpu().numpy()
        want = np.array([tables.dqt(r, sfb)[f, q] for r, f, q in zip(rs_a.ravel(), sf_a.ravel(), q_a.ravel())])
        check(np.array_equal(got.reshape(-1), want), f"dequant_vbr sfb={sfb} != tables.dqt")
    log("[phase 2] CBR and VBR dequant kernels == tables.dqt for every (sfb, rs, sf, code)")


def oversize_rows(rng):
    """Rows longer than a block's shared memory (255 channels x 1,000 frames
    x 8 bits = 255,000 bytes), CBR and VBR: the fused kernels stream a row
    tile by tile, so the router sends them there by default; with the fused
    kernels off the two-kernel path decodes them. Both equal the plain
    version. Returns the worst differences {kernel: err}."""
    import torch

    from sea_codec_torch.ops import cuda_build, dequant, fused_decode, fused_decode_vbr, lms_decode
    from sea_codec_torch.ops.device_decode import decode_chunks_packed

    n, frames, c, sfb, sff = 2, 1000, 255, 4, 20
    w = frames // sff
    rs_v = np.where(rng.random((n, w, c)) < 0.05, 7, 8).astype(np.uint8)
    res = rng.integers(0, 256, (n, frames * c), dtype=np.uint8)
    check(res.shape[1] > cuda_build.SMEM_LIMIT, "the oversize case fits shared memory")
    check(fused_decode.fused_cbr_supported(sfb, c), "the fused CBR kernel refuses a long row")
    check(fused_decode_vbr.fused_vbr_supported(sfb, sff, c), "the fused VBR kernel refuses a long row")
    sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 20), 1 << 20, (n, c, 4)).astype(np.int32)
    counts = lambda: (fused_decode.launches, fused_decode_vbr.launches, dequant.cbr_launches,
                      dequant.vbr_launches, lms_decode.launches)
    errs = {}
    for mode, rs, rsz in (("cbr", None, 8), ("vbr", rs_v, 0)):
        cpu = [None if a is None else torch.from_numpy(a) for a in (res, sf, rs, hist, wts)]
        gpu = [None if t is None else t.cuda() for t in cpu]
        kw = dict(sfb=sfb, sff=sff, frames=frames, residual_size=rsz)
        want = decode_chunks_packed(*cpu, fused=False, **kw)
        fused_at, dequant_at = (0, 2) if mode == "cbr" else (1, 3)
        for fused, name, launched in ((True, f"fused_decode_{mode}", (fused_at,)),
                                      (False, f"dequant_{mode}", (dequant_at, 4))):
            before = counts()
            got = decode_chunks_packed(*gpu, fused=fused, **kw)
            torch.cuda.synchronize()
            after = counts()
            want_counts = tuple(b + (i in launched) for i, b in enumerate(before))
            check(after == want_counts, f"oversize {mode} rows fused={fused}: counts {before} -> {after}")
            errs[name] = max(errs.get(name, 0), worst_of([got], [want], f"oversize {mode} rows fused={fused}"))
            if not fused:
                errs["lms_decode"] = max(errs.get("lms_decode", 0), errs[name])
    log(f"[phase 2] CBR and VBR rows of up to {res.shape[1]} bytes (> {cuda_build.SMEM_LIMIT} of shared "
        "memory): decoded by the fused kernels (rows streamed by tile) and by the two-kernel path, "
        "all == plain")
    return errs


# ---------------------------------------------------------------------------
# phases 3-5
# ---------------------------------------------------------------------------


FIXTURES = ("cbr_stereo_b3", "cbr_8ch_b8", "cbr_mono_b1_ragged", "vbr_stereo_b25", "vbr_mono_b5_ragged")


def fixtures(here, rng):
    import io

    from sea_codec_torch import EncoderSettings, SeaDecoder, sea_decode, sea_encode
    from sea_codec_torch.batch import decode_range

    for name in FIXTURES:
        fx = np.load(os.path.join(here, "tests", "fixtures", name + ".npz"))
        st = EncoderSettings(
            scale_factor_bits=int(fx["sfb"]),
            scale_factor_frames=int(fx["sff"]),
            residual_bits=float(fx["rb"]),
            frames_per_chunk=int(fx["fpc"]),
            vbr=bool(fx["vbr"]),
        )
        enc = sea_encode(fx["input"], int(fx["sample_rate"]), int(fx["channels"]), st)
        check(enc == fx["encoded"].tobytes(), f"fixture {name}: encoded bytes differ")
        dec = sea_decode(fx["encoded"].tobytes())
        check(np.array_equal(dec.samples, fx["decoded"]), f"fixture {name}: PCM differs")
        # the sessions, a chunk at a time: the same bytes and the same PCM
        c, fpc = int(fx["channels"]), int(fx["fpc"])
        check(sea_encode(fx["input"], int(fx["sample_rate"]), c, st, engine="session") == enc,
              f"fixture {name}: session bytes != batch bytes")
        check(np.array_equal(sea_decode(enc, engine="session").samples, fx["decoded"]),
              f"fixture {name}: session PCM differs")
        pcm = fx["decoded"].reshape(-1, c)
        frames = pcm.shape[0]
        out = io.BytesIO()
        sess = SeaDecoder(io.BytesIO(enc), out)
        pos = sess.seek(min(fpc + fpc // 3, frames))
        while sess.decode_frame():
            pass
        check(np.array_equal(np.frombuffer(out.getvalue(), "<i2"), pcm[pos:].reshape(-1)),
              f"fixture {name}: PCM after seek differs")
        for start, count in ((fpc // 2, fpc // 4), (fpc - 3, fpc + 7), (frames - 5, 50), (0, frames)):
            check(np.array_equal(decode_range(enc, start, count), pcm[start : start + count].reshape(-1)),
                  f"fixture {name}: decode_range({start}, {count}) differs")
    # a tail-only 255-channel file at the default chunk length: its tail
    # chunk decodes at its own length (padded to a full chunk it would
    # exceed the kernels' shared memory)
    pcm = rng.integers(-20000, 20000, 300 * 255).astype(np.int16)
    for st in (EncoderSettings(), vbr_settings()):
        vbr = st.vbr
        enc = sea_encode(pcm, 44100, 255, st)
        check(enc == sea_encode(pcm, 44100, 255, st, device="cpu"),
              f"tail-only 255 ch vbr={vbr}: card encode != plain")
        check(np.array_equal(sea_decode(enc).samples, sea_decode(enc, device="cpu").samples),
              f"tail-only 255 ch vbr={vbr}: card decode != plain")
    log(f"[phase 3] fixtures {', '.join(FIXTURES)}: encode byte-equal, decode PCM-equal on the card, "
        "through the batch engine and through the sessions; SeaDecoder.seek and decode_range "
        "(inside chunks, across them, into the tail) PCM-equal; "
        "tail-only 255-channel CBR and VBR files equal to plain")


def music_signal(frames, seed):
    """Stereo int16: layered sines and squares with a slow envelope, a noise
    floor and a little clipping, the right channel delayed."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames, dtype=np.float64) / 44100.0
    mono = np.zeros(frames)
    for _ in range(6):
        f = rng.uniform(50.0, 12000.0)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.05, 0.5) * t + rng.uniform(0, 6.3))
        wave = np.sin(2 * np.pi * f * t)
        if rng.random() < 0.3:
            wave = np.sign(wave)
        mono += rng.uniform(0.05, 0.3) * env * wave
    mono += rng.normal(0.0, 0.01, frames)
    delay = 441
    right = np.concatenate([np.zeros(delay), mono[:-delay]])
    pcm = np.stack([mono, right], axis=1) * 32767.0
    return np.clip(pcm, -32768, 32767).astype(np.int16).reshape(-1)


def launch_counts():
    from sea_codec_torch.ops import dequant, fused_decode, fused_decode_vbr, lms_decode, window_search

    return {
        "fused_decode_cbr": fused_decode.launches,
        "fused_decode_vbr": fused_decode_vbr.launches,
        "window_search": window_search.launches,
        "window_search_ranks_only": window_search.ranks_only_launches,
        "lms_decode": lms_decode.launches,
        "dequant_cbr": dequant.cbr_launches,
        "dequant_vbr": dequant.vbr_launches,
    }


def reset_launch_counts():
    from sea_codec_torch.ops import dequant, fused_decode, fused_decode_vbr, lms_decode, window_search

    fused_decode.launches = fused_decode_vbr.launches = 0
    window_search.launches = window_search.ranks_only_launches = 0
    lms_decode.launches = dequant.cbr_launches = dequant.vbr_launches = 0


def path_launches(result, name):
    """A kernel's launches on every main path: (their sum, by path)."""
    by_path = {path: counts[name] for path, counts in result["launches"].items()}
    return sum(by_path.values()), by_path


MAIN_FRAMES, MAIN_CHANNELS, MAIN_RATE = 7_938_000, 2, 44100


def vbr_settings():
    """The VBR main path's settings: the defaults at a 2.5-bit target."""
    from sea_codec_torch import EncoderSettings

    return EncoderSettings(vbr=True, residual_bits=2.5)


def vbr_chunk_size(st, c):
    """A full VBR chunk's bytes: every full chunk carries the same size
    counts from interpolate_distribution, so the same residual bits."""
    from sea_codec_torch.models.vbr import interpolate_distribution, normalized_vbr_bitrate, vbr_base

    f, sff, sfb = st.frames_per_chunk, st.scale_factor_frames, st.scale_factor_bits
    target = normalized_vbr_bitrate(st.residual_bits, f, sfb, sff)
    base = vbr_base(target)
    items = f // sff * c
    m1, t0, p1, p2 = interpolate_distribution(items, target)
    sizes = np.clip([base - 1, base, base + 1, base + 2], 1, 8)
    bits = sff * int(np.dot([m1, t0, p1, p2], sizes))
    return 4 + 16 * c + (items * sfb + 7) // 8 + (items * 2 + 7) // 8 + (bits + 7) // 8


def main_path(result, pcm, label, st, chunk_size, must_launch):
    """``sea_encode`` then ``sea_decode`` of ``pcm`` on the card with the
    launch counts set to 0 just before and read just after; checked
    against the plain decode on the CPU."""
    import torch

    from sea_codec_torch import sea_decode, sea_encode
    from sea_codec_torch.batch import split_chunks

    frames, c, rate = MAIN_FRAMES, MAIN_CHANNELS, MAIN_RATE
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = sea_encode(pcm, rate, c, st)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec = sea_decode(enc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launch_counts()
    counts["window_search_full"] = counts["window_search"] - counts["window_search_ranks_only"]
    result["launches"][label] = counts
    for name in must_launch:
        check(counts[name] > 0, f"{label} main path never launched {name}")

    header, rect, tail = split_chunks(enc)
    check(
        (header.channels, header.sample_rate, header.total_frames, header.frames_per_chunk)
        == (c, rate, frames, 5120),
        f"header fields {header}",
    )
    check(rect.shape[0] == frames // 5120 and len(tail) > 0, f"expected {frames // 5120} full chunks and a tail")
    check(header.chunk_size == chunk_size, f"chunk_size {header.chunk_size} != {chunk_size}")
    check(dec.samples.shape == (frames * c,), f"decoded length {dec.samples.shape}")
    check(dec.sample_rate == rate and dec.channels == c, "decoded header")
    t3 = time.perf_counter()
    plain = sea_decode(enc, device="cpu")
    t4 = time.perf_counter()
    check(np.array_equal(dec.samples, plain.samples), f"{label}: card decode != plain CPU decode")
    err = (dec.samples.astype(np.float64) - pcm) / 32767.0
    rms = float(np.sqrt(np.mean(err * err)))
    psnr = -20.0 * np.log10(2.0 / rms)
    msamples = frames * c / 1e6
    log(
        f"[phase 4] {label} main path {frames} frames x {c} ch ({msamples} Msamples), "
        f"{len(enc)} bytes ({8 * len(enc) / (frames * c):.4f} bits/sample): "
        f"encode {t1 - t0:.4f} s ({msamples / (t1 - t0):.3f} Msamples/s), "
        f"decode {t2 - t1:.4f} s ({msamples / (t2 - t1):.3f} Msamples/s), "
        f"psnr {psnr:.3f} dB (-20*log10(2/rms), lower is better), "
        f"plain CPU decode {t4 - t3:.3f} s, equal; launches {counts}; card {result['card']}"
    )
    result["main"][label] = {
        "encode_s": t1 - t0, "decode_s": t2 - t1, "psnr_db": psnr,
        "bytes": len(enc), "plain_cpu_decode_s": t4 - t3,
    }
    return enc


CORPUS_RATE = 44100
# (channels, frames) of the corpus's distinct files and how often each is
# repeated, per mode: lengths that share no ragged tail length, a 3-channel
# group, and a tail-only 255-channel file (300 frames of a 5,120-frame
# chunk), whose group decodes at the full-chunk width (CBR: ~490 KB a row,
# more than a block's shared memory: the fused kernel streams it by tile)
CORPUS_FILES = (
    ((2, 2_901_337), 3), ((2, 2_757_911), 3), ((2, 3_014_020), 3), ((2, 2_840_561), 3),
    ((3, 1_766_003), 2), ((3, 1_693_450), 2),
    ((255, 300), 1),
)


def make_corpus(rng):
    """The corpus for ``decode_corpus``: each distinct file encoded once on
    the card, per mode, and listed as often as CORPUS_FILES says. Returns a
    dict: files, the index of each file's distinct blob (which), the
    distinct blobs with their (mode, channels, frames) (meta), their PCM
    and each one's ``sea_encode`` wall on the card, and the samples."""
    import torch

    from sea_codec_torch import EncoderSettings, sea_encode
    from sea_codec_torch.utils.signal import varied_signal

    t0 = time.perf_counter()
    blobs, meta, files, which, pcms, enc_s = [], [], [], [], [], []
    for mode, st in (("cbr", EncoderSettings()), ("vbr", vbr_settings())):
        for i, ((c, frames), repeat) in enumerate(CORPUS_FILES):
            if c == 255:
                pcm = rng.integers(-20000, 20000, frames * c).astype(np.int16)
            else:
                pcm = varied_signal(c, frames, seed=1000 + i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            blobs.append(sea_encode(pcm, CORPUS_RATE, c, st))
            torch.cuda.synchronize()
            enc_s.append(time.perf_counter() - t1)
            pcms.append(pcm)
            meta.append((mode, c, frames))
            files += [blobs[-1]] * repeat
            which += [len(blobs) - 1] * repeat
    torch.cuda.synchronize()
    samples = sum(meta[k][1] * meta[k][2] for k in which)
    check(len(files) >= 32 and samples >= 100e6, f"corpus of {len(files)} files, {samples} samples is too small")
    tails = {(meta[k][0], meta[k][1], meta[k][2] % 5120) for k in range(len(blobs))}
    check(len(tails) == len(blobs), "two distinct corpus files share a ragged tail length")
    log(f"[phase 4] corpus: {len(files)} files ({len(blobs)} distinct, encoded on the card in "
        f"{time.perf_counter() - t0:.2f} s), {samples / 1e6:.3f} Msamples, {sum(map(len, files))} bytes")
    return dict(files=files, which=which, blobs=blobs, meta=meta, pcms=pcms, enc_s=enc_s, samples=samples)


def corpus_path(result, corpus):
    """``decode_corpus`` at a real size, with the default routing and with
    the fused kernels off; every file's PCM equal to ``decode_sea``'s, and
    that equal to the plain decode on the CPU for a sample of files. Then
    one more run with ``PIPELINE_TIMES`` set, for its stage report."""
    import torch

    from sea_codec_torch import batch, sea_decode
    from sea_codec_torch.batch import decode_corpus
    from sea_codec_torch.utils.profiling import StageTimes

    files, which, blobs, meta, samples = (corpus[k] for k in ("files", "which", "blobs", "meta", "samples"))
    single = [sea_decode(b).samples for b in blobs]
    for k in (0, 4, 6, 7, 11, 13):  # a stereo, a 3-channel and the 255-channel file per mode
        check(np.array_equal(single[k], sea_decode(blobs[k], device="cpu").samples),
              f"corpus file {meta[k]}: decode_sea on the card != plain CPU decode")
    torch.cuda.synchronize()
    times = {}
    for label, env in (("corpus", None), ("corpus_two_kernel", "0")):
        if env is None:
            os.environ.pop("SEA_FUSED_PROLOG", None)
        else:
            os.environ["SEA_FUSED_PROLOG"] = env
        try:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = decode_corpus(files)
            torch.cuda.synchronize()
            times[label] = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            os.environ.pop("SEA_FUSED_PROLOG", None)
        result["launches"][label] = counts
        for fi, (out, k) in enumerate(zip(outs, which, strict=True)):
            check(out is not None and out.channels == meta[k][1] and out.sample_rate == CORPUS_RATE,
                  f"{label}: file {fi} header")
            check(np.array_equal(out.samples, single[k]), f"{label}: file {fi} {meta[k]} != decode_sea")
        if env == "0":
            for name in ("lms_decode", "dequant_cbr", "dequant_vbr"):
                check(counts[name] > 0, f"{label} never launched {name}")
            check(counts["fused_decode_cbr"] == 0 and counts["fused_decode_vbr"] == 0,
                  f"{label}: a fused kernel was launched with the fused kernels off: {counts}")
        else:
            # the fused kernels stream rows tile by tile, so they take every
            # group, the 255-channel ones too: no two-kernel launch at all
            check(counts["fused_decode_cbr"] > 0 and counts["fused_decode_vbr"] > 0,
                  f"{label}: the default routing never took a fused kernel: {counts}")
            for name in ("dequant_cbr", "dequant_vbr", "lms_decode"):
                check(counts[name] == 0,
                      f"{label}: a group left the fused kernels on the default routing: {counts}")
        log(f"[phase 4] decode_corpus, {'default routing' if env is None else 'SEA_FUSED_PROLOG=0 (two-kernel path)'}: "
            f"{len(files)} files, {samples / 1e6:.3f} Msamples in {times[label]:.4f} s "
            f"({samples / 1e6 / times[label]:.3f} Msamples/s), every file == decode_sea; "
            f"launches {counts}; card {result['card']}")
        result["main"][label] = {"decode_s": times[label], "msamples": samples / 1e6, "files": len(files)}
        del outs
    batch.PIPELINE_TIMES = StageTimes()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = decode_corpus(files)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        report = batch.PIPELINE_TIMES
    finally:
        batch.PIPELINE_TIMES = None
    check(all(np.array_equal(o.samples, single[k]) for o, k in zip(outs, which)), "attributed decode_corpus != decode_sea")
    log(f"[phase 4] decode_corpus stages, default routing, PIPELINE_TIMES set (uploads synchronized), "
        f"{wall:.4f} s; card {result['card']}:\n{report.report()}")
    result["main"]["corpus"]["stages"] = dict(report)
    result["main"]["corpus"]["stages_wall_s"] = wall


def bench_corpus(n, seed0):
    """bench.py's corpus shape: ``n`` varied stereo files of 7 to 8 chunks
    (35,841-40,960 frames at 5,120 a chunk), lengths and content from
    ``seed0`` on."""
    from sea_codec_torch.utils.signal import varied_signal

    lens = np.random.default_rng(seed0).integers(7 * 5120 + 1, 8 * 5120 + 1, size=n)
    return [varied_signal(2, int(n_fr), seed=seed0 + i) for i, n_fr in enumerate(lens)]


def expected_corpus_launches(frames, c, st):
    """Search launches of one ``encode_corpus`` call: one a lane group for
    CBR; for VBR two a chunk index up to the group's most full chunks, and
    two more where the group has a ragged tail."""
    from sea_codec_torch.batch import _lane_groups

    fpc = st.frames_per_chunk
    n = 0
    for g in _lane_groups(frames, c, fpc):
        fr = [frames[i] for i in g]
        if max(fr) == 0:
            continue
        n += 2 * (max(fr) // fpc) + 2 * any(f % fpc for f in fr) if st.vbr else 1
    return n


def vbr_loop_never_waits():
    """The corpus VBR loop over chunk index (``encode_file.corpus_vbr_nv``),
    like the file's, never waits for the card: run on 4 stereo lanes of 3
    chunks, one file a chunk short, under ``set_sync_debug_mode("error")``."""
    import torch

    from sea_codec_torch.models.vbr import interpolate_distribution, normalized_vbr_bitrate, vbr_base
    from sea_codec_torch.ops import lms
    from sea_codec_torch.ops.encode_file import corpus_vbr_nv

    st = vbr_settings()
    fpc, sff, sfb, c, nf = st.frames_per_chunk, st.scale_factor_frames, st.scale_factor_bits, 2, 4
    target = normalized_vbr_bitrate(st.residual_bits, fpc, sfb, sff)
    m1, _t, p1, p2 = interpolate_distribution(fpc * c // sff, target)
    x = torch.randint(-20000, 20000, (3, fpc, nf * c), dtype=torch.int16, device="cuda")
    frames = torch.tensor([3 * fpc] * 6 + [2 * fpc] * 2, dtype=torch.int32, device="cuda")
    init = (lms.initial_history(c, "cuda").repeat(nf, 1), lms.initial_weights(c, "cuda").repeat(nf, 1),
            torch.zeros(nf * c, dtype=torch.int32, device="cuda"))
    kw = dict(scale_factor_frames=sff, scale_factor_bits=sfb, base=vbr_base(target), dist=(m1, p1, p2), n_files=nf)
    corpus_vbr_nv(x, frames, *init, **kw)  # warm: the tables go to the card once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = corpus_vbr_nv(x, frames, *init, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the short file's lanes carry their state through the masked chunk
    check(torch.equal(out[5][6:], out[3][2, 6:]) and torch.equal(out[6][6:], out[4][2, 6:]),
          "corpus VBR loop: a masked chunk moved a lane's carry")
    log("[phase 4] the corpus VBR chunk loop ran without a host sync; a masked chunk left its lanes' carry")


def corpus_encode_path(result, corpus):
    """``encode_corpus`` on the card, both modes: (a) bench.py's corpus
    shape, 256 stereo files CBR and 64 VBR, against per-file ``sea_encode``
    on the card; (b) the decode corpus, one call per channel count
    (repeats included), against the blobs ``make_corpus`` encoded per file.
    Bytes equal; the search launched lane-packed (its count per call as
    ``expected_corpus_launches`` says); the wall beside the summed per-file
    walls, with ``PIPELINE_TIMES`` set (one lane group a call here, so the
    synchronized upload costs no overlap)."""
    import torch

    from sea_codec_torch import EncoderSettings, batch, sea_encode
    from sea_codec_torch.utils.profiling import StageTimes

    def run_corpus(label, st, calls, per_file_s):
        """``calls``: [(channels, files, expected bytes)]."""
        reset_launch_counts()
        batch.PIPELINE_TIMES = StageTimes()
        walls, want_launches = [], 0
        try:
            for c, files, wants in calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = batch.encode_corpus(files, CORPUS_RATE, c, st)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                want_launches += expected_corpus_launches([f.shape[0] // c for f in files], c, st)
                for fi, (o, w) in enumerate(zip(outs, wants, strict=True)):
                    check(o == w, f"{label}: file {fi} ({c} ch) != per-file sea_encode")
            report = batch.PIPELINE_TIMES
        finally:
            batch.PIPELINE_TIMES = None
        counts = launch_counts()
        result["launches"][label] = counts
        check(counts["window_search"] == want_launches,
              f"{label}: {counts['window_search']} search launches, lane-packed needs {want_launches}")
        samples = sum(f.size for _c, files, _w in calls for f in files)
        wall = sum(walls)
        log(f"[phase 4] encode_corpus {label}: {sum(len(f) for _c, f, _w in calls)} files, "
            f"{samples / 1e6:.3f} Msamples in {wall:.4f} s ({samples / 1e6 / wall:.3f} Msamples/s; "
            f"by call {[round(t, 4) for t in walls]}), bytes == per-file sea_encode, whose walls sum to "
            f"{per_file_s:.4f} s; launches {counts} (lane-packed: {want_launches}); card {result['card']}; "
            f"stages:\n{report.report()}")
        result["main"][label] = {"encode_s": wall, "by_call_s": walls, "per_file_s": per_file_s,
                                 "msamples": samples / 1e6, "stages": dict(report)}

    vbr_loop_never_waits()
    bench = {}
    for mode, st, n, seed0 in (("cbr", EncoderSettings(), 256, 0), ("vbr", vbr_settings(), 64, 50_000)):
        files = bench_corpus(n, seed0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wants = [sea_encode(f, CORPUS_RATE, 2, st) for f in files]
        torch.cuda.synchronize()
        run_corpus(f"corpus_encode_{mode}_a", st, [(2, files, wants)], time.perf_counter() - t0)
        bench[mode] = (st, files, wants)
    for mode, st in (("cbr", EncoderSettings()), ("vbr", vbr_settings())):
        calls, per_file_s = [], 0.0
        for c in (2, 3, 255):
            ks = [k for k in corpus["which"] if corpus["meta"][k][:2] == (mode, c)]
            calls.append((c, [corpus["pcms"][k] for k in ks], [corpus["blobs"][k] for k in ks]))
            per_file_s += sum(corpus["enc_s"][k] for k in ks)
        run_corpus(f"corpus_encode_{mode}_b", st, calls, per_file_s)
    return bench


def transcode_path(result, enc, enc_vbr):
    """The main-path files' full-chunk rows, [1550, chunk_size] on the card,
    decoded without leaving it (``parse_device``): PCM equal to
    ``decode_sea``'s, and no wait for the card (so no device-to-host copy)
    before the result (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch

    from sea_codec_torch import sea_decode
    from sea_codec_torch.batch import split_chunks
    from sea_codec_torch.ops.parse_device import decode_rows_vbr_device, transcode_chunks_cbr_device

    for label, blob, fn in (("transcode_cbr", enc, transcode_chunks_cbr_device),
                            ("transcode_vbr", enc_vbr, decode_rows_vbr_device)):
        header, rect, _tail = split_chunks(blob)
        n, fpc, c = rect.shape[0], header.frames_per_chunk, header.channels
        want = sea_decode(blob).samples[: n * fpc * c].reshape(n, fpc, c)
        rows = torch.from_numpy(rect.copy()).cuda()
        args = (rows, c, int(rect[0, 1]) >> 4, int(rect[0, 2]), int(rect[0, 1]) & 15, fpc)
        fn(*args)  # warm: the tables go to the card once
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        result["launches"][label] = counts
        check(np.array_equal(out.cpu().numpy(), want), f"{label}: PCM != decode_sea")
        log(f"[phase 4] {label}: rows {list(rect.shape)} -> PCM {[n, fpc, c]} on the card in {wall * 1e3:.3f} ms, "
            f"== decode_sea, no host sync before the result; launches {counts}; card {result['card']}")
        result["main"][label] = {"s": wall}


SESSION_FRAMES = 100 * 5120 + 1777


def session_path(result):
    """One stereo file per mode through ``SeaEncoder`` then ``SeaDecoder``,
    a chunk per call, on the card: bytes equal to the batch engine's, PCM
    equal to the batch engine's decode."""
    import io

    import torch

    from sea_codec_torch import EncoderSettings, SeaDecoder, SeaEncoder, sea_decode, sea_encode

    c, frames = MAIN_CHANNELS, SESSION_FRAMES
    pcm = music_signal(frames, seed=77)
    chunks = -(-frames // 5120)
    for label, st in (("session_cbr", EncoderSettings()), ("session_vbr", vbr_settings())):
        want = sea_encode(pcm, MAIN_RATE, c, st)
        want_pcm = sea_decode(want).samples
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wire = io.BytesIO()
        enc = SeaEncoder(c, MAIN_RATE, frames, st, io.BytesIO(pcm.astype("<i2").tobytes()), wire)
        while enc.encode_frame():
            pass
        enc.finalize()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = io.BytesIO()
        dec = SeaDecoder(io.BytesIO(wire.getvalue()), out)
        while dec.decode_frame():
            pass
        dec.finalize()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = launch_counts()
        result["launches"][label] = counts
        check(wire.getvalue() == want, f"{label}: session bytes != batch engine bytes")
        check(np.array_equal(np.frombuffer(out.getvalue(), "<i2"), want_pcm), f"{label}: session PCM != batch decode")
        per_chunk = 2 if st.vbr else 1
        check(counts["window_search"] == per_chunk * chunks,
              f"{label}: {counts['window_search']} search launches for {chunks} chunks")
        decode_name = "fused_decode_vbr" if st.vbr else "fused_decode_cbr"
        check(counts[decode_name] == chunks, f"{label}: {counts[decode_name]} decode launches for {chunks} chunks")
        msamples = frames * c / 1e6
        log(f"[phase 4] {label}: {chunks} chunks ({msamples} Msamples) a chunk per call: "
            f"encode {t1 - t0:.4f} s ({msamples / (t1 - t0):.3f} Msamples/s), "
            f"decode {t2 - t1:.4f} s ({msamples / (t2 - t1):.3f} Msamples/s), bytes == batch engine, "
            f"PCM == batch decode; launches {counts}; card {result['card']}")
        result["main"][label] = {"encode_s": t1 - t0, "decode_s": t2 - t1, "chunks": chunks}


def decode_at_main_shape(enc, result):
    """The decode kernel on the main path's full chunks: equal to its plain
    version, and its time beside the plain version's."""
    import torch

    from sea_codec_torch.batch import parse_full_chunks, split_chunks
    from sea_codec_torch.ops.fused_decode import decode_cbr_fused, decode_cbr_plain

    header, rect, _tail = split_chunks(enc)
    b = parse_full_chunks(rect, header)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (b.res_bytes, b.sf, b.hist, b.wts)]
    kw = dict(sfb=b.scale_factor_bits, rs=b.residual_size, sff=b.scale_factor_frames,
              frames=header.frames_per_chunk)
    n, _w, c = b.sf.shape
    f = header.frames_per_chunk
    ms, got = cuda_ms(lambda: decode_cbr_fused(*args, **kw), reps=20)
    one_ms, _ = cuda_ms(lambda: decode_cbr_fused(*(a[:1] for a in args), **kw), reps=20)
    plain_ms, want = cuda_ms(lambda: decode_cbr_plain(*args, **kw), reps=1)
    err = worst_of([got], [want], "decode at the main-path shape")
    log(f"[phase 5] decode kernel == plain at {[n, f, c]}: kernel {ms:.4f} ms (one chunk alone "
        f"{one_ms:.4f} ms), plain {plain_ms:.1f} ms")
    return err, {
        "name": "fused_decode_cbr", "route": "cuda",
        "source": "sea_codec_torch/csrc/fused_decode_cbr.cu",
        "replaces": "sea_codec_tpu/ops/pallas_fused_decode.py:130",
        "launches": path_launches(result, "fused_decode_cbr")[0],
        "launches_by_path": path_launches(result, "fused_decode_cbr")[1],
        "ms": ms, "ms_one_chunk": one_ms, "plain_ms": plain_ms, "shape": [n, f, c],
        "bytes": b.res_bytes.nbytes + b.sf.nbytes + 2 * b.hist.size * 4 + n * f * c * 2,
        "ops": decode_ops(b, f),
        # every stream is independent and all are resident at once
        "chain_cycles": f * chain_cycles(DECODE_FRAME_CHAIN),
    }


def search_at_main_shape(pcm, enc, result):
    """The search kernel at the main path's shapes, held three ways: its run
    over all full chunks gives the scale factors, codes and chunk-entry
    states the main path wrote; on the first two chunks (one chunk boundary)
    and on the ragged tail from the carried state, every output equals the
    plain version's."""
    import torch

    from sea_codec_torch import EncoderSettings
    from sea_codec_torch.batch import parse_full_chunks, split_chunks
    from sea_codec_torch.container import SeaChunk
    from sea_codec_torch.ops import bitpack, lms
    from sea_codec_torch.ops.window_search import window_search, window_search_plain

    header, rect, tail = split_chunks(enc)
    b = parse_full_chunks(rect, header)
    nc, f, c = rect.shape[0], header.frames_per_chunk, header.channels
    es = EncoderSettings()
    sfb, sff, rs = es.scale_factor_bits, es.scale_factor_frames, int(es.residual_bits)
    wpc = f // sff
    skw = dict(sfb=sfb, rs=rs, sff=sff, wpc=wpc)
    x = torch.from_numpy(pcm[: nc * f * c].reshape(nc * f, c)).cuda()
    init = (lms.initial_history(c, "cuda"), lms.initial_weights(c, "cuda"),
            torch.zeros(c, dtype=torch.int32, device="cuda"))

    ms, full = cuda_ms(lambda: window_search(x, None, *init, **skw), reps=2)
    sf, codes, _ranks, ehist, ewts = (t.cpu().numpy() for t in full[:5])
    i16 = lambda a: a.astype(np.int16).astype(np.int32)  # the chunk header's width
    check(np.array_equal(sf.reshape(nc, wpc, c), b.sf), "search: scale factors != main-path file")
    check(np.array_equal(i16(ehist), b.hist) and np.array_equal(i16(ewts), b.wts),
          "search: chunk-entry LMS states != main-path file")
    check(np.array_equal(codes.reshape(nc, f * c), bitpack.unpack_bits_rows(b.res_bytes, rs, f * c)),
          "search: codes != main-path file")

    prefix = x[: 2 * f]
    prefix_ms, got = cuda_ms(lambda: window_search(prefix, None, *init, **skw), reps=3)
    plain_ms, want = cuda_ms(lambda: window_search_plain(prefix, None, *init, **skw), reps=1)
    worst = worst_of(got, want, "search on the first two main-path chunks")

    tail_frames = header.total_frames - nc * f
    xt, nv = tail_windows(pcm[nc * f * c :].reshape(tail_frames, c), sff)
    tkw = dict(skw, wpc=nv.numel())
    got_t = window_search(xt.cuda(), nv.cuda(), *full[5:], **tkw)
    want_t = window_search_plain(xt.cuda(), nv.cuda(), *full[5:], **tkw)
    worst = max(worst, worst_of(got_t, want_t, "search on the main-path tail"))
    chunk = SeaChunk.from_bytes(tail, header, tail_frames)
    check(np.array_equal(got_t[0].cpu().numpy().reshape(-1), chunk.scale_factors)
          and np.array_equal(got_t[1][:tail_frames].cpu().numpy().reshape(-1), chunk.residuals)
          and np.array_equal(i16(full[5].cpu().numpy()), chunk.lms_history),
          "search: tail chunk != main-path file")
    log(f"[phase 5] search kernel == main-path file over {[nc * f, c]} ({ms:.3f} ms); "
        f"== plain on two chunks {[2 * f, c]} (kernel {prefix_ms:.3f} ms, plain {plain_ms:.1f} ms) "
        f"and on the {tail_frames}-frame tail ({nv.numel()} masked windows)")
    s = 1 << sfb
    nw = nc * wpc
    return worst, {
        "name": "window_search", "route": "cuda",
        "source": "sea_codec_torch/csrc/window_search.cu",
        "replaces": "sea_codec_tpu/ops/pallas_encode.py:491",
        "launches": path_launches(result, "window_search")[0],
        "launches_by_path": path_launches(result, "window_search")[1],
        "ms": ms, "plain_ms": plain_ms, "ms_plain_shape": prefix_ms,
        "plain_shape": [2 * f, c], "shape": [nc * f, c],
        "bytes": x.numel() * 2 + x.numel() + nw * c * (1 + 8) + 2 * nc * c * 16,
        "ops": tuple(x.numel() * s * k for k in SEARCH_OPS_PER_STEP),
        # one block per channel, all resident: one channel's chain
        "chain_cycles": nc * f * chain_cycles(SEARCH_STEP_CHAIN)
        + nw * chain_cycles(SEARCH_WINDOW_CHAIN),
        "chain_cycles_before": nc * f * chain_cycles(SEARCH_STEP_CHAIN_BEFORE)
        + nw * chain_cycles(SEARCH_WINDOW_CHAIN_BEFORE),
    }


def vbr_decode_at_main_shape(enc, result):
    """The VBR decode kernel on the VBR main path's full chunks: equal to
    its plain version, and its time beside the plain version's."""
    import torch

    from sea_codec_torch.batch import parse_full_chunks, split_chunks
    from sea_codec_torch.ops.fused_decode_vbr import decode_vbr_fused, decode_vbr_plain

    header, rect, _tail = split_chunks(enc)
    b = parse_full_chunks(rect, header)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (b.res_bytes, b.sf, b.rs, b.hist, b.wts)]
    f = header.frames_per_chunk
    kw = dict(sfb=b.scale_factor_bits, sff=b.scale_factor_frames, frames=f)
    n, w, c = b.sf.shape
    ms, got = cuda_ms(lambda: decode_vbr_fused(*args, **kw), reps=20)
    one_ms, _ = cuda_ms(lambda: decode_vbr_fused(*(a[:1] for a in args), **kw), reps=20)
    plain_ms, want = cuda_ms(lambda: decode_vbr_plain(*args, **kw), reps=1)
    err = worst_of([got], [want], "VBR decode at the main-path shape")
    log(f"[phase 5] VBR decode kernel == plain at {[n, f, c]}: kernel {ms:.4f} ms (one chunk alone "
        f"{one_ms:.4f} ms), plain {plain_ms:.1f} ms")
    return err, {
        "name": "fused_decode_vbr", "route": "cuda",
        "source": "sea_codec_torch/csrc/fused_decode_vbr.cu",
        "replaces": "sea_codec_tpu/ops/pallas_fused_decode.py:419",
        "launches": path_launches(result, "fused_decode_vbr")[0],
        "launches_by_path": path_launches(result, "fused_decode_vbr")[1],
        "ms": ms, "ms_one_chunk": one_ms, "plain_ms": plain_ms, "shape": [n, f, c],
        "bytes": b.res_bytes.nbytes + b.sf.nbytes + b.rs.nbytes + 2 * b.hist.size * 4 + n * f * c * 2,
        "ops": decode_ops(b, f),
        "chain_cycles": f * chain_cycles(DECODE_FRAME_CHAIN),
    }


def vbr_search_at_main_shape(pcm, enc, result, clock_mhz):
    """The search in its VBR forms at the VBR main path's shapes: the
    two-pass file encode on the card reproduces the file's scale factors,
    sizes, codes and chunk states, and packed on the host its bytes; on the
    first two chunks it equals the plain version on the CPU, and so does
    the tail chunk's encode from the carried state. Prints each pass's
    kernel time on one chunk and the host pack's time."""
    import torch

    from sea_codec_torch.batch import parse_full_chunks, serialize_full_chunks, split_chunks
    from sea_codec_torch.container import SeaChunk
    from sea_codec_torch.models.common import EncoderBaseState
    from sea_codec_torch.models.vbr import (
        VbrEncoderModel, chunk_residual_size, interpolate_distribution, normalized_vbr_bitrate, vbr_base,
    )
    from sea_codec_torch.ops import lms
    from sea_codec_torch.ops.device_decode import unpack_var
    from sea_codec_torch.ops.encode_file import encode_file_vbr
    from sea_codec_torch.ops.window_search import window_search

    header, rect, tail = split_chunks(enc)
    b = parse_full_chunks(rect, header)
    nc, f, c = rect.shape[0], header.frames_per_chunk, header.channels
    st = vbr_settings()
    sfb, sff, wpc = st.scale_factor_bits, st.scale_factor_frames, f // st.scale_factor_frames
    target = normalized_vbr_bitrate(st.residual_bits, f, sfb, sff)
    base = vbr_base(target)
    m1, _t, p1, p2 = interpolate_distribution(f * c // sff, target)
    fkw = dict(scale_factor_frames=sff, scale_factor_bits=sfb, base=base, dist=(m1, p1, p2))
    x = torch.from_numpy(pcm[: nc * f * c].reshape(nc, f, c)).cuda()
    init = (lms.initial_history(c, "cuda"), lms.initial_weights(c, "cuda"),
            torch.zeros(c, dtype=torch.int32, device="cuda"))

    file_ms, out = cuda_ms(lambda: encode_file_vbr(x, *init, **fkw), reps=1)
    sf, codes, sizes, ehist, ewts = (t.cpu().numpy() for t in out[:5])
    i16 = lambda a: a.astype(np.int16).astype(np.int32)  # the chunk header's width
    check(np.array_equal(sf, b.sf) and np.array_equal(sizes, b.rs), "VBR search: sf/sizes != main-path file")
    check(np.array_equal(i16(ehist), b.hist) and np.array_equal(i16(ewts), b.wts),
          "VBR search: chunk-entry LMS states != main-path file")
    want_codes = unpack_var(torch.from_numpy(b.res_bytes), torch.from_numpy(b.rs), sff, f).numpy()
    check(np.array_equal(codes, want_codes), "VBR search: codes != main-path file")
    t0 = time.perf_counter()
    rows = serialize_full_chunks(sf, codes, sizes, ehist, ewts, sfb, sff,
                                 chunk_residual_size(st.residual_bits, target))
    pack_s = time.perf_counter() - t0
    check(np.array_equal(rows, rect), "VBR host pack != main-path file")
    log(f"[phase 5] VBR host pack (serialize_full_chunks, numpy) of {nc} chunks x {f * c} codes: "
        f"{pack_s * 1e3:.1f} ms, == main-path file")

    skw = dict(sfb=sfb, sff=sff, wpc=wpc)
    x0 = x[0]
    p1_ms, r1 = cuda_ms(lambda: window_search(x0, None, *init, rs=base + 1, ranks_only=True, **skw), reps=10)
    full1_ms, _ = cuda_ms(lambda: window_search(x0, None, *init, rs=base + 1, **skw), reps=10)
    rs0 = torch.from_numpy(sizes[0]).cuda()
    p2_ms, _ = cuda_ms(lambda: window_search(x0, None, init[0], init[1], r1[7], rs=rs0, **skw), reps=10)

    cpu_init = tuple(t.cpu() for t in init)
    t0 = time.perf_counter()
    want = encode_file_vbr(x[:2].cpu(), *cpu_init, **fkw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the chunk loop must never wait for the card
    try:
        got = encode_file_vbr(x[:2], *init, **fkw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    worst = worst_of(got, want, "VBR search on the first two main-path chunks")

    tail_frames = header.total_frames - nc * f
    tail_pcm = pcm[nc * f * c :]
    state = lambda dev: EncoderBaseState(*(t.to(dev) for t in out[5:]))
    enc_t = VbrEncoderModel(c, sfb, sff, st.residual_bits, f, state("cuda")).encode(tail_pcm)
    want_t = VbrEncoderModel(c, sfb, sff, st.residual_bits, f, state("cpu")).encode(tail_pcm)
    chunk = SeaChunk.from_bytes(tail, header, tail_frames)
    for got_a, want_a, file_a in zip(
        (enc_t.scale_factors, enc_t.residuals, enc_t.residual_bits),
        (want_t.scale_factors, want_t.residuals, want_t.residual_bits),
        (chunk.scale_factors, chunk.residuals, chunk.vbr_residual_sizes),
    ):
        check(np.array_equal(got_a, want_a) and np.array_equal(got_a, file_a),
              "VBR tail chunk: card != plain or != main-path file")
    log(f"[phase 5] VBR search == main-path file over {nc} chunks ({2 * nc} launches, {file_ms:.3f} ms); "
        f"per chunk {[f, c]}: pass 1 ranks-only {p1_ms:.4f} ms (full form {full1_ms:.4f} ms), "
        f"pass 2 per-window sizes {p2_ms:.4f} ms; == plain on two chunks (plain {plain_ms:.1f} ms; "
        "the chunk loop ran without a host sync) "
        f"and on the {tail_frames}-frame tail")
    s = 1 << sfb
    k = {
        # both passes read the samples; pass 2 writes the codes
        "bytes": 2 * x.numel() * 2 + x.numel() + 2 * nc * wpc * c * (1 + 8) + nc * wpc * c + 2 * nc * c * 16,
        "ops": tuple(2 * x.numel() * s * n_ops for n_ops in SEARCH_OPS_PER_STEP),
        "chain_cycles": 2 * (nc * f * chain_cycles(SEARCH_STEP_CHAIN) + nc * wpc * chain_cycles(SEARCH_WINDOW_CHAIN)),
    }
    bounds(k, clock_mhz)
    log(f"[phase 5] window_search, VBR file: {file_ms:.3f} ms; bound {k['bound_ms']:.4f} ms "
        f"(by {k['bound_by']}); chain {k['chain_ms']:.4f} ms at {clock_mhz} MHz "
        f"({k['chain_ms'] / (2 * nc):.4f} ms per chunk launch)")
    return worst, {
        "file_ms": file_ms, "launches": 2 * nc, "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "chain_ms": k["chain_ms"], "least_ms": k["least_ms"], "pass1_ranks_only_ms_per_chunk": p1_ms,
        "pass1_full_form_ms_per_chunk": full1_ms, "pass2_ms_per_chunk": p2_ms,
        "plain_ms_two_chunks": plain_ms, "host_pack_ms": pack_s * 1e3,
    }


def search_occupancy():
    """Blocks of each search form the corpus encode launches that one SM
    holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at the default
    settings and the VBR main path's sizes (base 2: pass 1 at 3, pass 2
    over 1..4), and the per-window form with every size's rows staged."""
    import ctypes

    from sea_codec_torch.ops import cuda_build, tables
    from sea_codec_torch.ops.window_search import _table_rows

    fn = cuda_build.load("window_search").sea_window_search_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    s, sff = 16, 20
    out = {}
    for name, var_rs, ranks_only, rng_ in (("cbr rs 3", 0, 0, (3, 3)), ("ranks-only rs 3", 0, 1, (3, 3)),
                                          ("per-window 1..4", 1, 0, (1, 4)), ("per-window 1..8", 1, 0, (1, 8))):
        rows = _table_rows(s, sff, bool(ranks_only), rng_)
        out[name] = fn(var_rs, int(rows > 0), s, sff, ranks_only, tables.QUANT_TAB_SIZE, rows)
        check(out[name] > 0, f"occupancy query failed for {name}")
    return out


def search_lane_times(result):
    """The per-window-size form at 132, 264 and 528 lanes of one chunk
    (256 windows of 20 frames, sfb 4, sizes 1..4) with every size's table
    rows staged (the parent's launch) and with only 1..4's, in turns
    (all, staged, staged, all); outputs equal."""
    import torch

    from sea_codec_torch.ops.window_search import window_search

    rng = np.random.default_rng(132)
    times = {}
    for lanes in (132, 264, 528):
        x = torch.from_numpy(stress_signal(rng, 5120, lanes)).cuda()
        sizes = torch.from_numpy(rng.integers(1, 5, (256, lanes)).astype(np.uint8)).cuda()
        init = (torch.zeros((lanes, 4), dtype=torch.int32, device="cuda"),
                torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, (lanes, 4)).astype(np.int32)).cuda(),
                torch.zeros(lanes, dtype=torch.int32, device="cuda"))
        kw = dict(sfb=4, sff=20, wpc=256, rs=sizes)
        run = lambda r: window_search(x, None, *init, rs_range=r, **kw)
        got = {}
        ms = {"all": [], "staged": []}
        for label, r in (("all", (1, 8)), ("staged", (1, 4)), ("staged", (1, 4)), ("all", (1, 8))):
            t, got[label] = cuda_ms(lambda: run(r), reps=5)
            ms[label].append(t)
        worst_of(got["staged"], got["all"], f"per-window form at {lanes} lanes: staged rows != all rows")
        times[lanes] = ms
    occ = search_occupancy()
    log(f"[phase 5] window_search per-window form, one chunk [5120, lanes] at sfb 4, ms in turns "
        f"(all rows staged / 1..4 staged): {times}; blocks an SM holds: {occ}; card {result['card']}")
    return {"lane_sweep_ms": times, "blocks_per_sm": occ}


def two_kernel_at_main_shape(enc, enc_vbr, result, here):
    """The two-kernel decode's kernels on the main paths' full chunks
    [1550, 5120, 2]: each equal to its plain version, with its time (and one
    chunk's); each dequant call one CUDA kernel, by the profiler; and the
    path's total (dequant, then the recurrence) beside the fused kernel's
    time on the same chunks, taken in turns (fused, two-kernel, two-kernel,
    fused)."""
    import torch

    from sea_codec_torch.batch import parse_full_chunks, split_chunks
    from sea_codec_torch.ops import dequant
    from sea_codec_torch.ops.device_decode import decode_chunks_packed
    from sea_codec_torch.ops.lms_decode import lms_decode, lms_decode_plain

    out = []
    for mode, blob in (("cbr", enc), ("vbr", enc_vbr)):
        header, rect, _tail = split_chunks(blob)
        b = parse_full_chunks(rect, header)
        f = header.frames_per_chunk
        n, w, c = b.sf.shape
        res, sf, rs, hist, wts = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in b.arrays)
        kw = dict(sfb=b.scale_factor_bits, sff=b.scale_factor_frames, frames=f)
        if mode == "cbr":
            wrap = lambda k: dequant.unpack_dequant_cbr(res[:k], sf[:k], rs=b.residual_size, **kw)
            plain = lambda: dequant.unpack_dequant_cbr_plain(res, sf, rs=b.residual_size, **kw)
            nbytes = b.res_bytes.nbytes + b.sf.nbytes
        else:
            wrap = lambda k: dequant.unpack_dequant_vbr(res[:k], sf[:k], rs[:k], **kw)
            plain = lambda: dequant.unpack_dequant_vbr_plain(res, sf, rs, **kw)
            # the function's work: the rows and both tables in, dq out
            nbytes = b.res_bytes.nbytes + b.sf.nbytes + b.rs.nbytes
        ops = unpack_dequant_ops(b, f)
        ms, dq = cuda_ms(lambda: wrap(n), reps=20)
        one_ms, _ = cuda_ms(lambda: wrap(1), reps=20)
        plain_ms, want = cuda_ms(plain, reps=1)
        err = worst_of([dq], [want], f"{mode} dequant at the main-path shape")
        recorded = kernels_recorded(lambda: wrap(n), here)
        check(len(recorded) == 1 and f"dequant_{mode}_kernel" in recorded[0][0],
              f"one unpack_dequant_{mode} call recorded the CUDA kernels {recorded}")
        device_ms = recorded[0][1] / 1e3
        one = kernels_recorded(lambda: wrap(1), here)
        check(len(one) == 1, f"one unpack_dequant_{mode} call on one chunk recorded the CUDA kernels {one}")
        one_device_ms = one[0][1] / 1e3
        log(f"[phase 5] {mode} dequant kernel == plain at {[n, f, c]}: the call {ms:.4f} ms by events over 20 "
            f"(one chunk alone {one_ms:.4f} ms), its kernel {device_ms:.4f} ms on the card by the profiler "
            f"(one chunk {one_device_ms:.4f} ms), plain {plain_ms:.1f} ms; one call records one CUDA kernel "
            f"({recorded[0][0][:60]})")
        out.append((err, {
            "name": f"dequant_{mode}", "route": "cuda",
            "source": f"sea_codec_torch/csrc/dequant_{mode}.cu",
            "replaces": "sea_codec_tpu/ops/pallas_dequant.py:" + ("108" if mode == "cbr" else "322"),
            "launches": path_launches(result, f"dequant_{mode}")[0],
            "launches_by_path": path_launches(result, f"dequant_{mode}")[1],
            "ms": ms, "ms_one_chunk": one_ms, "device_ms": device_ms, "device_ms_one_chunk": one_device_ms,
            "plain_ms": plain_ms, "shape": [n, f, c],
            "bytes": nbytes + n * f * c * 2,
            "ops": ops,
            "chain_cycles": 0,  # no sample depends on another
        }))
        lms_ms, pcm = cuda_ms(lambda: lms_decode(dq, hist, wts), reps=20)
        dq1 = dq[:, :1].contiguous()
        lms_one_ms, _ = cuda_ms(lambda: lms_decode(dq1, hist[:1], wts[:1]), reps=20)
        lms_plain_ms, want_pcm = cuda_ms(lambda: lms_decode_plain(dq, hist, wts), reps=1)
        err = worst_of([pcm], [want_pcm], f"LMS recurrence at the main-path shape, {mode} dq")
        log(f"[phase 5] LMS recurrence kernel == plain at {[n, f, c]} on the {mode} dq stream: kernel "
            f"{lms_ms:.4f} ms (one chunk alone {lms_one_ms:.4f} ms), plain {lms_plain_ms:.1f} ms")
        if mode == "cbr":
            lms = {
                "name": "lms_decode", "route": "cuda",
                "source": "sea_codec_torch/csrc/lms_decode.cu",
                "replaces": "sea_codec_tpu/ops/pallas_decode.py:92",
                "launches": path_launches(result, "lms_decode")[0],
                "launches_by_path": path_launches(result, "lms_decode")[1],
                "ms": lms_ms, "ms_one_chunk": lms_one_ms, "plain_ms": lms_plain_ms, "shape": [n, f, c],
                "bytes": 2 * n * f * c * 2 + 2 * b.hist.size * 4,
                "ops": tuple(n * f * c * k for k in LMS_OPS_PER_SAMPLE),
                "chain_cycles": f * chain_cycles(DECODE_FRAME_CHAIN),
            }
            out.append((err, lms))
        else:
            lms["ms_vbr_dq"] = lms_ms
            lms["ms_one_chunk_vbr_dq"] = lms_one_ms
            out[-2] = (max(out[-2][0], err), lms)
        rkw = dict(kw, residual_size=b.residual_size)
        route = lambda fused: decode_chunks_packed(res, sf, rs, hist, wts, fused=fused, **rkw)
        turns = [cuda_ms(lambda: route(fused), reps=20) for fused in (True, False, False, True)]
        worst_of([turns[1][1]], [turns[0][1]], f"{mode}: two-kernel path != fused kernel")
        fused_ms = (turns[0][0] + turns[3][0]) / 2
        two_ms = (turns[1][0] + turns[2][0]) / 2
        result["main"][f"two_kernel_vs_fused_{mode}"] = {"fused_ms": fused_ms, "two_kernel_ms": two_ms}
        log(f"[phase 5] {mode} decode of {[n, f, c]} through the router, in turns: fused kernel "
            f"{turns[0][0]:.4f} / {turns[3][0]:.4f} ms, two-kernel path (dequant + recurrence, wrapper ops "
            f"included) {turns[1][0]:.4f} / {turns[2][0]:.4f} ms; equal PCM; card {result['card']}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the front ends and the mesh pipelines (run before phase 5, so
# that their launches count in the kernels line)
# ---------------------------------------------------------------------------

# a failure of a cluster's rendezvous, not of the codec: retried once on a
# fresh port
RENDEZVOUS_ERRORS = ("Address already in use", "Connection refused", "ECONNREFUSED", "EADDRINUSE")


def run_main(main, argv, what):
    """An in-process CLI call; a non-zero exit fails the smoke."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    check(rc == 0, f"{what}: exit code {rc}")


def subprocess_env(here):
    """The environment of a child process: the checkout first on
    ``PYTHONPATH``, so that it imports this package and loads the kernels
    phase 1 built under ``build/``."""
    old = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=here + (os.pathsep + old if old else ""))


def run_children(argvs, here, timeout):
    """Run the commands at once and wait for all (each killed past
    ``timeout`` seconds); returns (exit codes, their joined output tails)."""
    procs = [subprocess.Popen(a, cwd=here, env=subprocess_env(here), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for a in argvs]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0].decode(errors="replace") + f"\n[timed out after {timeout} s]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], "\n".join(o[-3000:] for o in outs)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def timed(fn):
    """(seconds, result) of ``fn`` on the card, synchronized on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def cli_path(result, here, tmp, pcm, enc, enc_vbr):
    """(a) ``seaconv``: the main path's signal as a ``.wav``, through
    ``cli.main`` to ``.sea`` and back, once CBR (``-b 3``) and once VBR
    (``-v -b 2.5``): bytes equal to the main path's files, the ``.wav``
    written back equal to ``sea_decode``'s PCM; then ``python -m
    sea_codec_torch`` in a child process, bytes equal too."""
    from sea_codec_torch import cli, sea_decode
    from sea_codec_torch.utils.wav import read_wav, write_wav

    wav = os.path.join(tmp, "main.wav")
    write_wav(pcm, MAIN_CHANNELS, MAIN_RATE, wav)
    for label, flags, want, must in (
        ("cli_cbr", ["-b", "3"], enc, ("window_search", "fused_decode_cbr")),
        ("cli_vbr", ["-v", "-b", "2.5"], enc_vbr,
         ("window_search_full", "window_search_ranks_only", "fused_decode_vbr")),
    ):
        sea, back = os.path.join(tmp, f"{label}.sea"), os.path.join(tmp, f"{label}.wav")
        reset_launch_counts()
        enc_s, _ = timed(lambda: run_main(cli.main, [wav, sea, *flags], f"{label} encode"))
        dec_s, _ = timed(lambda: run_main(cli.main, [sea, back], f"{label} decode"))
        counts = launch_counts()
        counts["window_search_full"] = counts["window_search"] - counts["window_search_ranks_only"]
        result["launches"][label] = counts
        for name in must:
            check(counts[name] > 0, f"{label} never launched {name}")
        with open(sea, "rb") as f:
            check(f.read() == want, f"{label}: .sea bytes != the main path's")
        check(np.array_equal(read_wav(back).samples, sea_decode(want).samples),
              f"{label}: .wav written back != sea_decode")
        log(f"[phase 6] {label}: seaconv {' '.join(flags)} on a {MAIN_FRAMES}-frame stereo .wav: "
            f"encode {enc_s:.4f} s, decode {dec_s:.4f} s (file I/O included); bytes == main path, "
            f"PCM == sea_decode; launches {counts}; card {result['card']}")
        result["main"][label] = {"encode_s": enc_s, "decode_s": dec_s}
    sub = os.path.join(tmp, "sub.sea")
    t0 = time.perf_counter()
    rcs, text = run_children([[sys.executable, "-m", "sea_codec_torch", wav, sub, "-b", "3"]], here, 120)
    wall = time.perf_counter() - t0
    check(rcs == [0], f"python -m sea_codec_torch: exit {rcs}:\n{text}")
    with open(sub, "rb") as f:
        check(f.read() == enc, "python -m sea_codec_torch: bytes != the main path's")
    log(f"[phase 6] python -m sea_codec_torch (a child process, interpreter start and kernel load "
        f"included): {wall:.2f} s, bytes == main path")
    result["main"]["cli_subprocess_s"] = wall


def batch_cli_path(result, tmp, bench):
    """(b) The batch CLI on bench.py's corpus shape as ``.wav`` files (256
    stereo CBR, 64 VBR): ``.sea`` bytes equal to ``encode_corpus``'s (which
    phase 4 held equal to the per-file bytes in ``bench``), then back to
    ``.wav``, PCM equal to ``decode_corpus``'s; with the ``_pt`` stage
    report. Returns each mode's ``.wav`` directory."""
    from sea_codec_torch import batch, batch_cli
    from sea_codec_torch.utils.profiling import StageTimes
    from sea_codec_torch.utils.wav import read_wav, write_wav

    dirs = {}
    for mode, flags in (("cbr", []), ("vbr", ["-v", "-b", "2.5"])):
        _st, files, wants = bench[mode]
        wav_in, sea_dir, wav_out = (os.path.join(tmp, f"batch_{mode}_{d}") for d in ("wav", "sea", "back"))
        os.makedirs(wav_in)
        for i, f in enumerate(files):
            write_wav(f, 2, CORPUS_RATE, os.path.join(wav_in, f"{i:03d}.wav"))
        dirs[mode] = wav_in
        label = f"batch_cli_{mode}"
        reset_launch_counts()
        batch.PIPELINE_TIMES = StageTimes()
        try:
            enc_s, _ = timed(lambda: run_main(batch_cli.main, [os.path.join(wav_in, "*.wav"), sea_dir, *flags],
                                              f"{label} encode"))
            dec_s, _ = timed(lambda: run_main(batch_cli.main, [os.path.join(sea_dir, "*.sea"), wav_out],
                                              f"{label} decode"))
            report = batch.PIPELINE_TIMES
        finally:
            batch.PIPELINE_TIMES = None
        counts = launch_counts()
        result["launches"][label] = counts
        for i, w in enumerate(wants):
            with open(os.path.join(sea_dir, f"{i:03d}.sea"), "rb") as f:
                check(f.read() == w, f"{label}: file {i} != encode_corpus")
        decoded = batch.decode_corpus(wants)
        for i, d in enumerate(decoded):
            check(np.array_equal(read_wav(os.path.join(wav_out, f"{i:03d}.wav")).samples, d.samples),
                  f"{label}: file {i} written back != decode_corpus")
        samples = sum(f.size for f in files)
        log(f"[phase 6] {label}: {len(files)} files, {samples / 1e6:.3f} Msamples: encode {enc_s:.4f} s, "
            f"decode {dec_s:.4f} s (file I/O included); bytes == encode_corpus, PCM == decode_corpus; "
            f"launches {counts}; card {result['card']}; stages:\n{report.report()}")
        result["main"][label] = {"encode_s": enc_s, "decode_s": dec_s, "msamples": samples / 1e6,
                                 "stages": dict(report)}
    return dirs


TRANSCODE_SHAPE = (8, 194, 5120, 2)  # files, chunks, frames, channels: 15.9 Msamples


def mesh_path(result, pcm, enc, bench, corpus):
    """(c) Meshes of repeated ``cuda:0`` entries, each with its own streams
    (no gain expected on one card): ``encode_corpus`` on (b)'s corpora and
    ``decode_corpus`` on the decode corpus over 2 entries, equal to
    ``mesh=None`` (walls in turns: unsharded, mesh, mesh, unsharded);
    ``corpus_transcode_step`` at ``TRANSCODE_SHAPE`` over 2 x 2 entries,
    PCM equal to per-file ``sea_encode`` then ``sea_decode``; and
    ``decode_chunk_batch_sharded`` on the main path's full chunks, equal to
    ``decode_chunks``, from host arrays and from tensors on the card."""
    import torch

    from sea_codec_torch import EncoderSettings, batch, sea_decode, sea_encode
    from sea_codec_torch.ops.device_decode import decode_chunks
    from sea_codec_torch.parallel.pipeline import corpus_transcode_step, decode_chunk_batch_sharded, make_mesh

    mesh2 = make_mesh(devices=["cuda:0"] * 2)
    mesh4 = make_mesh(devices=["cuda:0"] * 4)
    check(mesh4.devices.shape == (2, 2), f"a 4-entry mesh is {mesh4.devices.shape}")

    def in_turns(label, run, want, same):
        reset_launch_counts()
        walls = {"none": [], "mesh": []}
        for which in ("none", "mesh", "mesh", "none"):
            t, out = timed(lambda: run(mesh2 if which == "mesh" else None))
            check(same(out, want), f"{label}: mesh={which} output != mesh=None's")
            walls[which].append(t)
        counts = launch_counts()
        result["launches"][label] = counts
        log(f"[phase 6] {label} over [cuda:0] x 2, in turns: unsharded {walls['none'][0]:.4f} / "
            f"{walls['none'][1]:.4f} s, mesh {walls['mesh'][0]:.4f} / {walls['mesh'][1]:.4f} s; equal; "
            f"launches (both) {counts}; card {result['card']}")
        result["main"][label] = walls

    for mode in ("cbr", "vbr"):
        st, files, wants = bench[mode]
        in_turns(f"mesh_encode_corpus_{mode}", lambda m: batch.encode_corpus(files, CORPUS_RATE, 2, st, mesh=m),
                 wants, lambda a, b: a == b)
    single = [sea_decode(b).samples for b in corpus["blobs"]]
    want = [single[k] for k in corpus["which"]]
    in_turns("mesh_decode_corpus", lambda m: batch.decode_corpus(corpus["files"], mesh=m), want,
             lambda outs, w: all(np.array_equal(o.samples, x) for o, x in zip(outs, w, strict=True)))

    nf, nc, fpc, c = TRANSCODE_SHAPE
    samples = np.resize(pcm, nf * nc * fpc * c).reshape(TRANSCODE_SHAPE).astype(np.int32)
    reset_launch_counts()
    wall, (got, codes) = timed(lambda: corpus_transcode_step(mesh4, samples, 3, 4, 20))
    counts = launch_counts()
    result["launches"]["transcode_step"] = counts
    for name in ("window_search", "lms_decode"):
        check(counts[name] > 0, f"corpus_transcode_step never launched {name}")
    check(got.shape == TRANSCODE_SHAPE and codes.shape == TRANSCODE_SHAPE, "corpus_transcode_step shapes")
    t0 = time.perf_counter()
    for f in range(nf):
        one = sea_encode(samples[f].astype(np.int16).reshape(-1), MAIN_RATE, c, EncoderSettings())
        check(np.array_equal(got[f].reshape(-1), sea_decode(one).samples),
              f"corpus_transcode_step: file {f} != sea_encode then sea_decode")
    per_file = time.perf_counter() - t0
    log(f"[phase 6] corpus_transcode_step over [cuda:0] x 4 (2 x 2) at {list(TRANSCODE_SHAPE)} "
        f"({samples.size / 1e6:.3f} Msamples): {wall:.4f} s, PCM == per-file sea_encode + sea_decode "
        f"({per_file:.4f} s for the {nf} files); launches {counts}; card {result['card']}")
    result["main"]["transcode_step"] = {"s": wall, "per_file_s": per_file}

    _header, (codes, sf, rs, hist, wts, sfb), _frames = batch.parse_file(enc)
    n = MAIN_FRAMES // 5120
    arrays = [a[:n] for a in (codes, sf, rs, hist, wts)]
    reset_launch_counts()
    wall, got = timed(lambda: decode_chunk_batch_sharded(mesh4, *arrays, sfb, 20))
    counts = launch_counts()
    result["launches"]["sharded_decode"] = counts
    check(counts["lms_decode"] == 4, f"decode_chunk_batch_sharded: {counts['lms_decode']} lms_decode launches")
    want = decode_chunks(*(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays), sfb=sfb, sff=20)
    check(np.array_equal(got, want.cpu().numpy()), "decode_chunk_batch_sharded != decode_chunks")
    log(f"[phase 6] decode_chunk_batch_sharded over [cuda:0] x 4 on the main path's {n} chunks, unpacked: "
        f"{wall:.4f} s (host upload and download included), == decode_chunks; launches {counts}")
    result["main"]["sharded_decode_s"] = wall

    # the same chunks as tensors already on the card, written there on the
    # current stream behind a ~50 ms spin: each entry's stream must wait for
    # them (zeros if it reads too early). The entries' streams come from
    # PyTorch's pool of 32 a device: on a stream new to the allocator the
    # outputs take a cudaMalloc, which can wait for the whole card and hide
    # a missing wait, so 9 calls of 4 streams reach streams it has served
    hosts = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in arrays]
    want = want.cpu().numpy()
    reps = 9
    walls = []
    reset_launch_counts()
    for _ in range(reps):
        on_card = [torch.zeros(h.shape, dtype=h.dtype, device="cuda:0") for h in hosts]
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        for t, h in zip(on_card, hosts):
            t.copy_(h, non_blocking=True)
        t0 = time.perf_counter()  # not ``timed``: its first sync would end the spin
        got = decode_chunk_batch_sharded(mesh4, *on_card, sfb, 20)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(np.array_equal(got, want),
              f"decode_chunk_batch_sharded on tensors still being written on the card != decode_chunks "
              f"(call {len(walls)} of {reps})")
    counts = launch_counts()
    result["launches"]["sharded_decode_on_card"] = counts
    check(counts["lms_decode"] == 4 * reps, f"decode_chunk_batch_sharded, tensors on the card: "
          f"{counts['lms_decode']} lms_decode launches in {reps} calls")
    log(f"[phase 6] decode_chunk_batch_sharded over [cuda:0] x 4 on the same chunks as tensors on the card, "
        f"written on the current stream behind a spin, {reps} calls: {walls[0]:.4f} s the first, "
        f"{walls[-1]:.4f} s the last (the rest of the spin included); each == decode_chunks; "
        f"launches {counts}")
    result["main"]["sharded_decode_on_card_s"] = walls


def distributed_path(result, here, tmp, bench, wav_dir):
    """(d) Two ``batch_cli --distributed`` processes on ``cuda:0`` with an
    explicit coordinator on ``localhost``, on 16 of (b)'s CBR files: the
    union of their outputs equals the single-process bytes. A rendezvous
    failure is retried once on a fresh port; any other failure fails."""
    import shutil

    _st, _files, wants = bench["cbr"]
    n = 16
    wav_in, out = os.path.join(tmp, "dist_wav"), os.path.join(tmp, "dist_sea")
    os.makedirs(wav_in)
    for i in range(n):
        shutil.copy(os.path.join(wav_dir, f"{i:03d}.wav"), wav_in)
    for attempt in range(2):
        port = free_port()
        argv = [sys.executable, "-m", "sea_codec_torch.batch_cli", os.path.join(wav_in, "*.wav"), out,
                "--distributed", "--coordinator", f"localhost:{port}", "--num-processes", "2"]
        t0 = time.perf_counter()
        rcs, text = run_children([argv + ["--process-id", str(pid)] for pid in range(2)], here, 180)
        wall = time.perf_counter() - t0
        if rcs == [0, 0]:
            break
        check(attempt == 0 and any(m in text for m in RENDEZVOUS_ERRORS),
              f"batch_cli --distributed: exit codes {rcs}:\n{text}")
    for i in range(n):
        with open(os.path.join(out, f"{i:03d}.sea"), "rb") as f:
            check(f.read() == wants[i], f"batch_cli --distributed: file {i} != single-process bytes")
    log(f"[phase 6] batch_cli --distributed, 2 processes on cuda:0 (gloo on localhost), {n} files: "
        f"{wall:.2f} s (interpreter start, process group and kernel load included), the union == "
        f"single-process bytes; card {result['card']}")
    result["main"]["distributed_s"] = wall


def front_ends(result, here, pcm, enc, enc_vbr, bench, corpus):
    """Phase 6, in a temporary directory removed afterwards."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cli_path(result, here, tmp, pcm, enc, enc_vbr)
        wav_dirs = batch_cli_path(result, tmp, bench)
        mesh_path(result, pcm, enc, bench, corpus)
        distributed_path(result, here, tmp, bench, wav_dirs["cbr"])


# ---------------------------------------------------------------------------
# phase 7: the serving artifacts (aot.py) and the kernel build cache (run
# after phase 6 and before phase 5, so that their launches count in the
# kernels line)
# ---------------------------------------------------------------------------

# A serving process: loads the two exported decoders from files, decodes
# their rows and holds the PCM to the expected; prints what it found of the
# build cache and of nvcc, its nvcc runs, its kernels' launches and where
# its time went (seconds: imports, then per artifact its load and its first
# decode) as JSON.
SERVING_CHILD = """
import time
t0 = time.perf_counter()
import json, shutil, sys
import numpy as np
import torch
from sea_codec_torch.aot import load_rows_decoder
from sea_codec_torch.ops import cuda_build, dequant, fused_decode, fused_decode_vbr, lms_decode
from sea_codec_torch.utils import cache
report = {"nvcc_on_path": shutil.which("nvcc"), "cache_dir": str(cache.cache_dir()),
          "cache_entries": cache.cache_entries(), "equal": {}, "s": {"imports": time.perf_counter() - t0}}
for d in sys.argv[1:]:
    t0 = time.perf_counter()
    with open(d + "/decoder.pt2", "rb") as f:
        decode = load_rows_decoder(f.read())
    t1 = time.perf_counter()
    rows = torch.from_numpy(np.load(d + "/rows.npy")).cuda()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = decode(rows)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    report["s"][d[-3:]] = {"load": t1 - t0, "first_decode": t3 - t2}
    report["equal"][d] = bool(np.array_equal(out.cpu().numpy(), np.load(d + "/want.npy")))
report["builds"] = cuda_build.builds
report["launches"] = {"fused_decode_cbr": fused_decode.launches, "fused_decode_vbr": fused_decode_vbr.launches,
                      "dequant_cbr": dequant.cbr_launches, "dequant_vbr": dequant.vbr_launches,
                      "lms_decode": lms_decode.launches}
print(json.dumps(report))
"""


def serving_streams(enc, enc_vbr):
    """Per mode, the main path's full-chunk rows on the card, their
    ``decode_sea`` PCM, the stream's geometry as ``export_rows_decoder``
    takes it (from the header and the first chunk header: the VBR anchor
    is its residual size) and the device transcode of the same rows."""
    import torch

    from sea_codec_torch import sea_decode
    from sea_codec_torch.batch import split_chunks
    from sea_codec_torch.ops.parse_device import decode_rows_vbr_device, transcode_chunks_cbr_device

    streams = {}
    for mode, blob, transcode in (("cbr", enc, transcode_chunks_cbr_device),
                                  ("vbr", enc_vbr, decode_rows_vbr_device)):
        header, rect, _tail = split_chunks(blob)
        n, fpc, c = rect.shape[0], header.frames_per_chunk, header.channels
        geo = dict(n_chunks=n, channels=c, frames_per_chunk=fpc, scale_factor_frames=int(rect[0, 2]),
                   scale_factor_bits=int(rect[0, 1]) >> 4, residual_size=int(rect[0, 1]) & 15,
                   vbr=mode == "vbr", chunk_size=header.chunk_size)
        args = (c, geo["scale_factor_bits"], geo["scale_factor_frames"], geo["residual_size"], fpc)
        streams[mode] = {
            "rect": rect, "rows": torch.from_numpy(rect.copy()).cuda(), "geo": geo,
            "want": sea_decode(blob).samples[: n * fpc * c].reshape(n, fpc, c),
            "transcode": lambda rows, t=transcode, a=args: t(rows, *a),
        }
    return streams


def export_and_load(result, streams, mode, route):
    """(a), (b): export one rows decoder on the card (``SEA_FUSED_PROLOG=0``
    at export for the two-kernel route), load it in this process, decode
    the rows once with the launch counts set to 0 just before: PCM equal to
    ``decode_sea``'s, and the route's kernels launched once each. Returns
    (blob, the loaded callable)."""
    import torch

    from sea_codec_torch.aot import export_rows_decoder, load_rows_decoder

    s = streams[mode]
    before = os.environ.get("SEA_FUSED_PROLOG")
    if route == "two_kernel":
        os.environ["SEA_FUSED_PROLOG"] = "0"
    else:
        os.environ.pop("SEA_FUSED_PROLOG", None)
    try:
        t0 = time.perf_counter()
        blob = export_rows_decoder(**s["geo"], device="cuda")
        export_s = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("SEA_FUSED_PROLOG", None)
        else:
            os.environ["SEA_FUSED_PROLOG"] = before
    t0 = time.perf_counter()
    decode = load_rows_decoder(blob)
    load_s = time.perf_counter() - t0
    reset_launch_counts()
    call_s, out = timed(lambda: decode(s["rows"]))
    counts = launch_counts()
    label = f"aot_{mode}" + ("" if route == "fused" else "_two_kernel")
    result["launches"][label] = counts
    check(np.array_equal(out.cpu().numpy(), s["want"]), f"{label}: the loaded artifact's PCM != decode_sea")
    want = {f"fused_decode_{mode}": 1} if route == "fused" else {f"dequant_{mode}": 1, "lms_decode": 1}
    launched = {k: v for k, v in counts.items() if v}
    check(launched == want, f"{label}: one call launched {launched}, expected {want}")
    log(f"[phase 7] {label}: exported {s['geo']['n_chunks']} x {s['geo']['chunk_size']} rows -> PCM on cuda "
        f"in {export_s:.3f} s, {len(blob)} bytes; loaded in {load_s:.3f} s; first call {call_s * 1e3:.3f} ms, "
        f"== decode_sea; launches {launched}; card {result['card']}")
    result["main"][label] = {"export_s": export_s, "bytes": len(blob), "load_s": load_s, "first_call_s": call_s}
    return blob, decode


HOST_CALLS = 200


def top_functions(fn, calls, n=6):
    """The ``n`` functions ``fn`` spends most of its own time in over
    ``calls`` calls, by ``cProfile``: "<us a call> <times a call>
    <file>:<line>(<function>)". The profiler slows every Python call, so
    the ranking, not the times, is the finding."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [f"{tt / calls * 1e6:.1f} us {nc / calls:g}x {os.path.basename(path)}:{line}({func})"
            for (path, line, func), (_cc, nc, tt, _ct, _callers) in rows]


def wrapper_host_us(streams):
    """Host time of one call of each decode wrapper on one chunk, enqueued
    ``HOST_CALLS`` times without waiting for the card: the wrapper (its checks, then
    the op), the op alone (the dispatcher, then the CUDA kernel function)
    and the CUDA kernel function called directly (the launch body)."""
    import torch

    from sea_codec_torch.ops import dequant, fused_decode, fused_decode_vbr, lms_decode
    from sea_codec_torch.ops.parse_device import parse_chunks_cbr_device, parse_chunks_vbr_device

    ops = torch.ops.sea_codec_torch
    g = streams["cbr"]["geo"]
    sfb, sff, f, c = g["scale_factor_bits"], g["scale_factor_frames"], g["frames_per_chunk"], g["channels"]
    rs = g["residual_size"]
    res, sf, _rs, hist, wts = (t.contiguous() for t in parse_chunks_cbr_device(
        streams["cbr"]["rows"][:1], c, sfb, sff, rs, f))
    vres, vsf, vrs, vhist, vwts = (t.contiguous() for t in parse_chunks_vbr_device(
        streams["vbr"]["rows"][:1], c, sfb, sff, streams["vbr"]["geo"]["residual_size"], f))
    dq = dequant.unpack_dequant_cbr(res, sf, sfb=sfb, rs=rs, sff=sff, frames=f)
    kw = dict(sfb=sfb, sff=sff, frames=f)
    forms = {
        "fused_decode_cbr": (lambda: fused_decode.decode_cbr_fused(res, sf, hist, wts, rs=rs, **kw),
                             lambda: ops.fused_decode_cbr(res, sf, hist, wts, sfb, rs, sff, f),
                             lambda: fused_decode._launch(res, sf, hist, wts, sfb, rs, sff, f)),
        "fused_decode_vbr": (lambda: fused_decode_vbr.decode_vbr_fused(vres, vsf, vrs, vhist, vwts, **kw),
                             lambda: ops.fused_decode_vbr(vres, vsf, vrs, vhist, vwts, sfb, sff, f),
                             lambda: fused_decode_vbr._launch(vres, vsf, vrs, vhist, vwts, sfb, sff, f)),
        "dequant_cbr": (lambda: dequant.unpack_dequant_cbr(res, sf, rs=rs, **kw),
                        lambda: ops.dequant_cbr(res, sf, sfb, rs, sff, f),
                        lambda: dequant._launch_cbr(res, sf, sfb, rs, sff, f)),
        "dequant_vbr": (lambda: dequant.unpack_dequant_vbr(vres, vsf, vrs, **kw),
                        lambda: ops.dequant_vbr(vres, vsf, vrs, sfb, sff, f),
                        lambda: dequant._launch_vbr(vres, vsf, vrs, sfb, sff, f)),
        "lms_decode": (lambda: lms_decode.lms_decode(dq, hist, wts),
                       lambda: ops.lms_decode(dq, hist, wts),
                       lambda: lms_decode._launch(dq, hist, wts)),
    }
    for label, fn in (("op", forms["fused_decode_cbr"][1]), ("kernel function", forms["fused_decode_cbr"][2])):
        log(f"[phase 7] fused_decode_cbr {label}, one chunk, top functions by own time (cProfile, "
            f"{HOST_CALLS} calls): " + "; ".join(top_functions(fn, HOST_CALLS)))
    out = {}
    for name, fns in forms.items():
        us = []
        for fn in fns:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            us.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        out[name] = dict(zip(("wrapper_us", "op_us", "kernel_fn_us"), us))
    return out


def serving_children(result, here, tmp, streams, blobs):
    """(d) A fresh serving process with no nvcc to be found (``PATH``
    without it, ``CUDA_HOME`` a missing path): from the build cache this
    process built into (``SEA_TORCH_CACHE``) it loads both artifacts from
    files and decodes, building nothing; from an empty cache it fails with
    ``cuda_build``'s error, with no fallback to the CPU."""
    from sea_codec_torch.utils import cache

    dirs = []
    for mode in ("cbr", "vbr"):
        d = os.path.join(tmp, f"serve_{mode}")
        os.makedirs(d)
        with open(os.path.join(d, "decoder.pt2"), "wb") as f:
            f.write(blobs[mode])
        np.save(os.path.join(d, "rows.npy"), streams[mode]["rect"])
        np.save(os.path.join(d, "want.npy"), streams[mode]["want"])
        dirs.append(d)
    path = os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                           if p and not os.path.exists(os.path.join(p, "nvcc")))
    base = dict(subprocess_env(here), PATH=path, CUDA_HOME=os.path.join(tmp, "no_cuda"))
    empty = os.path.join(tmp, "empty_cache")
    runs = {}
    for label, cache_path in (("warm", str(cache.cache_dir())), ("empty", empty)):
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, "-c", SERVING_CHILD, *dirs], cwd=here, capture_output=True,
                                  text=True, env=dict(base, SEA_TORCH_CACHE=cache_path), timeout=300)
        except subprocess.TimeoutExpired as e:
            raise SmokeFailure(f"serving child, {label} cache: timed out after {e.timeout} s") from e
        runs[label] = (proc, time.perf_counter() - t0)
    proc, wall = runs["warm"]
    check(proc.returncode == 0, f"serving child, warm cache: exit code {proc.returncode}:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    check(report["nvcc_on_path"] is None, f"serving child: nvcc found at {report['nvcc_on_path']}")
    check(all(report["equal"].values()), f"serving child: PCM != decode_sea: {report['equal']}")
    check(report["builds"] == 0, f"serving child ran nvcc {report['builds']} times")
    launched = {k: v for k, v in report["launches"].items() if v}
    check(launched == {"fused_decode_cbr": 1, "fused_decode_vbr": 1}, f"serving child launched {launched}")
    result["launches"]["aot_child"] = dict(dict.fromkeys(launch_counts(), 0), **report["launches"])
    times = ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                      f"{k}: load {v['load']:.3f}, first decode {v['first_decode']:.3f}"
                      for k, v in report["s"].items())
    log(f"[phase 7] serving child, no nvcc (PATH without it, CUDA_HOME missing), SEA_TORCH_CACHE="
        f"{report['cache_dir']} ({report['cache_entries']} libraries): loaded both artifacts from files, "
        f"PCM == decode_sea, builds {report['builds']}, launches {launched}; {wall:.2f} s with interpreter "
        f"start (inside it, s: {times}); card {result['card']}")
    proc, wall = runs["empty"]
    check(proc.returncode != 0 and "nvcc not found" in proc.stderr,
          f"serving child, empty cache: exit code {proc.returncode}, expected nvcc not found:\n"
          f"{proc.stderr[-3000:]}")
    log(f"[phase 7] serving child, empty SEA_TORCH_CACHE, no nvcc: exit code {proc.returncode}, "
        f"'{proc.stderr.strip().splitlines()[-1][:120]}', no fallback to the CPU; {wall:.2f} s")
    result["main"]["aot_child_s"] = wall


def serving_path(result, here, enc, enc_vbr):
    """Phase 7, in a temporary directory removed afterwards."""
    import tempfile

    t_phase = time.perf_counter()
    streams = serving_streams(enc, enc_vbr)
    blobs, loaded = {}, {}
    for mode in ("cbr", "vbr"):
        blobs[mode], loaded[mode] = export_and_load(result, streams, mode, "fused")
        export_and_load(result, streams, mode, "two_kernel")
    for mode in ("cbr", "vbr"):
        s = streams[mode]
        fns = {"artifact": lambda: loaded[mode](s["rows"]), "eager": lambda: s["transcode"](s["rows"])}
        turns = [(which, *cuda_ms(fns[which], reps=20)) for which in ("eager", "artifact", "artifact", "eager")]
        for which, _ms, out in turns:
            check(np.array_equal(out.cpu().numpy(), s["want"]), f"aot_{mode} {which}: PCM != decode_sea")
        ms = {which: [t[1] for t in turns if t[0] == which] for which in fns}
        result["main"][f"aot_{mode}"].update(artifact_ms=ms["artifact"], eager_ms=ms["eager"])
        log(f"[phase 7] aot_{mode}: [{s['geo']['n_chunks']}] rows -> PCM by CUDA events over 20 calls, in turns: "
            f"eager transcode {ms['eager'][0]:.4f} / {ms['eager'][1]:.4f} ms, loaded artifact "
            f"{ms['artifact'][0]:.4f} / {ms['artifact'][1]:.4f} ms; all equal; card {result['card']}")
        for which, fn in fns.items():
            log(f"[phase 7] aot_{mode} {which}, top functions by own time (cProfile, 20 calls): "
                + "; ".join(top_functions(fn, 20)))
    host = wrapper_host_us(streams)
    result["main"]["wrapper_host_us"] = host
    for name, us in host.items():
        log(f"[phase 7] host time a call, one chunk, {HOST_CALLS} calls enqueued: {name} wrapper {us['wrapper_us']:.1f} us, "
            f"its op {us['op_us']:.1f} us, the CUDA kernel function directly {us['kernel_fn_us']:.1f} us; "
            f"card {result['card']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        serving_children(result, here, tmp, streams, blobs)
    wall = time.perf_counter() - t_phase
    result["main"]["phase7_s"] = wall
    log(f"[phase 7] total {wall:.2f} s")


def run(here):
    import torch

    from sea_codec_torch import EncoderSettings
    from sea_codec_torch.ops import cuda_build
    from sea_codec_torch.ops.serialize_device import cbr_chunk_size

    result = {"launches": {}, "main": {}}
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"[phase 1] built {len(cuda_build.KERNEL_SOURCES)} kernels in {time.perf_counter() - t0:.2f} s")
    result["card"] = card_line()
    log(f"[phase 1] card: {result['card']}; torch {torch.__version__} cuda {torch.version.cuda}")

    rng = np.random.default_rng(7)
    errs = {
        "fused_decode_cbr": max(decode_sweep(rng), dequant_exhaustive()),
        "fused_decode_vbr": max(vbr_decode_sweep(rng), vbr_dequant_exhaustive()),
        "window_search": max(search_sweep(rng), search_sweep_vbr(rng), search_sweep_lanes(rng)),
        "lms_decode": lms_sweep(rng),
    }
    errs["dequant_cbr"], errs["dequant_vbr"] = dequant_sweeps(rng)
    dequant_kernels_exhaustive()
    for name, err in oversize_rows(rng).items():
        errs[name] = max(errs[name], err)
    fixtures(here, rng)
    pcm = music_signal(MAIN_FRAMES, seed=2024)
    c = MAIN_CHANNELS
    enc = main_path(result, pcm, "cbr", EncoderSettings(), cbr_chunk_size(c, 5120, 4, 20, 3),
                    ("fused_decode_cbr", "window_search"))
    enc_vbr = main_path(result, pcm, "vbr", vbr_settings(), vbr_chunk_size(vbr_settings(), c),
                        ("fused_decode_vbr", "window_search_full", "window_search_ranks_only"))
    corpus = make_corpus(rng)
    corpus_path(result, corpus)
    bench = corpus_encode_path(result, corpus)
    transcode_path(result, enc, enc_vbr)
    session_path(result)
    front_ends(result, here, pcm, enc, enc_vbr, bench, corpus)
    del corpus, bench
    serving_path(result, here, enc, enc_vbr)
    clock_mhz = float(smi("clocks.max.sm", ",nounits"))
    kernels = []
    phase5 = [decode_at_main_shape(enc, result), vbr_decode_at_main_shape(enc_vbr, result),
              *two_kernel_at_main_shape(enc, enc_vbr, result, here),
              search_at_main_shape(pcm, enc, result)]
    for err, k in phase5:
        k["max_abs_err"] = max(errs[k["name"]], err)
        bounds(k, clock_mhz)
        kernels.append(k)
        log(f"[phase 5] {k['name']}: {k['ms']:.4f} ms; bound {k['bound_ms']:.4f} ms "
            f"(by {k['bound_by']}); chain {k['chain_ms']:.4f} ms at {clock_mhz} MHz; "
            f"least {k['least_ms']:.4f} ms, x{k['ms'] / k['least_ms']:.1f}"
            + (f"; on the card {k['device_ms']:.4f} ms, x{k['device_ms'] / k['least_ms']:.1f}"
               if "device_ms" in k else "")
            + (f"; chain by the earlier kernel's model {k['chain_ms_before']:.4f} ms"
               if "chain_ms_before" in k else ""))
    err, kernels[-1]["vbr"] = vbr_search_at_main_shape(pcm, enc_vbr, result, clock_mhz)
    kernels[-1].update(search_lane_times(result))
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], err)
    log("[phase 5] kernels: " + ", ".join(
        f"{k['name']} launches={k['launches']} equal to plain: true" for k in kernels))
    return kernels, result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import sea_codec_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the sea_codec_torch package is missing: {e}", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    try:
        kernels, result = run(here)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(result["card"])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
