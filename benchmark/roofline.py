"""The yardstick of the kernels' roofline shares: the work a call needs and
the card's peaks, frozen here so that a later change to a kernel meets the
same count whatever implements it.

The work counts are copies of ``chip_smoke.py``'s (``code_bytes``,
``unpack_dequant_ops``, ``decode_ops`` and the search's count in
``search_at_main_shape`` and ``vbr_search_at_main_shape``): the function's
own work, counted from the kernels' inner loops where those do no more than
the function needs, not the kernels' bookkeeping. They are taken over the
real samples of a call's files (a ragged tail counts its frames, not the
padded row a kernel may walk).

Peaks of one NVIDIA H100 SXM:

- HBM3 bandwidth 3.35 TB/s: NVIDIA's H100 data sheet (SXM part).
- int32 issue: 64 INT32 lanes per SM (Hopper's SM: 128 FP32 lanes, half of
  them also INT32) x the SMs x the SM clock; all instructions: 128 a clock
  an SM. Neither is stated by a data sheet: both are derived, with the SM
  count read from the device and the clock read by ``nvidia-smi``
  (``clocks.max.sm``, the highest the card runs at) beside the window.

The search is bound by one lane's serial chain of windows x samples, not by
issue or bytes (``PERF.md``): its roofline share sits far below 1% and
moves in proportion to its time.
"""

from __future__ import annotations

import subprocess

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
INT32_LANES_PER_SM = 64
ISSUE_PER_SM = 128

# chip_smoke.py's counts, frozen (their derivation is in its comments):
RECURRENCE_OPS_PER_SAMPLE = 25
UNPACK_OPS_PER_BYTE, UNPACK_OPS_PER_SAMPLE, UNPACK_OPS_PER_GROUP8, UNPACK_OPS_PER_ENTRY = 3, 4, 2, 1
VBR_UNPACK_OPS_PER_SAMPLE, VBR_UNPACK_OPS_PER_ENTRY = 2, 2
SEARCH_OPS_PER_STEP = (32, 9)  # (int32, f32) per candidate and sample


def peaks(sm_count: int, clock_mhz: float) -> dict:
    hz = clock_mhz * 1e6
    return {"bytes_per_s": H100_BYTES_PER_S, "int32_per_s": sm_count * INT32_LANES_PER_SM * hz,
            "issue_per_s": sm_count * ISSUE_PER_SM * hz, "sm_count": sm_count, "clock_mhz": clock_mhz}


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30, check=True)
    return float(out.stdout.strip().splitlines()[0])


def least_seconds(work: dict, pk: dict) -> float:
    """The least time the card could take for ``work`` ({bytes, ops:
    (int32, f32)}): the larger of its bytes over the bandwidth and its
    operations over the issue rates."""
    int_ops, f32_ops = work["ops"]
    return max(work["bytes"] / pk["bytes_per_s"], int_ops / pk["int32_per_s"],
               (int_ops + f32_ops) / pk["issue_per_s"])


def _add(a: dict, b: dict) -> dict:
    return {"bytes": a["bytes"] + b["bytes"], "ops": (a["ops"][0] + b["ops"][0], a["ops"][1] + b["ops"][1])}


ZERO = {"bytes": 0, "ops": (0, 0)}


def chunk_windows(frames: int, sff: int) -> int:
    return -(-frames // sff)


def search_work(frames: int, channels: int, fpc: int, sff: int, sfb: int, vbr: bool) -> dict:
    """The search over one file of ``frames`` frames: every candidate of
    every sample; samples read, codes written, a scale factor and a rank
    written per (window, channel), the entry state per chunk. VBR searches
    twice (ranks, then codes) and reads the sizes."""
    samples = frames * channels
    n_full, tail = divmod(frames, fpc)
    windows = (n_full * chunk_windows(fpc, sff) + chunk_windows(tail, sff)) * channels
    chunks = n_full + (1 if tail else 0)
    s = 1 << sfb
    passes = 2 if vbr else 1
    nbytes = passes * samples * 2 + samples + passes * windows * (1 + 8) + 2 * chunks * channels * 16
    if vbr:
        nbytes += windows
    return {"bytes": nbytes, "ops": tuple(passes * samples * s * k for k in SEARCH_OPS_PER_STEP)}


def decode_work(frames: int, channels: int, sff: int, code_bytes: int, vbr: bool) -> dict:
    """A fused decode of ``frames`` frames in chunks whose packed codes
    take ``code_bytes``: codes, scale factors (and VBR sizes) and entry
    states read, PCM written; the unpack and dequant, then the recurrence."""
    samples = frames * channels
    entries = chunk_windows(frames, sff) * channels
    nbytes = code_bytes + entries * (2 if vbr else 1) + 2 * channels * 4 * 4 + samples * 2
    per_sample = UNPACK_OPS_PER_SAMPLE + (VBR_UNPACK_OPS_PER_SAMPLE if vbr else 0)
    per_entry = UNPACK_OPS_PER_ENTRY + (VBR_UNPACK_OPS_PER_ENTRY if vbr else 0)
    ops = (UNPACK_OPS_PER_BYTE * code_bytes + per_sample * samples + UNPACK_OPS_PER_GROUP8 * -(-samples // 8)
           + per_entry * entries + RECURRENCE_OPS_PER_SAMPLE * samples)
    return {"bytes": nbytes, "ops": (ops, 0)}


def sum_work(items) -> dict:
    total = ZERO
    for w in items:
        total = _add(total, w)
    return total


def scale(work: dict, n: int) -> dict:
    return {"bytes": work["bytes"] * n, "ops": (work["ops"][0] * n, work["ops"][1] * n)}
