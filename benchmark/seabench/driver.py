"""What every driver of a program entry shares, and the reference's
readers of chunks.

A driver (``benchmark/entries/<entry>.py``, its class ``Entry``, found by
the ``entry`` that a traffic mix names) calls one entry of the program as a
user would: one warm-up call of the cell's own shape, then calls back to
back until the window's deadline (the call or request in flight then
completes and counts). It says which inputs the traffic generator makes
for it (``inputs``), whether it takes a mesh of several cards
(``takes_mesh``), which answers it keeps for the check, how the check
compares them with ``reference.codec`` once the window has closed, and the
roofline work of its calls (``work``). The end-to-end readers
(``benchmark/metrics/<metric>.py``) read its records.

``control`` replaces the answers that the check reads with the
reference's own in float32 (``reference.codec``): the lower precision that
the check must refuse.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import codec

PARSE_ROWS = 2048


DROPPED = object()  # an answer not kept for the check


class Driver:
    inputs = "pcm"  # what traffic.make makes: "pcm" (int16 arrays) or "sea" (.sea files as bytes)
    takes_mesh = False  # True: a cell on several cards hands the entry a mesh of them
    keep = None  # answers kept for the check: all, or a sample of this many calls drawn from the seed

    def __init__(self, port, traffic, device, seed: int, mesh=None):
        if mesh is not None and not self.takes_mesh:
            raise ValueError(f"{traffic.entry} runs on one card and takes no mesh")
        self.port = port
        self.tr = traffic
        self.device = torch.device(device)
        self.mesh = mesh
        self.seed = seed
        self.records = []  # (start, end, answer or DROPPED) per call or request, in order
        self.attempted = self.failed = 0  # answers asked for and answers that never came

    def placement(self) -> dict:
        """The entry's ``mesh=`` or ``device=`` argument."""
        return {"mesh": self.mesh} if self.mesh is not None else {"device": self.device}

    def answers(self, out) -> tuple[int, int]:
        """(answers asked for, answers missing) in one call's result."""
        n = len(self.tr.frames)
        if out is None:
            return n, n
        return n, n - sum(1 for a in list(out)[:n] if a is not None and (not isinstance(a, bytes) or a))

    def warm(self):
        self.call(0)

    def run_window(self, seconds: float, traced: bool = False) -> None:
        """Calls back to back until ``seconds`` have passed; the call in
        flight then completes and counts. With ``keep``, a reservoir sample
        of that many calls' answers drawn from the seed is kept and the
        others are dropped once a later call has completed, so that the
        process holds no more answers than a caller that keeps its last."""
        rng = np.random.default_rng([self.seed, 0xCA11])
        kept: list[int] = []
        deadline = time.perf_counter() + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if traced:  # a host range in the trace names the idle gaps inside a call
                with torch.profiler.record_function(f"bench.{self.tr.entry}"):
                    out = self.call(i)
            else:
                out = self.call(i)
            t1 = time.perf_counter()
            self.records.append((t0, t1, out))
            n, bad = self.answers(out)
            self.attempted += n
            self.failed += bad
            if self.keep is not None:
                if len(kept) < self.keep:
                    kept.append(i)
                else:
                    slot = int(rng.integers(0, i + 1))
                    drop = i
                    if slot < self.keep:
                        drop, kept[slot] = kept[slot], i
                    self.records[drop] = self.records[drop][:2] + (DROPPED,)
            del out
            i += 1
            if t1 >= deadline:
                return

    def kept(self):
        """(index, answer) of the calls whose answers were kept."""
        return [(i, r[2]) for i, r in enumerate(self.records) if r[2] is not DROPPED]

    def timing_note(self) -> str:
        d = self.latency_ms()
        q = np.percentile(d, [0, 50, 90, 95, 99, 100])
        return (f"{len(d)} calls, ms min/p50/p90/p95/p99/max " + "/".join(f"{v:.1f}" for v in q)
                + (f"; each {' '.join(f'{v:.0f}' for v in d)}" if len(d) <= 40 else ""))

    @property
    def window_s(self) -> float:
        return self.records[-1][1] - self.records[0][0]

    def rate_msamples_s(self) -> float:
        """Msamples/s over every completed call of the window: the samples of
        all calls over the time from the first call's start to the last
        call's end."""
        return len(self.records) * self.tr.samples_per_call / self.window_s / 1e6

    def latency_ms(self) -> np.ndarray:
        """Each call's or request's time on the host clock, ms."""
        return np.array([t1 - t0 for t0, t1, _ in self.records]) * 1e3

    def work(self, records) -> dict:
        """Roofline work (``roofline``) by kernel of the calls in ``records``."""
        return {}


def decode_kernel(layout) -> str:
    """The fused decode kernel of the layout's mode."""
    return "fused_decode_vbr" if layout.vbr else "fused_decode_cbr"


def rows_tensor(blobs: list[bytes], device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b"".join(blobs), np.uint8).copy()).to(device).view(len(blobs), -1)


def parse_rows(layout, frames, rows: torch.Tensor) -> dict:
    """``codec.parse`` in blocks of rows (its bit tensors are large)."""
    parts = [codec.parse(layout, frames, rows[i:i + PARSE_ROWS]) for i in range(0, rows.shape[0], PARSE_ROWS)]
    small = lambda k, t: t.to(torch.uint8) if k in ("codes", "sf", "sizes") else t
    return {k: torch.cat([small(k, p[k]) for p in parts]) for k in parts[0]}


def entry_states(chunks: list[bytes], c: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The LMS entry states (hist, wts) [n, C, 4] that chunk headers carry
    (a chunk too short to hold one reads as zeros)."""
    n = 4 + 16 * c
    rows = rows_tensor([b[:n].ljust(n, b"\0") for b in chunks], device)
    return codec.entry_state(rows, c)


def decode_chunks(layout, chunks: list[tuple[bytes, int]], device, pred_dtype) -> list[np.ndarray]:
    """PCM [frames, C] of each (chunk bytes, frames) by the reference: full
    chunks parsed in blocks, ragged ones one by one and padded to full rows
    (codes 0, scale factor 0, size 1 past their frames), then one decode of
    all rows, each row's own frames kept."""
    fpc, c = layout.frames_per_chunk, layout.channels
    full = [i for i, (_b, f) in enumerate(chunks) if f == fpc]
    ragged = [i for i, (_b, f) in enumerate(chunks) if f != fpc]
    fields = []
    if full:
        fields.append(parse_rows(layout, fpc, rows_tensor([chunks[i][0] for i in full], device)))
    w_full = layout.windows(fpc)
    pad = lambda t, n, v: torch.cat([t, torch.full((1, n - t.shape[1], c), v, dtype=t.dtype, device=t.device)], 1)
    for i in ragged:
        blob, f = chunks[i]
        p = codec.parse(layout, f, rows_tensor([blob], device))
        fields.append(dict(hist=p["hist"], wts=p["wts"], sf=pad(p["sf"], w_full, 0).to(torch.uint8),
                           sizes=pad(p["sizes"], w_full, 1).to(torch.uint8),
                           codes=pad(p["codes"], fpc, 0).to(torch.uint8)))
    cat = {k: torch.cat([f[k] for f in fields]) for k in ("hist", "wts", "sf", "sizes", "codes")}
    pcm = codec.decode(cat["hist"], cat["wts"], cat["sf"], cat["sizes"], cat["codes"],
                       layout.scale_factor_bits, layout.scale_factor_frames, pred_dtype).cpu().numpy()
    out = [None] * len(chunks)
    for row, i in enumerate(full + ragged):
        out[i] = pcm[row, : chunks[i][1]]
    return out


