"""The one traffic generator: a mix's data file -> the inputs of a run.

A mix (``benchmark/traffic/<name>.json``) names the program's entry it
drives and its sizes. Inputs are made on the device from ``--seed`` and
handed over as the entry's driver (``benchmark/entries/<entry>.py``) says
it takes them (``inputs``): ``pcm``, int16 PCM as numpy arrays, or
``sea``, ``.sea`` files as ``bytes``.

Keys of a mix:

- ``entry``: the name of the driver file.
- ``files``: files a call (a corpus) or held for requests (a seek).
- ``seconds``: [shortest, longest] file length. Lengths are spread evenly
  over the range (the i-th of n at (i + 1/2)/n of it), in an order drawn
  from the seed, so that every seed does the same work.
- ``tones_seed`` (encodes): fixes each track's partials (``tones``); the
  run's seed draws their phases, the noise floor and the order.
- ``range_frames`` (optional): frames a request returns; requests
  (``Traffic.requests``) are drawn ahead, each at a frame drawn uniformly
  over a file drawn uniformly.

The ``.sea`` files are written by the benchmark's own plain writer
(``write_sea``), never by the program: it draws each chunk's fields in the
ranges an encoder leaves (an LMS entry state near the encoder's usual
weights, scale factors around a per-chunk level, codes that favour small
residuals, VBR sizes as the size distribution of ``encoder_vbr.rs`` counts
them, in a drawn order) and packs them with ``reference.codec``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from reference import codec

INPUTS = ("pcm", "sea")
_WRITE_BLOCK_ROWS = 1024
_REQUESTS = 200_000  # drawn ahead; a window takes its first few hundred in order


@dataclass
class Traffic:
    entry: str
    layout: codec.Layout
    sample_rate: int
    params: dict
    frames: list[int]  # per file
    pcm: list[np.ndarray] = field(default_factory=list)  # encode inputs
    files: list[bytes] = field(default_factory=list)  # decode and seek inputs
    tail_bits: list[int] = field(default_factory=list)  # residual bits of each file's tail chunk
    requests: np.ndarray | None = None  # seek: int64 [n, 2] (file, start frame)

    @property
    def samples_per_call(self) -> int:
        return sum(self.frames) * self.layout.channels


def layout_of(config: dict) -> codec.Layout:
    s = config["settings"]
    return codec.Layout(
        channels=int(config["channels"]), frames_per_chunk=int(s["frames_per_chunk"]),
        scale_factor_bits=int(s["scale_factor_bits"]), scale_factor_frames=int(s["scale_factor_frames"]),
        residual_bits=float(s["residual_bits"]), vbr=bool(s["vbr"]),
    )


def file_frames(params: dict, sample_rate: int) -> list[int]:
    n = int(params["files"])
    lo, hi = (float(x) for x in params["seconds"])
    return [round(sample_rate * (lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]


def tones(params: dict, i: int) -> list[tuple[float, float, float, bool]]:
    """The i-th track's six partials (frequency, envelope rate, gain,
    squared off), fixed by the mix's ``tones_seed`` so that every run seed
    encodes the same set of tracks: the search's work depends a little on
    the signal (the weights penalty), and a seed may change the inputs but
    not the work."""
    rng = np.random.default_rng([int(params["tones_seed"]), i])
    return [(rng.uniform(50.0, 12000.0), rng.uniform(0.05, 0.5), rng.uniform(0.05, 0.3), bool(rng.random() < 0.3))
            for _ in range(6)]


def music(frames: int, channels: int, sample_rate: int, partials, rng: np.random.Generator, g: torch.Generator):
    """Interleaved int16 [frames * channels]: ``partials`` under slow
    envelopes with phases drawn from ``rng``, a noise floor drawn from
    ``g``, each further channel delayed by 10 ms."""
    dev = g.device
    t = torch.arange(frames, dtype=torch.float64, device=dev) / sample_rate
    mono = torch.zeros(frames, dtype=torch.float64, device=dev)
    for f, fe, gain, square in partials:
        wave = torch.sin(2 * math.pi * torch.frac(f * t + rng.random()))
        if square:
            wave = torch.sign(wave)
        mono += gain * (0.5 + 0.5 * torch.sin(2 * math.pi * fe * t + rng.uniform(0, 2 * math.pi))) * wave
    mono += 0.01 * torch.randn(frames, generator=g, dtype=torch.float64, device=dev)
    delay = sample_rate // 100
    pcm = torch.zeros((frames, channels), dtype=torch.float64, device=dev)
    for ch in range(channels):
        pcm[ch * delay:, ch] = mono[: frames - ch * delay]
    return (pcm * 32767.0).clamp(-32768, 32767).to(torch.int16).reshape(-1).cpu().numpy()


def _draw_rows(layout: codec.Layout, r: int, frames: int, g: torch.Generator):
    """Fields of ``r`` chunks of ``frames`` frames, packed: uint8 [r, bytes],
    and the residual bits of one row."""
    dev = g.device
    c, w, s = layout.channels, layout.windows(frames), 1 << layout.scale_factor_bits
    i64 = dict(dtype=torch.int64, device=dev, generator=g)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    hist = (randn(r, c, 4) * 6000).round().clamp(-32768, 32767).long()
    spread = torch.tensor([1500.0, 1500.0, 3000.0, 3000.0], device=dev)
    wts = (torch.tensor([0.0, 0.0, -8192.0, 16384.0], device=dev) + randn(r, c, 4) * spread)
    wts = wts.round().clamp(-24000, 24000).long()
    level = torch.randint(0, 10, (r, 1, 1), **i64)
    sf = (level + torch.randint(-2, 3, (r, w, c), **i64)).clamp(0, s - 1)
    if layout.vbr:
        sortable, m1, t, p1, p2 = layout.size_counts(frames)
        b = layout.base
        multiset = torch.tensor([b - 1] * m1 + [b] * t + [b + 1] * p1 + [b + 2] * p2, device=dev)
        order = torch.argsort(torch.rand(r, sortable, generator=g, device=dev), dim=1)
        sizes = torch.full((r, w * c), b, dtype=torch.int64, device=dev)
        sizes[:, :sortable] = multiset[order]
        sizes = sizes.clamp(1, 8).view(r, w, c)
        widths = codec.sample_widths(sizes, layout.scale_factor_frames, frames).view(r, frames, c)
    else:
        sizes = None
        widths = torch.full((1, 1, 1), layout.header_rs, dtype=torch.int64, device=dev)
    # magnitude index k with P(k) falling by 0.45 a step, capped by the width
    u = torch.rand(r, frames, c, generator=g, device=dev).clamp_min(1e-12)
    k = torch.floor(torch.log(u) / math.log(0.45)).long()
    k = torch.minimum(k, (1 << (widths - 1)) - 1)
    codes = 2 * k + torch.randint(0, 2, (r, frames, c), **i64)
    bits = int(widths.expand(r, frames, c)[0].sum())
    return codec.serialize(layout, frames, hist, wts, sf, codes, sizes), bits


def write_sea(layout: codec.Layout, frames: int, sample_rate: int, g: torch.Generator) -> tuple[bytes, int]:
    """A ``.sea`` file of ``frames`` frames with drawn fields; returns it and
    the residual bits of its tail chunk (0 without one)."""
    fpc = layout.frames_per_chunk
    n_full, tail = divmod(frames, fpc)
    body = []
    for start in range(0, n_full, _WRITE_BLOCK_ROWS):
        rows, _bits = _draw_rows(layout, min(_WRITE_BLOCK_ROWS, n_full - start), fpc, g)
        body.append(rows.cpu().numpy().tobytes())
    tail_bits = 0
    if tail:
        row, tail_bits = _draw_rows(layout, 1, tail, g)
        body.append(row.cpu().numpy().tobytes())
    chunk_size = layout.chunk_bytes() if n_full else len(body[-1])
    return codec.header_bytes(layout, sample_rate, frames, chunk_size) + b"".join(body), tail_bits


def make(config: dict, params: dict, seed: int, device, inputs: str) -> Traffic:
    """The inputs of one run of a cell, of the kind ``inputs`` names."""
    entry = params["entry"]
    if inputs not in INPUTS:
        raise ValueError(f"unknown inputs {inputs!r}: {INPUTS}")
    layout = layout_of(config)
    sr = int(config["sample_rate"])
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    order = rng.permutation(int(params["files"]))  # file j is the mix's track order[j]
    frames = [file_frames(params, sr)[i] for i in order]
    tr = Traffic(entry=entry, layout=layout, sample_rate=sr, params=params, frames=frames)
    if inputs == "pcm":
        tr.pcm = [music(f, layout.channels, sr, tones(params, int(i)), rng, g) for f, i in zip(frames, order)]
    else:
        for f in frames:
            blob, bits = write_sea(layout, f, sr, g)
            tr.files.append(blob)
            tr.tail_bits.append(bits)
    if "range_frames" in params:
        n = _REQUESTS
        span = int(params["range_frames"])
        which = rng.integers(0, len(frames), n)
        start = rng.integers(0, np.asarray(frames)[which] - span + 1)
        tr.requests = np.stack([which, start], axis=1)
    return tr
