"""The lane-packed corpus encode at 64 channels, at the geometry of the
benchmark's ``sea-cbr3-mc64-48k`` and ``sea-vbr3-mc64-48k``
configurations (48 kHz, 2,400 frames a chunk, 3 bits, sfb 4, sff 20; CBR,
and VBR's two-pass search), against the benchmark's plain reference
(``benchmark/reference``: plain torch and numpy, nothing of either codec
package): every byte of every file, the 22-byte header included. Integer
codec: every comparison is exact."""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from reference import codec, tables  # noqa: E402

from sea_codec_torch import EncoderSettings, batch  # noqa: E402

torch.set_num_threads(1)

C, FPC, SR = 64, 2400, 48000
LAYOUT = codec.Layout(channels=C, frames_per_chunk=FPC, scale_factor_bits=4, scale_factor_frames=20,
                      residual_bits=3.0, vbr=False)
SETTINGS = EncoderSettings(residual_bits=3.0, scale_factor_bits=4, scale_factor_frames=20, frames_per_chunk=FPC)
MODES = {"cbr": (LAYOUT, SETTINGS),
         "vbr": (dataclasses.replace(LAYOUT, vbr=True), dataclasses.replace(SETTINGS, vbr=True))}
LENS = [0, 1000, FPC, 2 * FPC + 37]


def _pcm(frames: int, seed: int) -> np.ndarray:
    """Interleaved int16 [frames * C]: three partials a channel, each
    channel its own, over a noise floor, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)[:, None, None] / SR
    freq, gain, phase = rng.uniform(50, 12000, (3, C, 3)), rng.uniform(0.05, 0.3, (C, 3)), rng.uniform(0, 1, (C, 3))
    x = (gain * np.sin(2 * math.pi * (freq[0] * t + phase))).sum(-1) + rng.normal(0, 0.01, (frames, C))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16).reshape(-1)


def _files() -> list[np.ndarray]:
    return [_pcm(n, 640 + i) for i, n in enumerate(LENS)]


@functools.cache
def _reference_encode(mode: str) -> list[bytes]:
    """Each of ``_files`` encoded by the reference in ``mode`` chunk by
    chunk from the encoder's start (VBR: the ranks pass, the sizes and the
    second pass, ``codec.encode``), carrying the LMS state and the previous
    scale factor from each chunk to the next; the chunks of one index
    batched across files."""
    layout = MODES[mode][0]
    files = _files()
    frames = [f.shape[0] // C for f in files]
    n_chunks = [-(-f // FPC) for f in frames]
    w0 = torch.from_numpy(tables.initial_weights()).expand(C, 4)
    state = [(torch.zeros((C, 4), dtype=torch.int64), w0.clone(), torch.zeros(C, dtype=torch.int64))
             for _ in files]
    chunks: list[list[bytes]] = [[] for _ in files]
    for k in range(max(n_chunks)):
        rows = [j for j, n in enumerate(n_chunks) if k < n]
        fk = [min(FPC, frames[j] - k * FPC) for j in rows]
        x = torch.zeros((len(rows), FPC, C), dtype=torch.int64)
        nv = torch.zeros((len(rows), layout.windows(FPC)), dtype=torch.int64)
        for r, (j, f) in enumerate(zip(rows, fk)):
            x[r, :f] = torch.from_numpy(files[j][k * FPC * C : (k * FPC + f) * C].astype(np.int64)).view(f, C)
            nv[r, : layout.windows(f)] = torch.from_numpy(layout.window_frames(f))
        hist0, wts0, prev0 = (torch.stack(s) for s in zip(*(state[j] for j in rows)))
        sf, codes, sizes, hist, wts, prev = codec.encode(layout, x, nv, hist0, wts0, prev0, torch.tensor(fk))
        for r, (j, f) in enumerate(zip(rows, fk)):
            one, w = slice(r, r + 1), layout.windows(f)
            row = codec.serialize(layout, f, hist0[one], wts0[one], sf[one, :w], codes[one, :f],
                                  None if sizes is None else sizes[one, :w])
            chunks[j].append(row[0].numpy().tobytes())
            state[j] = (hist[r], wts[r], prev[r])
    return [codec.header_bytes(layout, SR, f, len(ch[0]) if ch else 0) + b"".join(ch)
            for f, ch in zip(frames, chunks)]


@pytest.mark.parametrize("mode,slab", [
    pytest.param("cbr", None, id="None"), pytest.param("cbr", 1, id="1"),
    pytest.param("vbr", None, id="vbr-None"), pytest.param("vbr", 1, id="vbr-1"),
])
def test_64_channels_match_the_plain_reference(mode, slab, monkeypatch):
    """An empty, a sub-chunk, a one-chunk and a two-chunk-and-tail file of
    64 channels through ``encode_corpus`` (one group of 256 lanes; with
    ``slab`` 1 a device-memory bound of one chunk for those lanes, so the
    group runs in three slabs, or in VBR, which walks whole chunks only,
    two, then the tails): byte-identical to the reference, each header its
    22 bytes (a full VBR chunk is 57,603 bytes: 7,680 items a ranking row)."""
    layout, settings = MODES[mode]
    if slab is not None:
        monkeypatch.setattr(batch, "_GROUP_DEVICE_BYTES", slab * C * len(LENS) * FPC * batch._LANE_FRAME_BYTES)
    assert batch._lane_groups(LENS, C, FPC) == [[3, 2, 1, 0]]
    assert len(batch._slabs(LENS, C, FPC, full_only=layout.vbr)) == ((2 if layout.vbr else 3) if slab else 1)
    got = batch.encode_corpus(_files(), SR, C, settings, device="cpu")
    want = _reference_encode(mode)
    assert layout.chunk_bytes() == (57_603 if layout.vbr else 62_468)
    for g, w, n in zip(got, want, LENS):
        assert g[:22] == w[:22] == codec.header_bytes(layout, SR, n, len(w[22:]) if n < FPC else
                                                      layout.chunk_bytes()), n
        assert g == w, n
    assert len(got[0]) == 22


@pytest.mark.parametrize("channels,fpc", [(64, 5120), (255, 620)])
def test_a_chunk_past_the_u16_chunk_size_is_refused(channels, fpc):
    """At the default 5,120 frames a 64-channel chunk would be 132,100
    bytes, and at 620 a 255-channel one 67,324: past the header's u16
    ``chunk_size``, so ``encode_corpus`` raises as ``encode_sea`` does (the
    64-channel configuration takes 2,400 frames a chunk for this)."""
    from sea_codec_torch.utils.errors import SeaInvalidParameters

    st = EncoderSettings(residual_bits=3.0, scale_factor_bits=4, scale_factor_frames=20, frames_per_chunk=fpc)
    pcm = np.zeros(fpc * channels, np.int16)
    with pytest.raises(SeaInvalidParameters, match="65535"):
        batch.encode_corpus([pcm], SR, channels, st, device="cpu")
    with pytest.raises(SeaInvalidParameters, match="65535"):
        batch.encode_sea(pcm, SR, channels, st, device="cpu")
