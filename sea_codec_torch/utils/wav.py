"""Minimal WAV reader/writer (no external deps).

Input conversion semantics follow the reference WAV utility
(``tests/wav.rs:11-50``): 8-bit -> ``<< 8``, 16-bit passthrough,
24-bit -> ``round(s / 2^23 * 32767)``, 32-bit int -> ``round(s / i32::MAX *
32767)``, float32 -> ``round(s * 32767)`` (saturating). Output is always
16-bit integer PCM. Unlike the reference (which rejects > 2 channels), any
channel count up to 255 is accepted.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Wave:
    samples: np.ndarray  # int16, interleaved
    channels: int
    sample_rate: int


def _saturate_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767).astype(np.int16)


def _round_half_away_f32(x: np.ndarray) -> np.ndarray:
    """Round half away from zero in float32 -- the semantics of Rust's
    ``f32::round`` used by the reference converter (``tests/wav.rs:20-41``).
    ``np.round`` is half-to-even and differs on exact .5 values."""
    x = x.astype(np.float32, copy=False)
    return np.where(
        x >= 0,
        np.floor(x + np.float32(0.5)),
        np.ceil(x - np.float32(0.5)),
    )


def read_wav(path: str) -> Wave:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError("missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = int.from_bytes(fmt[24:26], "little")

    if audio_format == 1:  # PCM int
        if bits == 8:
            raw = np.frombuffer(payload, dtype=np.uint8)
            samples = ((raw.astype(np.int16) - 128) << 8).astype(np.int16)
        elif bits == 16:
            samples = np.frombuffer(payload, dtype="<i2").astype(np.int16)
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            s32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            s32 = np.where(s32 >= 1 << 23, s32 - (1 << 24), s32)
            f = s32.astype(np.float32) / np.float32(1 << 23)
            samples = _saturate_i16(_round_half_away_f32(f * np.float32(32767.0)))
        elif bits == 32:
            s32 = np.frombuffer(payload, dtype="<i4")
            f = s32.astype(np.float32) / np.float32(2147483647)
            samples = _saturate_i16(_round_half_away_f32(f * np.float32(32767.0)))
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3 and bits == 32:  # IEEE float
        f = np.frombuffer(payload, dtype="<f4")
        samples = _saturate_i16(_round_half_away_f32(f * np.float32(32767.0)))
    else:
        raise ValueError(f"unsupported format {audio_format} with {bits} bits")

    frames = samples.shape[0] // channels
    return Wave(samples=samples[: frames * channels], channels=channels, sample_rate=sample_rate)


def write_wav(samples: np.ndarray, channels: int, sample_rate: int, path: str) -> None:
    """Write 16-bit integer PCM (reference tests/wav.rs:52-75)."""
    samples = np.asarray(samples, dtype=np.int16)
    payload = samples.astype("<i2").tobytes()
    byte_rate = sample_rate * channels * 2
    block_align = channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write((36 + len(payload)).to_bytes(4, "little"))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write((16).to_bytes(4, "little"))
        f.write(struct.pack("<HHIIHH", 1, channels, sample_rate, byte_rate, block_align, 16))
        f.write(b"data")
        f.write(len(payload).to_bytes(4, "little"))
        f.write(payload)
