"""One-shot API (reference ``src/lib.rs:13-63``).

Both calls run on the CUDA card unless the caller passes ``device``;
``device="cpu"`` runs the plain PyTorch versions of the kernels. By default
they take the batch paths (whole-file encode, chunk-parallel decode);
``engine="session"`` goes through the streaming sessions instead, a chunk
at a time as the reference does. Both engines give the same bytes and the
same PCM (tested).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


@dataclass
class SeaDecodeInfo:
    samples: np.ndarray  # int16, interleaved
    sample_rate: int
    channels: int


def _is_session(engine: str) -> bool:
    if engine not in ("auto", "batch", "session"):
        raise ValueError(f"engine must be 'auto', 'batch', or 'session', got {engine!r}")
    return engine == "session"


def sea_encode(
    input_samples,
    sample_rate: int,
    channels: int,
    settings: "EncoderSettings | None" = None,
    engine: str = "auto",
    device=None,
) -> bytes:
    """Encode interleaved i16 samples to ``.sea`` bytes."""
    from .encoder import EncoderSettings, SeaEncoder, coerce_samples

    if settings is None:
        settings = EncoderSettings()
    samples = coerce_samples(input_samples)
    if not _is_session(engine):
        from .batch import encode_sea

        return encode_sea(samples, sample_rate, channels, settings, device)
    reader = io.BytesIO(samples.astype("<i2").tobytes())
    writer = io.BytesIO()
    enc = SeaEncoder(
        channels, sample_rate, samples.shape[0] // channels, settings, reader, writer, device
    )
    while enc.encode_frame():
        pass
    enc.finalize()
    return writer.getvalue()


def sea_decode(encoded: bytes, engine: str = "auto", device=None) -> SeaDecodeInfo:
    """Decode ``.sea`` bytes to interleaved i16 samples."""
    if not _is_session(engine):
        from .batch import decode_sea

        return decode_sea(encoded, device=device)
    from .decoder import SeaDecoder

    writer = io.BytesIO()
    dec = SeaDecoder(io.BytesIO(encoded), writer, device)
    while dec.decode_frame():
        pass
    dec.finalize()
    header = dec.get_header()
    samples = np.frombuffer(writer.getvalue(), dtype="<i2")
    return SeaDecodeInfo(
        samples=samples, sample_rate=header.sample_rate, channels=header.channels
    )
