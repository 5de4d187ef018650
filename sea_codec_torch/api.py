"""One-shot API (reference ``src/lib.rs:13-63``).

Both calls run on the CUDA card unless the caller passes ``device``;
``device="cpu"`` runs the plain PyTorch versions of the kernels. The batch
engine is ported, CBR and VBR; ``engine="session"`` raises
``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SeaDecodeInfo:
    samples: np.ndarray  # int16, interleaved
    sample_rate: int
    channels: int


def _check_engine(engine: str) -> None:
    if engine == "session":
        raise NotImplementedError(
            "the streaming session engine is not ported yet (see ROADMAP.md, Queue A)"
        )
    if engine not in ("auto", "batch"):
        raise ValueError(f"engine must be 'auto', 'batch', or 'session', got {engine!r}")


def sea_encode(
    input_samples,
    sample_rate: int,
    channels: int,
    settings: "EncoderSettings | None" = None,
    engine: str = "auto",
    device=None,
) -> bytes:
    """Encode interleaved i16 samples to ``.sea`` bytes."""
    from .batch import encode_sea
    from .encoder import coerce_samples

    _check_engine(engine)
    return encode_sea(coerce_samples(input_samples), sample_rate, channels, settings, device)


def sea_decode(encoded: bytes, engine: str = "auto", device=None) -> SeaDecodeInfo:
    """Decode ``.sea`` bytes to interleaved i16 samples."""
    from .batch import decode_sea

    _check_engine(engine)
    return decode_sea(encoded, device=device)
