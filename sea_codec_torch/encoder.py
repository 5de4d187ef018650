"""Encoder settings and input validation (reference ``src/encoder.rs``).

The streaming ``SeaEncoder`` session of the JAX package is not ported yet
(see ROADMAP.md); the one-shot API encodes CBR and VBR through
``batch.encode_sea``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .utils.errors import SeaInvalidParameters


@dataclass
class EncoderSettings:
    """Mirrors the reference ``EncoderSettings`` (``encoder.rs:16-35``).

    ``metadata`` is an extension: UTF-8 ``key=value\\n`` pairs stored in the
    file header (the reference format reserves the field but its encoder API
    never populates it).
    """

    scale_factor_bits: int = 4
    scale_factor_frames: int = 20
    residual_bits: float = 3.0  # 1-8 (CBR: integer; VBR: 1.5-8.0)
    frames_per_chunk: int = 5120
    vbr: bool = False
    metadata: str = ""


def validate_encode_params(
    channels: int, settings: EncoderSettings, total_frames: int | None = None
) -> None:
    """Parameter validation shared by every encode engine: the reference
    rejects these in ``SeaEncoder``/CLI, so the fast engines fail with the
    same ``SeaError`` surface, not internal shape errors."""
    if not (1 <= channels <= 255):
        raise SeaInvalidParameters("channels must be 1..=255")
    if settings.frames_per_chunk <= 0 or settings.scale_factor_frames <= 0:
        raise SeaInvalidParameters("frames_per_chunk/scale_factor_frames must be > 0")
    if settings.frames_per_chunk % settings.scale_factor_frames != 0:
        raise SeaInvalidParameters("scale_factor_frames must divide frames_per_chunk")
    if not 1 <= settings.scale_factor_bits <= 8:
        raise SeaInvalidParameters("scale_factor_bits must be 1..=8")
    if not 1.0 <= settings.residual_bits <= 8.0:
        raise SeaInvalidParameters("residual_bits must be in 1..=8")
    if total_frames is not None and total_frames > 0xFFFFFFFF:
        from .utils.errors import SeaTooManyFrames

        raise SeaTooManyFrames("total_frames exceeds the u32 header field")
    if len(settings.metadata.encode("utf-8")) > 0xFFFFFFFF:
        from .utils.errors import SeaMetadataTooLarge

        raise SeaMetadataTooLarge("metadata exceeds the u32 size field")


def coerce_samples(input_samples) -> np.ndarray:
    """Validate/convert encode input to a 1-D int16 array.

    A bare ``np.asarray(x, dtype=np.int16)`` would silently truncate float
    PCM (normalized [-1, 1] floats become all-zero samples) and a 2-D array
    would surface as an internal reshape ValueError."""
    arr = np.asarray(input_samples)
    if arr.ndim != 1:
        raise SeaInvalidParameters(
            f"samples must be a 1-D interleaved array (got {arr.ndim}-D)"
        )
    if arr.dtype == np.int16:
        return arr
    if not np.issubdtype(arr.dtype, np.integer):
        raise SeaInvalidParameters(
            f"samples must be int16, got {arr.dtype}; convert float PCM "
            "explicitly (e.g. np.clip(np.round(x * 32767), -32768, 32767)"
            ".astype(np.int16))"
        )
    if arr.size and (int(arr.max()) > 32767 or int(arr.min()) < -32768):
        raise SeaInvalidParameters("integer samples exceed the int16 range")
    return arr.astype(np.int16)
