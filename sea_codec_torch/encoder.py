"""Encoder settings, input validation and the streaming encoder session
(reference ``src/encoder.rs``).

``SeaEncoder`` reads interleaved i16 LE PCM from a file-like reader and
writes ``.sea`` to a file-like writer, one chunk per ``encode_frame`` call:
on the card that is one search launch per chunk for CBR and two for VBR.
The file header is written after the first chunk (so ``chunk_size`` is
known) except in explicit streaming mode (``total_frames == 0``), where it
is written upfront with ``chunk_size`` still 0 (reference
``encoder.rs:70-77,134-138``). The one-shot API's batch engine encodes
whole files through ``batch.encode_sea`` instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from .container import CHUNK_TYPE_CBR, CHUNK_TYPE_VBR, SeaChunk, SeaFileHeader
from .models.cbr import CbrEncoderModel
from .models.common import EncoderBaseState
from .models.vbr import VbrEncoderModel
from .utils.device import resolve_device
from .utils.errors import (
    SeaEncoderClosed,
    SeaError,
    SeaInvalidParameters,
    SeaReadError,
)
from .utils.io import read_max_or_zero


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


class _State(Enum):
    START = 0
    WRITING_FRAMES = 1
    FINISHED = 2


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


class SeaEncoder:
    def __init__(
        self,
        channels: int,
        sample_rate: int,
        total_frames: int | None,
        settings: EncoderSettings,
        reader,
        writer,
        device=None,
    ):
        validate_encode_params(channels, settings, total_frames)
        device = resolve_device(device)

        self.settings = settings
        self.reader = reader
        self.writer = writer
        self.header = SeaFileHeader(
            version=1,
            channels=channels,
            chunk_size=0,  # discovered from the first chunk
            frames_per_chunk=settings.frames_per_chunk,
            sample_rate=sample_rate,
            total_frames=total_frames if total_frames is not None else 0,
            metadata=settings.metadata,
        )
        # the models take the carried state (LMS, previous scale factor)
        # as an argument and hand back the advanced one after each chunk
        state = EncoderBaseState.initial(channels, device)
        args = (channels, settings.scale_factor_bits, settings.scale_factor_frames,
                settings.residual_bits)
        if settings.vbr:
            self.model = VbrEncoderModel(*args, settings.frames_per_chunk, state)
        else:
            self.model = CbrEncoderModel(*args, state)
        self.state = _State.START
        self.written_frames = 0
        # Streaming mode (explicit total_frames == 0): header upfront.
        if total_frames == 0:
            self.writer.write(self.header.serialize())
            self.state = _State.WRITING_FRAMES

    def _read_samples(self, max_sample_count: int) -> np.ndarray:
        buffer = read_max_or_zero(self.reader, max_sample_count * 2)
        if not buffer:
            return np.zeros(0, dtype=np.int16)
        if len(buffer) % (2 * self.header.channels) != 0:
            raise SeaReadError("ragged sample bytes (unexpected EOF)")
        return np.frombuffer(buffer, dtype="<i2")

    def _make_chunk(self, samples: np.ndarray) -> bytes:
        # Snapshot LMS *before* encoding: the chunk header carries entry
        # state (reference src/codec/file.rs:146-149).
        hist, wts = self.model.lms_snapshot
        encoded = self.model.encode(samples)
        is_vbr = encoded.residual_bits.size > 0
        frames = samples.shape[0] // self.header.channels
        chunk = SeaChunk(
            channels=self.header.channels,
            frames_in_chunk=frames,
            chunk_type=CHUNK_TYPE_VBR if is_vbr else CHUNK_TYPE_CBR,
            scale_factor_bits=self.settings.scale_factor_bits,
            scale_factor_frames=self.settings.scale_factor_frames,
            residual_size=self.model.chunk_residual_size,
            lms_history=hist,
            lms_weights=wts,
            scale_factors=encoded.scale_factors,
            vbr_residual_sizes=encoded.residual_bits,
            residuals=encoded.residuals,
        )
        out = chunk.serialize()
        if len(out) > 0xFFFF:
            raise SeaInvalidParameters(
                "chunk serializes to more than 65535 bytes (the chunk_size "
                "header field is u16; the reference silently truncates and "
                "corrupts such files) -- reduce frames_per_chunk, channels, "
                "or bitrate"
            )
        if self.header.chunk_size == 0:
            self.header.chunk_size = len(out)
        if frames == self.header.frames_per_chunk and len(out) != self.header.chunk_size:
            # The reference surfaces this as a Result error, not a panic
            # (encoder.rs:128-132); a bare assert would vanish under -O.
            raise SeaError(
                f"full chunk serialized to {len(out)} bytes, expected "
                f"{self.header.chunk_size} (inconsistent encoder state)"
            )
        return out

    def encode_frame(self) -> bool:
        """Encode one chunk; returns False once the input is exhausted."""
        if self.state is _State.FINISHED:
            raise SeaEncoderClosed("encoder already finished")

        channels = self.header.channels
        if self.header.total_frames > 0:
            frames = min(
                self.header.frames_per_chunk,
                self.header.total_frames - self.written_frames,
            )
        else:
            frames = self.header.frames_per_chunk

        full_size_samples = self.header.frames_per_chunk * channels
        samples = self._read_samples(frames * channels)
        eof = samples.size == 0 or samples.size < full_size_samples

        if samples.size:
            encoded_chunk = self._make_chunk(samples)
            ok = (
                len(encoded_chunk) <= self.header.chunk_size
                if eof
                else len(encoded_chunk) == self.header.chunk_size
            )
            if not ok:
                raise SeaError(
                    f"chunk serialized to {len(encoded_chunk)} bytes, "
                    f"expected {'<=' if eof else '=='} "
                    f"{self.header.chunk_size} (encoder.rs:128-132 surfaces "
                    "this as an error, never silent corruption)"
                )
            if self.state is _State.START:
                self.writer.write(self.header.serialize())
                self.state = _State.WRITING_FRAMES
            self.writer.write(encoded_chunk)
            self.written_frames += samples.size // channels

        if eof:
            self.state = _State.FINISHED
        return not eof

    def flush(self) -> None:
        try:
            self.writer.flush()
        except (AttributeError, OSError):
            pass

    def finalize(self) -> None:
        if hasattr(self.writer, "flush"):
            self.writer.flush()
        self.state = _State.FINISHED
