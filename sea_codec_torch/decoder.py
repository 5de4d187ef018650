"""Streaming decoder session (reference ``src/decoder.rs``).

Reads ``.sea`` from a file-like reader, writes interleaved i16 LE PCM to a
file-like writer, one chunk per ``decode_frame`` call. When the header's
``total_frames`` is zero the stream is decoded until EOF (streaming mode).
Each chunk decodes on ``device`` (the CUDA card by default) through the
chunk decoder model, one kernel launch (or two, on the two-kernel path) per
chunk.
"""

from __future__ import annotations

from .container import SeaChunk, SeaFileHeader
from .models.decoder import DecoderModel
from .utils.device import resolve_device
from .utils.errors import SeaError
from .utils.io import read_max_or_zero


class SeaDecoder:
    def __init__(self, reader, writer, device=None):
        self.device = resolve_device(device)
        self.reader = reader
        self.writer = writer
        self.header = SeaFileHeader.from_reader(reader)
        self.frames_read = 0
        self._model: DecoderModel | None = None
        try:  # chunk region start, for seek(); None on non-seekable readers
            self._chunks_start: int | None = reader.tell()
        except (AttributeError, OSError):
            self._chunks_start = None

    def seek(self, frame: int) -> int:
        """Constant-time seek to the chunk containing ``frame``.

        The format fixes every chunk's byte size precisely to enable this
        (reference ``README.md:88``; upstream lists session seeking under
        "Future plans", ``README.md:125`` — here it is). Positions the
        reader at ``chunks_start + (frame // frames_per_chunk) * chunk_size``
        and returns the chunk-aligned frame index now current; the next
        ``decode_frame()`` emits samples from that frame (callers wanting
        sub-chunk granularity discard ``frame - returned`` leading frames,
        or use ``batch.decode_range`` for a one-shot exact range). Chunks
        carry their own LMS entry state, so decode resumes bit-exactly.
        """
        if self._chunks_start is None:
            raise SeaError("seek requires a seekable reader")
        if frame < 0 or (
            0 < self.header.total_frames < frame
        ):
            raise SeaError(
                f"seek target {frame} outside 0..{self.header.total_frames}"
            )
        chunk_idx = frame // self.header.frames_per_chunk
        try:
            self.reader.seek(self._chunks_start + chunk_idx * self.header.chunk_size)
        except (AttributeError, OSError, ValueError) as e:
            # tell() succeeding in the constructor does not guarantee seek()
            # works (e.g. a forward-only stream); keep the documented error
            # surface instead of leaking the reader's raw exception
            raise SeaError("seek requires a seekable reader") from e
        self.frames_read = chunk_idx * self.header.frames_per_chunk
        return self.frames_read

    def decode_frame(self) -> bool:
        """Decode one chunk; returns False when the stream is exhausted."""
        if self.header.total_frames != 0 and self.header.total_frames <= self.frames_read:
            return False

        remaining = (
            self.header.total_frames - self.frames_read
            if self.header.total_frames > 0
            else None
        )
        encoded = read_max_or_zero(self.reader, self.header.chunk_size)
        if not encoded:
            return False

        chunk = SeaChunk.from_bytes(encoded, self.header, remaining)
        if self._model is None:
            # Lazily sized from the first chunk (reference file.rs:194-199).
            self._model = DecoderModel(
                self.header.channels, chunk.scale_factor_bits, self.device
            )
        samples = self._model.decode_chunk(chunk)
        self.frames_read += samples.shape[0] // self.header.channels
        self.writer.write(samples.astype("<i2").tobytes())
        return True

    def flush(self) -> None:
        try:
            self.writer.flush()
        except (AttributeError, OSError):
            pass

    def finalize(self) -> None:
        self.flush()

    def get_header(self) -> SeaFileHeader:
        return self.header
