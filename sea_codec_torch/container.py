"""The ``.sea`` container: file header and chunk framing (host-side bytes).

Bit-exact reimplementation of the reference format:

- file header:  reference ``src/codec/file.rs:40-93`` and README spec.
- chunk layout: reference ``src/codec/chunk.rs`` --
  4-byte header ``[type, (sfb<<4)|residual_size, sff, 0x5A]``, per-channel
  LMS state (16 bytes each: history[4] then weights[4] as i16 LE, truncated
  from i32), bit-packed scale factors, (VBR only) 2-bit packed residual-size
  deltas stored as ``size - base + 1``, then bit-packed residuals (VBR widths
  vary per scale-factor window).

Compatibility note: the reference *writes* header metadata correctly but its
parser never consumes the metadata bytes due to a zero-length read
(``file.rs:53-55``), so reference-produced files always carry empty metadata.
This implementation follows the spec: it writes ``metadata_size`` + bytes and
consumes exactly ``metadata_size`` bytes on parse.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .ops import bitpack
from .ops.tables import LMS_LEN
from .utils.errors import (
    SeaInvalidFile,
    SeaInvalidFrame,
    SeaInvalidParameters,
    SeaUnsupportedVersion,
)

SEAC_MAGIC = b"seac"  # stored big-endian on disk (reference common.rs:3)

CHUNK_TYPE_CBR = 0x01
CHUNK_TYPE_VBR = 0x02

# magic(4) version(1) channels(1) chunk_size(2) frames_per_chunk(2)
# sample_rate(4) total_frames(4) metadata_size(4) = 22 bytes, then metadata.
HEADER_BASE_LEN = 22


@dataclass
class SeaFileHeader:
    """Parsed ``.sea`` file header (reference src/codec/file.rs:21-30)."""

    version: int = 1
    channels: int = 0
    chunk_size: int = 0
    frames_per_chunk: int = 0
    sample_rate: int = 0
    total_frames: int = 0  # 0 = streaming / unknown
    metadata: str = ""

    def validate(self) -> bool:
        # reference src/codec/file.rs:33-38
        return (
            self.channels > 0
            and self.chunk_size >= 16
            and self.frames_per_chunk > 0
            and self.sample_rate > 0
        )

    def serialize(self) -> bytes:
        out = bytearray()
        out += SEAC_MAGIC
        out += self.version.to_bytes(1, "little")
        out += self.channels.to_bytes(1, "little")
        out += self.chunk_size.to_bytes(2, "little")
        out += self.frames_per_chunk.to_bytes(2, "little")
        out += self.sample_rate.to_bytes(4, "little")
        out += self.total_frames.to_bytes(4, "little")
        meta = self.metadata.encode("utf-8")
        out += len(meta).to_bytes(4, "little")
        out += meta
        return bytes(out)

    @property
    def serialized_len(self) -> int:
        return HEADER_BASE_LEN + len(self.metadata.encode("utf-8"))

    @classmethod
    def from_reader(cls, reader) -> "SeaFileHeader":
        """Parse from a file-like object (reference src/codec/file.rs:40-72)."""
        head = reader.read(18)
        if len(head) < 18:
            raise SeaInvalidFile("short header")
        if head[0:4] != SEAC_MAGIC:
            raise SeaInvalidFile("bad magic")
        version = head[4]
        if version != 1:
            raise SeaUnsupportedVersion(f"version {version}")
        channels = head[5]
        chunk_size = int.from_bytes(head[6:8], "little")
        frames_per_chunk = int.from_bytes(head[8:10], "little")
        sample_rate = int.from_bytes(head[10:14], "little")
        total_frames = int.from_bytes(head[14:18], "little")
        meta_size_b = reader.read(4)
        if len(meta_size_b) < 4:
            raise SeaInvalidFile("short header (metadata size)")
        metadata_size = int.from_bytes(meta_size_b, "little")
        metadata = b""
        if metadata_size:
            metadata = reader.read(metadata_size)
            if len(metadata) < metadata_size:
                raise SeaInvalidFile("short metadata")
        try:
            metadata_str = metadata.decode("utf-8")
        except UnicodeDecodeError as e:
            raise SeaInvalidFile("metadata is not valid UTF-8") from e
        header = cls(
            version=version,
            channels=channels,
            chunk_size=chunk_size,
            frames_per_chunk=frames_per_chunk,
            sample_rate=sample_rate,
            total_frames=total_frames,
            metadata=metadata_str,
        )
        if not header.validate():
            raise SeaInvalidFile("invalid header fields")
        return header


def scale_factor_items(frames_in_chunk: int, scale_factor_frames: int, channels: int) -> int:
    """Number of (window, channel) scale-factor entries in a chunk."""
    return -(-frames_in_chunk // scale_factor_frames) * channels


@dataclass
class SeaChunk:
    """One parsed/constructed chunk (reference src/codec/chunk.rs:20-35).

    ``lms_history``/``lms_weights`` are int32[channels, 4] (already widened
    from the serialized i16). ``scale_factors`` / ``residuals`` are uint8
    codes; ``vbr_residual_sizes`` holds *absolute* sizes (1..8), empty for CBR.
    A parsed chunk also keeps its residual section as packed on the wire
    (``residual_bytes``), the layout the decode kernels read.
    """

    channels: int
    frames_in_chunk: int
    chunk_type: int
    scale_factor_bits: int
    scale_factor_frames: int
    residual_size: int
    lms_history: np.ndarray
    lms_weights: np.ndarray
    scale_factors: np.ndarray
    vbr_residual_sizes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    residual_bytes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    # -- serialization ------------------------------------------------------

    def serialize(self) -> bytes:
        # header (reference chunk.rs:215-226)
        if self.scale_factor_bits <= 0 or self.scale_factor_frames <= 0:
            raise SeaInvalidParameters(
                f"chunk needs scale_factor_bits/frames > 0, got "
                f"{self.scale_factor_bits}/{self.scale_factor_frames}"
            )
        out = bytearray()
        out += bytes(
            [
                self.chunk_type,
                ((self.scale_factor_bits << 4) | self.residual_size) & 0xFF,
                self.scale_factor_frames,
                0x5A,
            ]
        )
        # per-channel LMS, i16 LE truncated from i32 (reference lms.rs:64-78)
        lms = np.empty((self.channels, 2 * LMS_LEN), dtype=np.int16)
        lms[:, :LMS_LEN] = self.lms_history.astype(np.int64).astype(np.int16)
        lms[:, LMS_LEN:] = self.lms_weights.astype(np.int64).astype(np.int16)
        out += lms.astype("<i2").tobytes()
        # scale factors (reference chunk.rs:237-243)
        out += bitpack.pack_bits(self.scale_factors, self.scale_factor_bits).tobytes()
        if self.chunk_type == CHUNK_TYPE_VBR:
            # 2-bit deltas, stored as size - base + 1 (reference chunk.rs:245-252)
            rel = self.vbr_residual_sizes.astype(np.int32) - self.residual_size + 1
            if not np.all((rel >= 0) & (rel < 4)):
                raise SeaInvalidParameters(
                    "VBR residual sizes must lie within base-1..base+2 "
                    "(the 2-bit delta encoding, reference chunk.rs:245-252)"
                )
            out += bitpack.pack_bits(rel.astype(np.uint32), 2).tobytes()
            # residuals with per-window-per-channel widths (reference chunk.rs:254-271)
            widths = self._per_sample_widths()
            out += bitpack.pack_bits(self.residuals, widths).tobytes()
        else:
            out += bitpack.pack_bits(self.residuals, self.residual_size).tobytes()
        return bytes(out)

    def _per_sample_widths(self) -> np.ndarray:
        """Per-sample residual bit widths [frames*channels] from VBR sizes."""
        sizes = self.vbr_residual_sizes.reshape(-1, self.channels)  # [n_win, C]
        reps = np.full(sizes.shape[0], self.scale_factor_frames, dtype=np.int64)
        tail = self.frames_in_chunk - (sizes.shape[0] - 1) * self.scale_factor_frames
        reps[-1] = tail
        return np.repeat(sizes, reps, axis=0).reshape(-1)

    # -- parsing ------------------------------------------------------------

    @classmethod
    def from_bytes(
        cls,
        encoded: bytes,
        header: SeaFileHeader,
        remaining_frames: int | None,
    ) -> "SeaChunk":
        """Parse one chunk (reference src/codec/chunk.rs:69-213)."""
        if len(encoded) > header.chunk_size:
            raise SeaInvalidFrame("chunk larger than chunk_size")
        # in streaming mode we cannot size a short final chunk (chunk.rs:76-79)
        if remaining_frames is None and len(encoded) < header.chunk_size:
            raise SeaInvalidFrame("short chunk in streaming mode")
        if len(encoded) < 4:
            raise SeaInvalidFrame("chunk too short")
        chunk_type = encoded[0]
        if chunk_type not in (CHUNK_TYPE_CBR, CHUNK_TYPE_VBR):
            raise SeaInvalidFrame(f"bad chunk type {chunk_type:#x}")
        scale_factor_bits = encoded[1] >> 4
        residual_size = encoded[1] & 0x0F
        if not 1 <= scale_factor_bits <= 8:
            raise SeaInvalidFrame(f"bad scale factor bits {scale_factor_bits}")
        if not 1 <= residual_size <= 8:
            raise SeaInvalidFrame(f"bad residual size {residual_size}")
        scale_factor_frames = encoded[2]
        if scale_factor_frames == 0:
            raise SeaInvalidFrame("zero scale_factor_frames")
        # encoded[3] reserved (0x5A)

        channels = header.channels
        pos = 4
        lms_bytes = channels * LMS_LEN * 4
        if len(encoded) < pos + lms_bytes:
            raise SeaInvalidFrame("chunk too short for LMS state")
        lms = np.frombuffer(encoded, dtype="<i2", count=channels * 2 * LMS_LEN, offset=pos)
        lms = lms.reshape(channels, 2 * LMS_LEN).astype(np.int32)
        pos += lms_bytes

        frames_in_chunk = header.frames_per_chunk
        if remaining_frames is not None:
            frames_in_chunk = min(frames_in_chunk, remaining_frames)
        sf_items = scale_factor_items(frames_in_chunk, scale_factor_frames, channels)

        sf_bytes = bitpack.packed_byte_len(scale_factor_bits, sf_items)
        if len(encoded) < pos + sf_bytes:
            raise SeaInvalidFrame("chunk too short for scale factors")
        sf_packed = np.frombuffer(encoded, dtype=np.uint8, count=sf_bytes, offset=pos)
        pos += sf_bytes
        scale_factors_arr = bitpack.unpack_bits(sf_packed, scale_factor_bits, count=sf_items)

        if chunk_type == CHUNK_TYPE_VBR:
            vbr_bytes = bitpack.packed_byte_len(2, sf_items)
            if len(encoded) < pos + vbr_bytes:
                raise SeaInvalidFrame("chunk too short for vbr sizes")
            vbr_packed = np.frombuffer(encoded, dtype=np.uint8, count=vbr_bytes, offset=pos)
            pos += vbr_bytes
            # stored value + base - 1 gives the absolute size (chunk.rs:136-139)
            vbr_sizes = (
                bitpack.unpack_bits(vbr_packed, 2, count=sf_items).astype(np.int32)
                + residual_size
                - 1
            ).astype(np.uint8)
            if np.any((vbr_sizes < 1) | (vbr_sizes > 8)):
                raise SeaInvalidFrame("bad vbr residual size")
        else:
            vbr_sizes = np.zeros(0, dtype=np.uint8)

        n_samples = frames_in_chunk * channels
        chunk = cls(
            channels=channels,
            frames_in_chunk=frames_in_chunk,
            chunk_type=chunk_type,
            scale_factor_bits=scale_factor_bits,
            scale_factor_frames=scale_factor_frames,
            residual_size=residual_size,
            lms_history=np.ascontiguousarray(lms[:, :LMS_LEN]),
            lms_weights=np.ascontiguousarray(lms[:, LMS_LEN:]),
            scale_factors=scale_factors_arr,
            vbr_residual_sizes=vbr_sizes,
        )
        if chunk_type == CHUNK_TYPE_VBR:
            widths = chunk._per_sample_widths()
            res_bytes = bitpack.packed_byte_len(widths)
            if len(encoded) < pos + res_bytes:
                raise SeaInvalidFrame("chunk too short for residuals")
            res_packed = np.frombuffer(encoded, dtype=np.uint8, count=res_bytes, offset=pos)
            chunk.residuals = bitpack.unpack_bits(res_packed, widths)
        else:
            res_bytes = bitpack.packed_byte_len(residual_size, n_samples)
            if len(encoded) < pos + res_bytes:
                raise SeaInvalidFrame("chunk too short for residuals")
            res_packed = np.frombuffer(encoded, dtype=np.uint8, count=res_bytes, offset=pos)
            chunk.residuals = bitpack.unpack_bits(res_packed, residual_size, count=n_samples)
        chunk.residual_bytes = res_packed
        return chunk
