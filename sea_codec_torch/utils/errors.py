"""Error types for the SEA codec.

Mirrors the reference's error surface (``src/codec/common.rs:53-70``): one
exception family with variants for the distinct failure modes, raised by the
container parser, the streaming sessions, and the CLI.
"""

from __future__ import annotations


class SeaError(Exception):
    """Base error for all SEA codec failures."""


class SeaReadError(SeaError):
    """Not enough bytes available to satisfy a read."""


class SeaInvalidParameters(SeaError):
    """Encoder/decoder settings outside their valid ranges."""


class SeaInvalidFile(SeaError):
    """Bad magic, version, or header fields."""


class SeaInvalidFrame(SeaError):
    """A chunk that cannot be parsed (bad type byte, short read, ...)."""


class SeaEncoderClosed(SeaError):
    """encode_frame called after the encoder finished."""


class SeaUnsupportedVersion(SeaError):
    """Container version not supported."""


class SeaTooManyFrames(SeaError):
    """total_frames exceeds the u32 container field."""


class SeaMetadataTooLarge(SeaError):
    """Metadata exceeds the u32 size field."""
