"""Small host I/O helpers (reference ``src/codec/common.rs:103-123``)."""

from __future__ import annotations


def read_max_or_zero(reader, at_least_bytes: int) -> bytes:
    """Read up to ``at_least_bytes``; returns b'' only on immediate EOF.

    Keeps reading until the buffer is full or EOF, matching the reference's
    read loop semantics over short reads.
    """
    chunks: list[bytes] = []
    total = 0
    while total < at_least_bytes:
        data = reader.read(at_least_bytes - total)
        if not data:
            break
        chunks.append(data)
        total += len(data)
    return b"".join(chunks)
