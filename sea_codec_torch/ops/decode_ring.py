"""Geometry of the recurrence ring that the three decode kernels share
(``csrc/decode_ring.cuh``: ``fused_decode_cbr.cu``, ``fused_decode_vbr.cu``,
``lms_decode.cu``).

A block decodes ``chunks_per_block(C)`` chunks, so that its (chunk, channel)
streams fill one recurrence warp up to 16 channels, in tiles of
``tile_frames(C)`` frames. Its shared memory starts with the barriers, a dq
ring and a PCM ring of ``SLOTS`` slots each; the kernels' launchers size it
the same way, and the wrappers' gates and the tests read the sizes here.
"""

from __future__ import annotations

SLOTS = 2  # ring depth, dq tiles and PCM tiles alike
PAD = 4  # int16 between the PCM ring's sub-tiles
BARRIER_BYTES = 4 * SLOTS * 8  # a full/empty mbarrier pair per slot, dq and PCM
MAX_WARPS = 16  # recurrence and producer warps of a block


def chunks_per_block(c: int) -> int:
    """Chunks one block decodes: as many as fill one warp with (chunk,
    channel) streams, one from 17 channels on."""
    return max(1, 32 // c)


def tile_frames(c: int) -> int:
    """Frames in one tile of the rings: a multiple of the 32 frames a
    recurrence thread holds in registers, about 1,024 samples for few
    channels and 32 frames from 32 channels on."""
    return 32 * min(8, max(1, -(-1024 // (32 * c))))


def pcm_ring_bytes(c: int) -> int:
    """The PCM ring: ``SLOTS`` slots of one int16 sub-tile [tile, C] plus
    ``PAD`` per chunk."""
    return SLOTS * chunks_per_block(c) * (tile_frames(c) * c + PAD) * 2
