"""Whole-file CBR encoding of the full chunks.

The sequential chunk chain of a file is one run of windows: the LMS state
and the previous winning scale factor carry from each window to the next,
across chunk boundaries. So all full chunks go through ONE window-search
call (``ops.window_search``), which also snapshots each chunk's entry LMS
state for the chunk headers (reference ``src/codec/file.rs:146-149``).
"""

from __future__ import annotations

from .window_search import window_search


def encode_file_cbr(
    samples,  # int16[nc, fpc, C] full chunks only
    hist0,  # int32[C, 4]
    wts0,  # int32[C, 4]
    prev0,  # int32[C]
    *,
    scale_factor_frames: int,
    scale_factor_bits: int,
    residual_size: int,
):
    """Returns (sf uint8[nc, W, C], codes uint8[nc, fpc, C],
    ehist int32[nc, C, 4], ewts int32[nc, C, 4], hist, wts, prev)."""
    nc, fpc, c = samples.shape
    sff = scale_factor_frames
    w = fpc // sff
    sf, codes, _ranks, ehist, ewts, hist, wts, prev = window_search(
        samples.reshape(nc * fpc, c), None, hist0, wts0, prev0,
        sfb=scale_factor_bits, rs=residual_size, sff=sff, wpc=w,
    )
    return sf.reshape(nc, w, c), codes.reshape(nc, fpc, c), ehist, ewts, hist, wts, prev
