"""Whole-file encoding of the full chunks.

CBR: the sequential chunk chain of a file is one run of windows (the LMS
state and the previous winning scale factor carry from each window to the
next, across chunk boundaries), so all full chunks go through ONE
window-search call (``ops.window_search``), which also snapshots each
chunk's entry LMS state for the chunk headers (reference
``src/codec/file.rs:146-149``).

VBR: each chunk is searched twice (reference ``encoder_vbr.rs:139-171``):
pass 1 at ``base+1`` for the error ranks, then pass 2 with the sizes the
ranking assigns, from the same entry LMS state and pass 1's previous scale
factor. The ranking between the passes makes every chunk wait for the one
before, so this is a host loop over chunks, two launches each; everything
in it stays on the device and nothing in it waits for the device.
"""

from __future__ import annotations

import torch

from .window_search import window_search

_SIGN64 = -(1 << 63)


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


def vbr_sizes(ranks, base: int, dist: tuple[int, int, int], sortable: int | None = None):
    """Per-(window, channel) sizes of one chunk from its pass-1 ranks
    int64[W, C] (u64 bits, window-major; reference ``encoder_vbr.rs:98-137``).
    Of the first ``sortable`` items (all by default; a ragged tail chunk's
    last partial windows keep ``base``), the ``m1`` lowest ranks get
    ``base-1``, the ``p2`` highest ``base+2``, the ``p1`` below them
    ``base+1``, the rest ``base`` (stable order), clamped to 1..8 ->
    int32[W, C]."""
    m1, p1, p2 = dist
    flat = ranks.reshape(-1)
    n = flat.numel() if sortable is None else sortable
    order = torch.argsort(flat[:n] ^ _SIGN64, stable=True)  # u64 order
    # each item's place in that order; comparisons against host ints, since
    # assigning a host scalar through an index tensor copies it to the card
    # and waits for the stream
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=order.device))
    head = (pos >= n - p2 - p1).int() + (pos >= n - p2).int() - (pos < m1).int() + base
    rest = torch.full((flat.numel() - n,), base, dtype=torch.int32, device=flat.device)
    return torch.cat([head, rest]).clamp_(1, 8).reshape(ranks.shape)


def encode_file_vbr(
    samples,  # int16[nc, fpc, C] full chunks only
    hist0,  # int32[C, 4]
    wts0,  # int32[C, 4]
    prev0,  # int32[C]
    *,
    scale_factor_frames: int,
    scale_factor_bits: int,
    base: int,  # trunc(normalized target bitrate)
    dist: tuple[int, int, int],  # (m1, p1, p2) counts, the same for every full chunk
):
    """Returns (sf uint8[nc, W, C], codes uint8[nc, fpc, C],
    sizes uint8[nc, W, C], ehist int32[nc, C, 4], ewts int32[nc, C, 4],
    hist, wts, prev)."""
    nc, fpc, c = samples.shape
    kw = dict(sfb=scale_factor_bits, sff=scale_factor_frames, wpc=fpc // scale_factor_frames)
    hist, wts, prev = hist0, wts0, prev0
    out = []
    for k in range(nc):
        x = samples[k]
        # pass 1: analyze at base+1; LMS restored, prev_sf kept
        _sf, _codes, ranks, _eh, _ew, _h1, _w1, prev1 = window_search(
            x, None, hist, wts, prev, rs=base + 1, ranks_only=True, **kw
        )
        sizes = vbr_sizes(ranks, base, dist)
        sf, codes, _ranks, _eh, _ew, h2, w2, p2 = window_search(
            x, None, hist, wts, prev1, rs=sizes, **kw
        )
        out.append((sf, codes, sizes.to(torch.uint8), hist, wts))
        hist, wts, prev = h2, w2, p2
    if not out:
        raise ValueError("encode_file_vbr needs at least one full chunk")
    sf, codes, sizes, ehist, ewts = (torch.stack(p) for p in zip(*out))
    return sf, codes, sizes, ehist, ewts, hist, wts, prev
