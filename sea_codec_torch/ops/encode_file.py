"""The search cores of the encode, CBR and VBR (``batch.encode_corpus``,
which ``batch.encode_sea`` runs with one file).

Each lane of a launch is one channel of one file (lane = file * C +
channel), with its own LMS carry and its own valid length per window, so a
lane past its file's end is masked and its carry passes through unchanged.

CBR: the sequential chunk chain of a file is one run of windows (the LMS
state and the previous winning scale factor carry from each window to the
next, across chunk boundaries), so every chunk of every lane in a slab goes
through ONE window-search call (``ops.window_search``), tails included
(they ride the scan masked), which also snapshots each chunk's entry LMS
state for the chunk headers (reference ``src/codec/file.rs:146-149``).

VBR: each chunk is searched twice (reference ``encoder_vbr.rs:139-171``):
pass 1 at ``base+1`` for the error ranks, then pass 2 with the sizes the
ranking assigns, from the same entry LMS state and pass 1's previous scale
factor, each file's windows ranked on their own. The ranking between the
passes makes every chunk wait for the one before, so this is a host loop
over chunk index, two launches each over all lanes; everything in it stays
on the device and nothing in it waits for the device. Pass 2 stages only
the sizes the ranking can assign (``vbr_size_range``).

Not carried over from the JAX package, whose forms exist for the TPU: its
single-file cores ``encode_file_cbr``/``encode_file_vbr`` (one file is a
corpus of one here), the 128-lane groups and the ``*_blocks`` variants that
batch lane groups into one program (``lax.map`` relay batching), the
kernel's padded valid-length layout (``_nv_pallas_layout``), and the
one-file-at-a-time fallback for more than 128 channels or sfb 8: one block
per lane here takes every legal configuration.
"""

from __future__ import annotations

import contextlib

import torch

from .window_search import window_search

_SIGN64 = -(1 << 63)
_KEY_MAX = (1 << 63) - 1


def vbr_sizes_rows(ranks, base: int, m1, p1, p2, sortable=None):
    """Sizes from pass-1 ranks for R independent rankings at once:
    ``ranks`` int64[R, N] (u64 bits; each row one chunk's items,
    window-major; reference ``encoder_vbr.rs:98-137``). Of each row's first
    ``sortable`` items (all by default; a ragged tail chunk's last partial
    windows keep ``base``), the ``m1`` lowest ranks get ``base-1``, the
    ``p2`` highest ``base+2``, the ``p1`` below them ``base+1``, the rest
    ``base`` (stable order), clamped to 1..8 -> int32[R, N]. ``m1``, ``p1``,
    ``p2`` and ``sortable`` are host ints shared by every row, or int64[R, 1]
    tensors on the ranks' device, one per row."""
    r, n = ranks.shape
    if sortable is None:
        sortable = n
    key = ranks ^ _SIGN64  # u64 order
    idx = torch.arange(n, device=ranks.device)
    in_sort = None
    if torch.is_tensor(sortable) or sortable < n:
        # unsortable items sort last; on a tie of keys the stable sort keeps
        # them after the sortable items, which come first in the row
        in_sort = idx < sortable
        key = torch.where(in_sort, key, _KEY_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    # each item's place in that order; comparisons against host ints or
    # device tensors, since assigning a host scalar through an index tensor
    # copies it to the card and waits for the stream
    pos = torch.empty_like(order).scatter_(1, order, idx.expand(r, n))
    head = (pos >= sortable - p2 - p1).int() + (pos >= sortable - p2).int() - (pos < m1).int() + base
    if in_sort is not None:
        head = torch.where(in_sort, head, base)
    return head.clamp_(1, 8)


def vbr_sizes(ranks, base: int, dist: tuple[int, int, int], sortable: int | None = None):
    """Per-(window, channel) sizes of one chunk from its pass-1 ranks
    int64[W, C] -> int32[W, C]: ``vbr_sizes_rows`` on one row."""
    return vbr_sizes_rows(ranks.reshape(1, -1), base, *dist, sortable).reshape(ranks.shape)


def vbr_size_range(base: int) -> tuple[int, int]:
    """The sizes ``vbr_sizes`` can assign, base-1..base+2 clamped to 1..8:
    the search stages only their table rows."""
    return min(max(base - 1, 1), 8), min(base + 2, 8)


def corpus_n_valid(frames, nc: int, fpc: int, sff: int, full_only: bool):
    """Valid frames per (chunk, window, lane) int32[nc, W, B] from the lanes'
    frame counts ``frames`` int[B] (a tensor; padding lanes 0), built on
    the tensor's device. ``full_only`` masks ragged tail chunks entirely (the
    VBR chunk loop encodes full chunks only)."""
    dev = frames.device
    k = torch.arange(nc, dtype=torch.int32, device=dev).reshape(nc, 1, 1)
    wi = torch.arange(fpc // sff, dtype=torch.int32, device=dev).reshape(1, -1, 1)
    in_chunk = (frames.to(torch.int32).reshape(1, 1, -1) - k * fpc).clamp(0, fpc)
    if full_only:
        in_chunk = torch.where(in_chunk == fpc, in_chunk, 0)
    return (in_chunk - wi * sff).clamp(0, sff).to(torch.int32)


def corpus_cbr_scan(samples, nv, hist0, wts0, prev0, *, scale_factor_frames, scale_factor_bits, residual_size):
    """Corpus CBR encode core: ``samples`` int16[nc, fpc, B] (B lanes = files
    x channels), ``nv`` int32[nc, W, B] valid frames per lane. One search
    launch over every window of every chunk. Returns (sf uint8[nc, W, B],
    codes uint8[nc, fpc, B], ehist int32[nc, B, 4], ewts, hist int32[B, 4],
    wts, prev int32[B]); ``ehist``/``ewts`` are each chunk's entry state."""
    nc, fpc, b = samples.shape
    sff = scale_factor_frames
    w = fpc // sff
    sf, codes, _ranks, ehist, ewts, hist, wts, prev = window_search(
        samples.reshape(nc * fpc, b), nv.reshape(nc * w, b), hist0, wts0, prev0,
        sfb=scale_factor_bits, rs=residual_size, sff=sff, wpc=w,
    )
    return sf.reshape(nc, w, b), codes.reshape(nc, fpc, b), ehist, ewts, hist, wts, prev


def corpus_cbr_packed(
    samples, frames, tail_idx, hist0, wts0, prev0, *,
    scale_factor_frames, scale_factor_bits, residual_size, n_files,
):
    """Corpus CBR encode and container rows on the device, every chunk of
    every file (tails ride the scan masked). ``samples`` int16[nc, fpc, B],
    ``frames`` int32[B] each lane's frames, ``tail_idx`` int64[n_files]
    each file's tail chunk index (its full-chunk count). Returns (rows
    uint8[nf, nc, chunk_size], tail_sf uint8[nf, W, C], tail_codes
    uint8[nf, fpc, C], tail_eh/tail_ew int32[nf, C, 4] at each file's tail
    chunk, final hist/wts/prev). A file's rows past its full chunks, and the
    gathers of a file with no tail, are garbage the caller drops."""
    from .serialize_device import corpus_rows_cbr_device

    nc, fpc, b = samples.shape
    sff = scale_factor_frames
    w = fpc // sff
    nf = n_files
    c = b // nf
    nv = corpus_n_valid(frames, nc, fpc, sff, full_only=False)
    sf, codes, ehist, ewts, hist, wts, prev = corpus_cbr_scan(
        samples, nv, hist0, wts0, prev0, scale_factor_frames=sff,
        scale_factor_bits=scale_factor_bits, residual_size=residual_size,
    )
    rows = corpus_rows_cbr_device(sf, codes, ehist, ewts, nf, scale_factor_bits, sff, residual_size)
    ti = tail_idx.clamp(max=nc - 1)
    f = torch.arange(nf, device=samples.device)
    tail_sf = sf.reshape(nc, w, nf, c)[ti, :, f]
    tail_codes = codes.reshape(nc, fpc, nf, c)[ti, :, f]
    tail_eh = ehist.reshape(nc, nf, c, 4)[ti, f]
    tail_ew = ewts.reshape(nc, nf, c, 4)[ti, f]
    return rows, tail_sf, tail_codes, tail_eh, tail_ew, hist, wts, prev


def lanes_to_files(t, w: int, nf: int, c: int):
    """[W, nf*C] lanes -> [nf, W*C]: each file's items window-major."""
    return t.reshape(w, nf, c).permute(1, 0, 2).reshape(nf, w * c)


def files_to_lanes(t, w: int, nf: int, c: int):
    """The inverse of ``lanes_to_files``."""
    return t.reshape(nf, w, c).permute(1, 0, 2).reshape(w, nf * c)


def corpus_vbr_scan(
    samples, nv, hist0, wts0, prev0, *, scale_factor_frames, scale_factor_bits, base, dist, n_files,
    span=contextlib.nullcontext,
):
    """Corpus VBR encode of full chunks: ``samples`` int16[nc, fpc, B],
    ``nv`` int32[nc, W, B] with every chunk of a lane full or fully masked
    (``corpus_n_valid(full_only=True)``). A host loop over chunk index k,
    two launches each over all lanes: pass 1 ranks-only at ``base+1``, each
    file's W*C ranks sorted on their own (``vbr_sizes_rows``, one row a
    file), pass 2 from the restored LMS state and pass 1's ``prev_sf``. A
    fully masked chunk ranks every candidate 0: pass 1 keeps ``prev_sf``
    and pass 2 leaves the lane's carry as it was after its last full
    chunk, which seeds its tail. Nothing in the loop waits for the device.
    ``span(name)`` is a context manager opened around each chunk index's
    ranking as ``encode_rank`` (``batch._pt``; none by default). Returns
    (sf uint8[nc, W, B], codes uint8[nc, fpc, B], sizes uint8[nc, W, B],
    ehist int32[nc, B, 4], ewts, hist int32[B, 4], wts, prev int32[B])."""
    nc, fpc, b = samples.shape
    sff = scale_factor_frames
    w = fpc // sff
    nf = n_files
    c = b // nf
    m1, p1, p2 = dist
    kw = dict(sfb=scale_factor_bits, sff=sff, wpc=w)
    hist, wts, prev = hist0, wts0, prev0
    out = []
    for k in range(nc):
        x, nvk = samples[k], nv[k]
        _sf, _codes, ranks, _eh, _ew, _h1, _w1, prev1 = window_search(
            x, nvk, hist, wts, prev, rs=base + 1, ranks_only=True, **kw
        )
        with span("encode_rank"):
            sizes = files_to_lanes(vbr_sizes_rows(lanes_to_files(ranks, w, nf, c), base, m1, p1, p2), w, nf, c)
        sf, codes, _ranks, _eh, _ew, h2, w2, pv2 = window_search(
            x, nvk, hist, wts, prev1, rs=sizes, rs_range=vbr_size_range(base), **kw
        )
        out.append((sf, codes, sizes.to(torch.uint8), hist, wts))
        hist, wts, prev = h2, w2, pv2
    if not out:
        e8 = torch.zeros((0, w, b), dtype=torch.uint8, device=samples.device)
        e32 = torch.zeros((0, b, 4), dtype=torch.int32, device=samples.device)
        return e8, samples.new_zeros((0, fpc, b), dtype=torch.uint8), e8, e32, e32, hist, wts, prev
    sf, codes, sizes, ehist, ewts = (torch.stack(p) for p in zip(*out))
    return sf, codes, sizes, ehist, ewts, hist, wts, prev


def corpus_vbr_nv(
    samples, frames, hist0, wts0, prev0, *, scale_factor_frames, scale_factor_bits, base, dist, n_files,
    span=contextlib.nullcontext,
):
    """``corpus_vbr_scan`` with the valid lengths built on the device from
    each lane's frame count ``frames`` int32[B]: only full chunks ride the
    loop, ragged tails are masked."""
    nc, fpc, _b = samples.shape
    nv = corpus_n_valid(frames, nc, fpc, scale_factor_frames, full_only=True)
    return corpus_vbr_scan(
        samples, nv, hist0, wts0, prev0, scale_factor_frames=scale_factor_frames,
        scale_factor_bits=scale_factor_bits, base=base, dist=dist, n_files=n_files, span=span,
    )
