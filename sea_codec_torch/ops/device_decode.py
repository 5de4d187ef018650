"""Batched chunk decoding, CBR and VBR (PyTorch).

The SEA format makes chunk decode embarrassingly parallel: every chunk
carries its own per-channel LMS entry state (reference ``README.md:99-102``,
``src/codec/chunk.rs:95-103``), so a batch of N chunks decodes with all
chunks x channels independent. Per-sample semantics mirror the reference
decoder hot loop (``src/codec/decoder.rs:20-86``): predict -> dequantize ->
clamp -> LMS update.

The first half of this module is the plain PyTorch form of that pipeline
(unpack, closed-form dequant, recurrence), for constant (CBR) and per-window
(VBR) residual sizes. The second half holds the two decode entries, named as
in the JAX package: ``decode_chunks`` on unpacked codes, and
``decode_chunks_packed``, the router from packed chunk rows to the kernels.
By default the router takes the fused kernel
(``ops.fused_decode.decode_cbr_fused``, ``ops.fused_decode_vbr.decode_vbr_fused``),
which stages no row and takes every legal geometry; with the fused kernels
off it takes the two-kernel path (a dequant prolog of ``ops.dequant``, then
``ops.lms_decode``).
"""

from __future__ import annotations

import os

import torch

from . import tables
from .lms_decode import lms_decode, lms_decode_plain


def _dequant_window_constants(sf_w: torch.Tensor, sfb: int, rs):
    """Per-window dequant constants (sfval f32[N, W, C], c0, stepf, endv,
    kmax). ``rs`` is an int (CBR: the four curve constants are scalars) or
    an integer tensor [N, W, C] of per-window sizes (VBR: each constant is
    a tensor of that shape)."""
    tabs = tables.rs_tables(sfb)
    if not torch.is_tensor(rs):
        rs = int(rs)
        sfval_t, _recip, c0_t, stepf_t, endv_t, kmax_t, _cl = tabs
        table = torch.as_tensor(sfval_t[rs], device=sf_w.device)
        sfval = table[sf_w.long()]
        return sfval, float(c0_t[rs]), float(stepf_t[rs]), float(endv_t[rs]), int(kmax_t[rs])
    sfval_t, _recip, c0_t, stepf_t, endv_t, kmax_t, _cl = (
        torch.as_tensor(t, device=sf_w.device) for t in tabs
    )
    r = rs.long()
    return sfval_t[r, sf_w.long()], c0_t[r], stepf_t[r], endv_t[r], kmax_t[r]


def dequant_values(q: torch.Tensor, sfval: torch.Tensor, c0, stepf, endv, kmax) -> torch.Tensor:
    """Closed-form dequantization of codes ``q`` (int64) with per-sample
    scale-factor values ``sfval`` (f32) -> int64, equal to the table build
    (``tables.dqt``): every f32 multiply and add is its own rounding. The
    curve constants are scalars or f32/int tensors broadcasting with ``q``."""
    f32 = dict(dtype=torch.float32, device=q.device)
    k = q >> 1
    curve = (k.to(torch.float32) * stepf) + 0.5
    curve = torch.where(k == kmax, torch.as_tensor(endv, **f32), curve)
    curve = torch.where(k == 0, torch.as_tensor(c0, **f32), curve)
    dq_abs = torch.floor((sfval * curve) + 0.5).to(torch.int64)
    return torch.where((q & 1) == 1, -dq_abs, dq_abs)


def dequant_codes(
    codes: torch.Tensor,  # uint8[N, F, C] quantized residual codes
    sf_codes: torch.Tensor,  # uint8[N, W, C] scale factors per window
    sfb: int,
    scale_factor_frames: int,
    residual_size,  # int (CBR) or uint8[N, W, C] sizes per window (VBR)
) -> torch.Tensor:
    """codes -> int16[N, F, C] dequantized values (|dq| <= 27090 for every
    legal (sfb, rs), so int16 holds them)."""
    f = codes.shape[1]
    sff = scale_factor_frames
    per_frame = lambda a: a.repeat_interleave(sff, dim=1)[:, :f] if torch.is_tensor(a) else a
    consts = _dequant_window_constants(sf_codes, sfb, residual_size)
    dq = dequant_values(codes.to(torch.int64), *(per_frame(a) for a in consts))
    return dq.to(torch.int16)


def unpack_const(data: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Constant-width MSB-first unpack of each row -> uint8[N, count].

    Code j sits at bit j*width; with a 16-bit window over the byte pair at
    that offset it is one shift and mask (the TPU port's gather-free
    ``unpack_const_strided`` exists because TPU gathers are slow; a GPU
    gather is not)."""
    n, b = data.shape
    bit = torch.arange(count, device=data.device, dtype=torch.int64) * width
    idx = bit >> 3
    need = ((count - 1) * width >> 3) + 2 if count else 0  # from host ints: no wait for the card
    d = data.to(torch.int64)
    if b < need:
        d = torch.nn.functional.pad(d, (0, need - b))
    u16 = (d[:, idx] << 8) | d[:, idx + 1]
    codes = (u16 >> (16 - (bit & 7) - width)) & ((1 << width) - 1)
    return codes.to(torch.uint8)


def unpack_var(data: torch.Tensor, rs: torch.Tensor, sff: int, frames: int) -> torch.Tensor:
    """VBR unpack of each row's residual section -> uint8[N, frames, C].

    ``rs`` uint8[N, W, C] holds the sizes. Within a window the widths are
    constant per channel and the codes are frame-major, channel-minor
    (reference ``chunk.rs:245-271``), so bit offsets are affine in (frame,
    channel): ``bit(w, t, c) = win_start[w] + t*wsum[w] + prefix[w, c]``,
    with ``wsum`` the window's bits per frame, ``prefix`` the bits of the
    channels before ``c``, and ``win_start`` the prefix sum of
    ``fiw[w]*wsum[w]`` (``fiw``: frames in window ``w``; the last may be
    partial). A code of <= 8 bits at any bit phase lies within the 16-bit
    window over the byte pair at ``bit >> 3``. Byte indices are clamped to
    the row (two zero bytes pad it), as the VBR decode kernel reads its
    staged copy, so a row shorter than its size table implies decodes the
    same garbage in both instead of failing."""
    n, b = data.shape
    w, c = rs.shape[1:]
    r = rs.to(torch.int64)
    wsum = r.sum(dim=2)  # [N, W]
    prefix = r.cumsum(dim=2) - r  # [N, W, C]
    fiw = (frames - torch.arange(w, device=rs.device) * sff).clamp(0, sff)
    win_bits = fiw[None, :] * wsum
    win_start = win_bits.cumsum(dim=1) - win_bits  # [N, W]
    t = torch.arange(sff, device=rs.device)
    bit = (
        win_start[:, :, None, None]
        + t[None, None, :, None] * wsum[:, :, None, None]
        + prefix[:, :, None, :]
    ).reshape(n, w * sff, c)[:, :frames]
    width = r.repeat_interleave(sff, dim=1)[:, :frames]
    d = torch.nn.functional.pad(data.to(torch.int64), (0, 2)).reshape(n, b + 2, 1)
    idx = (bit >> 3).clamp(max=b).reshape(n, bit.shape[1] * c, 1)  # no -1: n may be 0
    u16 = (d.gather(1, idx) << 8) | d.gather(1, idx + 1)
    codes = (u16.reshape(bit.shape) >> (16 - (bit & 7) - width)) & ((1 << width) - 1)
    return codes.to(torch.uint8)


def clean_vbr_tables(sf_codes: torch.Tensor, rs: torch.Tensor, sfb: int):
    """(scale factors masked to 2^sfb, sizes clamped to 1..8): the VBR
    tables as the VBR kernels read them, so that malformed tables decode the
    same in every version (``parse_full_chunks`` refuses sizes outside 1..8;
    a direct call of a decode does not)."""
    return sf_codes & ((1 << sfb) - 1), rs.clamp(1, 8)


def decode_chunks_fn(
    codes: torch.Tensor,  # uint8[N, F, C]
    sf_codes: torch.Tensor,  # uint8[N, W, C]
    hist0: torch.Tensor,  # int32[N, C, 4] chunk-entry LMS history
    wts0: torch.Tensor,  # int32[N, C, 4] chunk-entry LMS weights
    sfb: int,
    scale_factor_frames: int,
    residual_size,  # int (CBR) or uint8[N, W, C] sizes per window (VBR)
) -> torch.Tensor:
    """Plain decode of unpacked codes -> int16[N, F, C]: dequant for all
    samples at once, then the recurrence (``lms_decode.lms_decode_plain``)."""
    dq = dequant_codes(codes, sf_codes, sfb, scale_factor_frames, residual_size)
    return lms_decode_plain(dq.permute(1, 0, 2), hist0, wts0)


def decode_chunks(
    codes: torch.Tensor,  # uint8[N, F, C] quantized residual codes
    sf_codes: torch.Tensor,  # uint8[N, W, C]
    rs,  # uint8[N, W, C] sizes per window; unread when static_rs > 0
    hist0: torch.Tensor,  # int32[N, C, 4]
    wts0: torch.Tensor,  # int32[N, C, 4]
    *,
    sfb: int,
    sff: int,
    static_rs: int = 0,  # >0: every window uses this residual size (CBR)
) -> torch.Tensor:
    """Decode a batch of chunks from unpacked codes -> int16[N, F, C]. The
    dequant is plain tensor code (as it is XLA and no kernel in the JAX
    package); the recurrence is ``lms_decode``: its kernel on a CUDA tensor,
    its plain version on a CPU tensor."""
    dq = dequant_codes(codes, sf_codes, sfb, sff, static_rs if static_rs else rs)
    return lms_decode(dq.permute(1, 0, 2).contiguous(), hist0, wts0)


def decode_chunks_packed(
    res_bytes: torch.Tensor,  # uint8[N, B] packed residual section
    sf_codes: torch.Tensor,  # uint8[N, W, C]
    rs,  # uint8[N, W, C] sizes per window; unread when residual_size > 0
    hist0: torch.Tensor,  # int32[N, C, 4]
    wts0: torch.Tensor,  # int32[N, C, 4]
    *,
    sfb: int,
    sff: int,
    frames: int,
    residual_size: int,  # >0: CBR at this constant width; 0: VBR, widths from rs
    fused: bool | None = None,
) -> torch.Tensor:
    """Decode packed chunk rows -> int16[N, frames, C].

    With ``fused`` true the fused kernel decodes the batch: it streams a
    row tile by tile, so it takes rows of any length and every legal
    geometry (sfb 1..8, C 1..255, for VBR sff 1..255), and refuses the rest
    (``fused_decode.fused_cbr_supported``,
    ``fused_decode_vbr.fused_vbr_supported``). With ``fused`` false the
    two-kernel path does. ``fused=None`` reads the
    ``SEA_FUSED_PROLOG`` environment variable at each call (``0`` turns the
    fused kernels off), as the JAX package does. Every route runs its
    kernels on CUDA tensors and their plain versions on CPU tensors."""
    # imported here: these modules build on this module's plain functions
    from . import dequant
    from .fused_decode import decode_cbr_fused
    from .fused_decode_vbr import decode_vbr_fused

    if fused is None:
        fused = os.environ.get("SEA_FUSED_PROLOG") != "0"
    kw = dict(sfb=sfb, sff=sff, frames=frames)
    if residual_size:
        if fused:
            return decode_cbr_fused(res_bytes, sf_codes, hist0, wts0, rs=residual_size, **kw)
        dq = dequant.unpack_dequant_cbr(res_bytes, sf_codes, rs=residual_size, **kw)
    else:
        if fused:
            return decode_vbr_fused(res_bytes, sf_codes, rs, hist0, wts0, **kw)
        dq = dequant.unpack_dequant_vbr(res_bytes, sf_codes, rs, **kw)
    return lms_decode(dq, hist0, wts0)
