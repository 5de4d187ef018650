"""Batched chunk decoding, CBR and VBR (PyTorch).

The SEA format makes chunk decode embarrassingly parallel: every chunk
carries its own per-channel LMS entry state (reference ``README.md:99-102``,
``src/codec/chunk.rs:95-103``), so a batch of N chunks decodes with all
chunks x channels independent. Per-sample semantics mirror the reference
decoder hot loop (``src/codec/decoder.rs:20-86``): predict -> dequantize ->
clamp -> LMS update.

The functions here are the plain PyTorch form of that pipeline (unpack,
closed-form dequant, recurrence), for constant (CBR) and per-window (VBR)
residual sizes; the decode entries for packed chunks, which launch the
fused Hopper kernels on CUDA tensors, are ``ops.fused_decode.decode_cbr_fused``
and ``ops.fused_decode_vbr.decode_vbr_fused``.
"""

from __future__ import annotations

import torch

from . import lms, tables


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
    need = int(idx[-1]) + 2 if count else 0
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
    idx = (bit >> 3).clamp(max=b).reshape(n, -1, 1)
    u16 = (d.gather(1, idx) << 8) | d.gather(1, idx + 1)
    codes = (u16.reshape(bit.shape) >> (16 - (bit & 7) - width)) & ((1 << width) - 1)
    return codes.to(torch.uint8)


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
    samples at once, then the recurrence, vectorised over streams and
    looping over frames."""
    dq = dequant_codes(codes, sf_codes, sfb, scale_factor_frames, residual_size).to(torch.int64)
    hist = hist0.to(torch.int64)
    wts = wts0.to(torch.int64)
    out = torch.empty(codes.shape, dtype=torch.int16, device=codes.device)
    for t in range(codes.shape[1]):
        dq_t = dq[:, t]
        recon = lms.clamp_i16(lms.predict(hist, wts) + dq_t)
        out[:, t] = recon.to(torch.int16)
        hist, wts = lms.update(hist, wts, recon, dq_t)
    return out
