"""Batched CBR chunk decoding (PyTorch).

The SEA format makes chunk decode embarrassingly parallel: every chunk
carries its own per-channel LMS entry state (reference ``README.md:99-102``,
``src/codec/chunk.rs:95-103``), so a batch of N chunks decodes with all
chunks x channels independent. Per-sample semantics mirror the reference
decoder hot loop (``src/codec/decoder.rs:20-86``): predict -> dequantize ->
clamp -> LMS update.

The functions here are the plain PyTorch form of that pipeline (unpack,
closed-form dequant, recurrence); the decode entry for packed chunks, which
launches the fused Hopper kernel on CUDA tensors, is
``ops.fused_decode.decode_cbr_fused``.
"""

from __future__ import annotations

import torch

from . import lms, tables


def _dequant_window_constants(sf_w: torch.Tensor, sfb: int, rs: int):
    """Per-window dequant constants for a static residual size (CBR):
    (sfval f32[N, W, C], c0, stepf, endv, kmax)."""
    sfval_t, _recip, c0_t, stepf_t, endv_t, kmax_t, _cl = tables.rs_tables(sfb)
    table = torch.as_tensor(sfval_t[rs], device=sf_w.device)
    sfval = table[sf_w.long()]
    return sfval, float(c0_t[rs]), float(stepf_t[rs]), float(endv_t[rs]), int(kmax_t[rs])


def dequant_values(q: torch.Tensor, sfval: torch.Tensor, c0, stepf, endv, kmax) -> torch.Tensor:
    """Closed-form dequantization of codes ``q`` (int64) with per-sample
    scale-factor values ``sfval`` (f32) -> int64, equal to the table build
    (``tables.dqt``): every f32 multiply and add is its own rounding."""
    k = q >> 1
    curve = (k.to(torch.float32) * stepf) + 0.5
    curve = torch.where(k == kmax, torch.tensor(endv, dtype=torch.float32, device=q.device), curve)
    curve = torch.where(k == 0, torch.tensor(c0, dtype=torch.float32, device=q.device), curve)
    dq_abs = torch.floor((sfval * curve) + 0.5).to(torch.int64)
    return torch.where((q & 1) == 1, -dq_abs, dq_abs)


def dequant_codes(
    codes: torch.Tensor,  # uint8[N, F, C] quantized residual codes
    sf_codes: torch.Tensor,  # uint8[N, W, C] scale factors per window
    sfb: int,
    scale_factor_frames: int,
    residual_size: int,
) -> torch.Tensor:
    """codes -> int16[N, F, C] dequantized values (|dq| <= 27090 for every
    legal (sfb, rs), so int16 holds them)."""
    n, f, c = codes.shape
    sff = scale_factor_frames
    sfval, c0, stepf, endv, kmax = _dequant_window_constants(sf_codes, sfb, residual_size)
    sfval = sfval.repeat_interleave(sff, dim=1)[:, :f]
    dq = dequant_values(codes.to(torch.int64), sfval, c0, stepf, endv, kmax)
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


def decode_chunks_fn(
    codes: torch.Tensor,  # uint8[N, F, C]
    sf_codes: torch.Tensor,  # uint8[N, W, C]
    hist0: torch.Tensor,  # int32[N, C, 4] chunk-entry LMS history
    wts0: torch.Tensor,  # int32[N, C, 4] chunk-entry LMS weights
    sfb: int,
    scale_factor_frames: int,
    residual_size: int,
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
