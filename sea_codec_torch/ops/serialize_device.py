"""Device-side chunk serialization (CBR), plain PyTorch.

The device emits finished ``uint8[chunk_size]`` container rows, so the
device-to-host copy is the packed bitstream (~rs/8 bytes per sample) and the
host only concatenates rows with the file header. Bit layout matches
``ops.bitpack`` exactly (MSB-first, final partial byte left-aligned), which
in turn matches the reference ``BitPacker`` (``src/codec/bits.rs:104-134``);
the chunk layout is ``src/codec/chunk.rs:215-278``.
"""

from __future__ import annotations

import math

import torch

from ..container import CHUNK_TYPE_CBR


def pack_bits_rows_device(values: torch.Tensor, width: int) -> torch.Tensor:
    """Pack each row of ``values`` [R, N] (items < 2^width) MSB-first ->
    uint8[R, ceil(N*width/8)].

    A w-bit stream repeats every lcm(w, 8) bits = p bytes carrying g codes,
    and byte k of each period is a fixed shift/or of <= 2 codes."""
    r, n = values.shape
    nbytes = -(-(n * width) // 8)
    w_lcm = (width * 8) // math.gcd(width, 8)
    p = w_lcm // 8  # bytes per period
    g = w_lcm // width  # codes per period
    groups = -(-n // g)
    v = values.to(torch.int32) & ((1 << width) - 1)
    if groups * g != n:
        v = torch.nn.functional.pad(v, (0, groups * g - n))
    v = v.reshape(r, groups, g)
    byts = []
    for k in range(p):
        acc = None
        for j in range(8 * k // width, (8 * k + 7) // width + 1):
            sh = (8 * k + 8) - (j + 1) * width  # code j LSB above byte k LSB
            contrib = v[:, :, j] << sh if sh >= 0 else v[:, :, j] >> -sh
            acc = contrib if acc is None else acc | contrib
        byts.append(acc & 0xFF)
    out = torch.stack(byts, dim=2).reshape(r, groups * p)[:, :nbytes]
    return out.to(torch.uint8)


def lms_section_device(ehist: torch.Tensor, ewts: torch.Tensor) -> torch.Tensor:
    """Per-chunk LMS header bytes: history then weights, each i16 LE with
    i32 -> low-16-bits truncation (reference ``lms.rs:64-78``).
    ehist/ewts int32[R, C, 4] -> uint8[R, C*16]."""
    lms = torch.cat([ehist, ewts], dim=2).to(torch.int32)  # [R, C, 8]
    byts = torch.stack([lms & 0xFF, (lms >> 8) & 0xFF], dim=-1)
    return byts.reshape(lms.shape[0], -1).to(torch.uint8)


def cbr_chunk_size(
    channels: int, frames: int, scale_factor_bits: int, scale_factor_frames: int,
    residual_size: int,
) -> int:
    """Serialized byte length of a CBR chunk with ``frames`` frames."""
    w = -(-frames // scale_factor_frames)
    sf_bytes = -(-(w * channels * scale_factor_bits) // 8)
    res_bytes = -(-(frames * channels * residual_size) // 8)
    return 4 + 16 * channels + sf_bytes + res_bytes


def serialize_chunks_cbr_device(
    sf: torch.Tensor,  # uint8[R, W, C]
    codes: torch.Tensor,  # uint8[R, F, C]
    ehist: torch.Tensor,  # int32[R, C, 4]
    ewts: torch.Tensor,  # int32[R, C, 4]
    scale_factor_bits: int,
    scale_factor_frames: int,
    residual_size: int,
) -> torch.Tensor:
    """Full CBR chunks -> finished container rows uint8[R, chunk_size]:
    4-byte chunk header, per-channel LMS state, packed scale factors,
    packed residuals."""
    r, w, c = sf.shape
    f = codes.shape[1]
    head = torch.tensor(
        [
            CHUNK_TYPE_CBR,
            ((scale_factor_bits << 4) | residual_size) & 0xFF,
            scale_factor_frames,
            0x5A,
        ],
        dtype=torch.uint8,
        device=sf.device,
    ).expand(r, 4)
    parts = [
        head,
        lms_section_device(ehist, ewts),
        pack_bits_rows_device(sf.reshape(r, w * c), scale_factor_bits),
        pack_bits_rows_device(codes.reshape(r, f * c), residual_size),
    ]
    return torch.cat(parts, dim=1)


def corpus_rows_cbr_device(
    sf: torch.Tensor,  # uint8[NC, W, B] lane-packed (B = n_files * C)
    codes: torch.Tensor,  # uint8[NC, F, B]
    ehist: torch.Tensor,  # int32[NC, B, 4]
    ewts: torch.Tensor,  # int32[NC, B, 4]
    n_files: int,
    scale_factor_bits: int,
    scale_factor_frames: int,
    residual_size: int,
) -> torch.Tensor:
    """Lane-packed corpus encoder outputs (lane = file * C + channel) ->
    per-file container rows uint8[n_files, NC, chunk_size]."""
    nc, w, b = sf.shape
    f = codes.shape[1]
    nf = n_files
    c = b // nf
    sf_r = sf.reshape(nc, w, nf, c).permute(2, 0, 1, 3).reshape(nf * nc, w, c)
    codes_r = codes.reshape(nc, f, nf, c).permute(2, 0, 1, 3).reshape(nf * nc, f, c)
    eh_r = ehist.reshape(nc, nf, c, 4).permute(1, 0, 2, 3).reshape(nf * nc, c, 4)
    ew_r = ewts.reshape(nc, nf, c, 4).permute(1, 0, 2, 3).reshape(nf * nc, c, 4)
    rows = serialize_chunks_cbr_device(
        sf_r, codes_r, eh_r, ew_r, scale_factor_bits, scale_factor_frames, residual_size,
    )
    return rows.reshape(nf, nc, -1)
