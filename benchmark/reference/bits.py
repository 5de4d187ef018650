"""MSB-first bit packing (upstream ``src/codec/bits.rs``) on integer tensors.

Values of 1..8 bits are concatenated, most significant bit first, and the
last byte of a section is padded with zero bits. Rows are independent: each
function takes a leading row axis. Bits are spelled out one per byte, which
is plain and costs eight bytes of memory per packed bit; callers work in
blocks of rows.
"""

from __future__ import annotations

import torch

_SHIFTS = torch.arange(7, -1, -1)


def _bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [R, n] -> uint8 [R, ceil(n / 8)], zero-padded."""
    r, n = bits.shape
    pad = -n % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros((r, pad))], dim=1)
    weights = (1 << _SHIFTS.to(bits.device)).to(torch.int32)
    return (bits.view(r, -1, 8).to(torch.int32) * weights).sum(dim=2).to(torch.uint8)


def _bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 [R, B] -> uint8 bits [R, 8B], most significant bit first."""
    r = data.shape[0]
    return ((data.to(torch.int32)[:, :, None] >> _SHIFTS.to(data.device)) & 1).to(torch.uint8).view(r, -1)


def pack(values: torch.Tensor, widths) -> torch.Tensor:
    """values [R, N] packed at ``widths`` (an int, or a tensor [R, N] whose
    rows all hold the same number of bits) -> uint8 [R, bytes]."""
    r, n = values.shape
    v = values.to(torch.int32)
    j = torch.arange(8, device=v.device)
    if isinstance(widths, int):
        bits = (v[:, :, None] >> (widths - 1 - j[:widths])) & 1
        return _bits_to_bytes(bits.to(torch.uint8).reshape(r, n * widths))
    w = widths.to(torch.int32)
    keep = j < w[:, :, None]  # [R, N, 8]: bit j of a value exists below its width
    bits = (v[:, :, None] >> (w[:, :, None] - 1 - j).clamp_min(0)) & 1
    total = int(w[0].sum())
    if not bool((w.sum(dim=1) == total).all()):
        raise ValueError("rows of one pack must hold the same number of bits")
    return _bits_to_bytes(bits.to(torch.uint8)[keep].view(r, total))


def unpack(data: torch.Tensor, widths, count: int) -> torch.Tensor:
    """uint8 [R, B] -> int64 [R, count]: ``count`` values at ``widths`` (an
    int, or a tensor [R, count]) read from the start of each row."""
    r = data.shape[0]
    bits = _bytes_to_bits(data).to(torch.int64)
    if isinstance(widths, int):
        need = count * widths
        if bits.shape[1] < need:
            raise ValueError("section shorter than its values")
        b = bits[:, :need].view(r, count, widths)
        return (b << torch.arange(widths - 1, -1, -1, device=data.device)).sum(dim=2)
    w = widths.to(torch.int64)
    start = torch.cumsum(w, dim=1) - w  # [R, count] each value's first bit
    if int((start[:, -1] + w[:, -1]).max()) > bits.shape[1]:
        raise ValueError("section shorter than its values")
    j = torch.arange(8, device=data.device)
    idx = (start[:, :, None] + j).clamp_max(bits.shape[1] - 1)
    b = torch.gather(bits, 1, idx.view(r, -1)).view(r, count, 8)
    b = torch.where(j < w[:, :, None], b, 0)
    return (b << (w[:, :, None] - 1 - j).clamp_min(0)).sum(dim=2)


def packed_len(widths_total_bits: int) -> int:
    return (widths_total_bits + 7) // 8
