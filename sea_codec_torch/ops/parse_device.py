"""Device-side parsing of full chunk rows (the ``serialize_device`` inverse).

A full CBR chunk's layout is entirely static -- 4-byte header, per-channel
LMS entry state, bit-packed scale factors, bit-packed residuals at fixed
offsets (reference ``src/codec/chunk.rs:69-213``) -- so a batch of
``uint8[N, chunk_size]`` container rows on the card parses into the inputs
of ``ops.device_decode.decode_chunks_packed`` with static slices, the
constant-width unpack (``device_decode.unpack_const``) and the i16 sign
extension, and decodes through the router's fused kernels: no host round
trip. Together with ``serialize_device.serialize_chunks_cbr_device`` this
closes the encode -> bytes -> decode pipeline on the card
(``transcode_chunks_cbr_device``).

VBR full-chunk rows parse on the card too (``parse_chunks_vbr_device``):
every section offset is static; only the residual bitstream's internal
layout depends on the data, and that is the decoder's job (``chunk.rs:126-142``:
the 2-bit size deltas are a constant-width section). VBR serialization has
a kernel of its own (``serialize_device.corpus_rows_vbr_device``: the pack
widths depend on the data, so the bit offsets are a scan of the sizes).

Not carried over from the JAX package: its gather-free
``unpack_const_strided`` (TPU gathers are slow; a GPU gather is not) and
the ``use_pallas``/``max_code_bits`` arguments (the router picks the kernel).
"""

from __future__ import annotations

import torch

from .device_decode import decode_chunks_packed, unpack_const


def _header_sections(rows, channels: int, scale_factor_bits: int, scale_factor_frames: int, frames: int):
    """(hist, wts int32[N, C, 4], sf uint8[N, W, C], offset after the scale
    factors, W): the LMS section, i16 LE history then weights widened with
    sign extension (the host parser's i32 -> i16 -> i32 round trip,
    reference ``lms.rs:64-94``), and the scale factors."""
    n = rows.shape[0]
    c = channels
    w = -(-frames // scale_factor_frames)
    sf_off = 4 + 16 * c
    sf_end = sf_off + -(-(w * c * scale_factor_bits) // 8)
    lms_b = rows[:, 4:sf_off].reshape(n, c, 8, 2).to(torch.int32)
    lms = ((lms_b[..., 0] | (lms_b[..., 1] << 8)) ^ 0x8000) - 0x8000
    sf = unpack_const(rows[:, sf_off:sf_end], scale_factor_bits, w * c).reshape(n, w, c)
    return lms[:, :, :4], lms[:, :, 4:], sf, sf_end, w


def parse_chunks_cbr_device(rows, channels: int, scale_factor_bits: int, scale_factor_frames: int,
                            residual_size: int, frames: int):
    """Full CBR container rows uint8[N, chunk_size] -> (res_bytes, sf_codes,
    rs, hist, wts), the ``decode_chunks_packed`` input tuple, on the rows'
    device; equal to the host parser (``batch.parse_full_chunks``)."""
    hist, wts, sf, res_off, w = _header_sections(rows, channels, scale_factor_bits, scale_factor_frames, frames)
    rs = torch.full((rows.shape[0], w, channels), residual_size, dtype=torch.uint8, device=rows.device)
    return rows[:, res_off:], sf, rs, hist, wts


def transcode_chunks_cbr_device(rows, channels: int, scale_factor_bits: int, scale_factor_frames: int,
                                residual_size: int, frames: int, fused: bool | None = None):
    """Decode full CBR container rows without leaving the card:
    ``decode(parse(rows))`` -> int16[N, frames, C]."""
    parsed = parse_chunks_cbr_device(rows, channels, scale_factor_bits, scale_factor_frames,
                                     residual_size, frames)
    return decode_chunks_packed(*parsed, sfb=scale_factor_bits, sff=scale_factor_frames, frames=frames,
                                residual_size=residual_size, fused=fused)


def parse_chunks_vbr_device(rows, channels: int, scale_factor_bits: int, scale_factor_frames: int,
                            residual_size: int, frames: int):
    """Full VBR container rows -> (res_bytes, sf_codes, rs, hist, wts). The
    per-window sizes come from the constant-width 2-bit delta section:
    ``rs = delta + residual_size - 1`` (reference ``chunk.rs:136-139``),
    ``residual_size`` being the chunk header's anchor."""
    hist, wts, sf, vbr_off, w = _header_sections(rows, channels, scale_factor_bits, scale_factor_frames, frames)
    n, c = rows.shape[0], channels
    res_off = vbr_off + -(-(w * c * 2) // 8)
    deltas = unpack_const(rows[:, vbr_off:res_off], 2, w * c)
    rs = (deltas.to(torch.int32) + (residual_size - 1)).to(torch.uint8).reshape(n, w, c)
    return rows[:, res_off:], sf, rs, hist, wts


def decode_rows_vbr_device(rows, channels: int, scale_factor_bits: int, scale_factor_frames: int,
                           residual_size: int, frames: int, fused: bool | None = None):
    """VBR decode straight from full container rows, the parse included, on
    the rows' device -> int16[N, frames, C]."""
    parsed = parse_chunks_vbr_device(rows, channels, scale_factor_bits, scale_factor_frames,
                                     residual_size, frames)
    return decode_chunks_packed(*parsed, sfb=scale_factor_bits, sff=scale_factor_frames, frames=frames,
                                residual_size=0, fused=fused)
