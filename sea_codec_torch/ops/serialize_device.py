"""Device-side chunk serialization, CBR and VBR.

The device emits finished ``uint8[chunk_size]`` container rows, so the
device-to-host copy is the packed bitstream (~rs/8 bytes per sample) and the
host only concatenates rows with the file header. Bit layout matches
``ops.bitpack`` exactly (MSB-first, final partial byte left-aligned), which
in turn matches the reference ``BitPacker`` (``src/codec/bits.rs:104-134``);
the chunk layout is ``src/codec/chunk.rs:215-278``.

CBR rows are plain PyTorch: every code has the same width, so each section
is a static layout (``pack_bits_rows_device``). VBR residuals take their
window's size, so where a code lands depends on the data: on a CUDA tensor
``corpus_rows_vbr_device`` launches ``csrc/serialize_vbr.cu`` (one block a
row, the bit offsets from a block scan of the sizes), on a CPU tensor it
runs the plain version ``corpus_rows_vbr_plain``; both give the bytes of
``batch.serialize_full_chunks``. ``launches`` counts that kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from ..container import CHUNK_TYPE_CBR, CHUNK_TYPE_VBR
from . import cuda_build

launches = 0
_PLAIN_BLOCK_ROWS = 1024  # rows a step of the plain VBR residual pack; the bytes do not depend on it


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


@lru_cache(maxsize=None)
def _cbr_head(scale_factor_bits: int, scale_factor_frames: int, residual_size: int, device) -> torch.Tensor:
    """A CBR chunk's 4 header bytes on ``device``, made once: a tensor
    built from a Python list on a card is a pageable host-to-device copy,
    which first waits for all the stream's queued work, so the host could
    not enqueue the next slab while the card searches this one."""
    return torch.tensor(
        [CHUNK_TYPE_CBR, ((scale_factor_bits << 4) | residual_size) & 0xFF, scale_factor_frames, 0x5A],
        dtype=torch.uint8,
        device=device,
    )


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
    head = _cbr_head(scale_factor_bits, scale_factor_frames, residual_size, sf.device).expand(r, 4)
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


def vbr_rank_sizes(items: int, base: int, dist: tuple[int, int, int]) -> np.ndarray:
    """The sizes of a full VBR chunk's ``items``, lowest pass-1 rank first:
    ``ops.encode_file.vbr_sizes_rows``' rule on one row, with ``dist`` =
    (m1, p1, p2) as the encoders take it (counts that may be negative or
    pass ``items`` where the target is far from the sizes)."""
    m1, p1, p2 = dist
    pos = np.arange(items)
    return np.clip((pos >= items - p2 - p1).astype(np.int64) + (pos >= items - p2) - (pos < m1) + base, 1, 8)


def vbr_chunk_size(
    channels: int, frames_per_chunk: int, scale_factor_bits: int, scale_factor_frames: int,
    base: int, dist: tuple[int, int, int],
) -> int:
    """Serialized byte length of a full VBR chunk. Every full chunk's items
    take the sizes ``vbr_rank_sizes`` gives, in some order, so every full
    chunk has the same residual bits and the same length."""
    items = frames_per_chunk // scale_factor_frames * channels
    res_bits = scale_factor_frames * int(vbr_rank_sizes(items, base, dist).sum())
    return _vbr_fixed_bytes(channels, items // channels, scale_factor_bits) + -(-res_bits // 8)


def _vbr_fixed_bytes(c: int, w: int, scale_factor_bits: int) -> int:
    """A VBR chunk's bytes before its residuals: header, LMS state, scale
    factors and the 2-bit relative sizes."""
    return 4 + 16 * c + -(-(w * c * scale_factor_bits) // 8) + -(-(w * c * 2) // 8)


def _pack_var_rows(codes: torch.Tensor, sizes: torch.Tensor, sff: int, nbytes: int) -> torch.Tensor:
    """codes uint8[R, F*C] (frame-major), sizes uint8[R, W, C] -> each
    code at its window's size (clamped to 1..8), MSB-first, uint8[R,
    nbytes]. A code touches <= 2 bytes and no two codes share a bit, so
    adding each code's two byte parts is the OR; bits past ``nbytes`` are
    dropped."""
    r = codes.shape[0]
    out = []
    for r0 in range(0, r, _PLAIN_BLOCK_ROWS):
        cd = codes[r0 : r0 + _PLAIN_BLOCK_ROWS].to(torch.int64)
        wd = sizes[r0 : r0 + _PLAIN_BLOCK_ROWS].to(torch.int64).clamp(1, 8)
        wd = wd.repeat_interleave(sff, dim=1).reshape(cd.shape)
        off = torch.cumsum(wd, dim=1) - wd
        v = (cd & ((1 << wd) - 1)) << (16 - wd - (off & 7))
        byte = off >> 3
        acc = torch.zeros((cd.shape[0], nbytes + 2), dtype=torch.int64, device=cd.device)
        acc.scatter_add_(1, byte.clamp(max=nbytes), v >> 8)
        acc.scatter_add_(1, (byte + 1).clamp(max=nbytes + 1), v & 0xFF)
        out.append(acc[:, :nbytes].to(torch.uint8))
    if not out:
        return torch.zeros((0, nbytes), dtype=torch.uint8, device=codes.device)
    return torch.cat(out)


def corpus_rows_vbr_plain(
    sf, codes, sizes, ehist, ewts, n_files, scale_factor_bits, scale_factor_frames, residual_size, chunk_size,
):
    """Plain PyTorch version of the VBR row kernel: same inputs, same
    output (see ``corpus_rows_vbr_device``)."""
    nc, w, b = sf.shape
    fpc = codes.shape[1]
    nf = n_files
    c = b // nf
    r = nf * nc
    sfb = scale_factor_bits

    def by_file(t, k):  # [nc, k, B] lane-packed -> [nf * nc, k, C], file-major
        return t.reshape(nc, k, nf, c).permute(2, 0, 1, 3).reshape(r, k, c)

    sz = by_file(sizes, w)
    eh = ehist.reshape(nc, nf, c, 4).permute(1, 0, 2, 3).reshape(r, c, 4)
    ew = ewts.reshape(nc, nf, c, 4).permute(1, 0, 2, 3).reshape(r, c, 4)
    head = torch.tensor(
        [CHUNK_TYPE_VBR, ((sfb << 4) | residual_size) & 0xFF, scale_factor_frames, 0x5A],
        dtype=torch.uint8,
        device=sf.device,
    ).expand(r, 4)
    parts = [
        head,
        lms_section_device(eh, ew),
        pack_bits_rows_device(by_file(sf, w).reshape(r, w * c), sfb),
        pack_bits_rows_device(sz.reshape(r, w * c).to(torch.int32) - residual_size + 1, 2),
        _pack_var_rows(
            by_file(codes, fpc).reshape(r, fpc * c), sz, scale_factor_frames,
            chunk_size - _vbr_fixed_bytes(c, w, sfb),
        ),
    ]
    return torch.cat(parts, dim=1).reshape(nf, nc, chunk_size)


def corpus_rows_vbr_device(
    sf: torch.Tensor,  # uint8[NC, W, B] lane-packed (B = n_files * C)
    codes: torch.Tensor,  # uint8[NC, W * sff, B]
    sizes: torch.Tensor,  # uint8[NC, W, B] absolute VBR sizes
    ehist: torch.Tensor,  # int32[NC, B, 4]
    ewts: torch.Tensor,  # int32[NC, B, 4]
    n_files: int,
    scale_factor_bits: int,
    scale_factor_frames: int,
    residual_size: int,
    chunk_size: int,
) -> torch.Tensor:
    """Lane-packed VBR encoder outputs (lane = file * C + channel, as
    ``ops.encode_file.corpus_vbr_scan`` returns them) -> per-file container
    rows uint8[n_files, NC, chunk_size], each byte-identical to
    ``batch.serialize_full_chunks`` on that file's lanes. ``chunk_size`` is
    a full chunk's length (``vbr_chunk_size``), at most 65,535. A file's
    rows past its full chunks are garbage the caller drops. A CUDA tensor
    launches ``csrc/serialize_vbr.cu`` on the current stream, a CPU tensor
    runs ``corpus_rows_vbr_plain``."""
    global launches
    dev = sf.device
    if sf.dim() != 3 or n_files < 1 or sf.shape[2] % n_files:
        raise ValueError(f"sf must be [NC, W, n_files * C], got {tuple(sf.shape)} for {n_files} files")
    nc, w, b = sf.shape
    c = b // n_files
    sff = scale_factor_frames
    if not (1 <= c <= 255 and 1 <= scale_factor_bits <= 8 and 1 <= sff <= 255 and w >= 1):
        raise ValueError(f"bad VBR row config C={c} sfb={scale_factor_bits} sff={sff} W={w}")
    for name, t, dtype, shape in (
        ("sf", sf, torch.uint8, (nc, w, b)),
        ("codes", codes, torch.uint8, (nc, w * sff, b)),
        ("sizes", sizes, torch.uint8, (nc, w, b)),
        ("ehist", ehist, torch.int32, (nc, b, 4)),
        ("ewts", ewts, torch.int32, (nc, b, 4)),
    ):
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype}{list(shape)} on {dev}, got {t.dtype}{list(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not _vbr_fixed_bytes(c, w, scale_factor_bits) <= chunk_size <= 0xFFFF:
        raise ValueError(f"bad VBR chunk_size {chunk_size}")
    args = (sf, codes, sizes, ehist, ewts, n_files, scale_factor_bits, sff, residual_size, chunk_size)
    if dev.type == "cpu":
        return corpus_rows_vbr_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows = torch.empty((n_files, nc, chunk_size), dtype=torch.uint8, device=dev)
    if nc == 0:
        return rows
    fn = _vbr_launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            sf.data_ptr(), codes.data_ptr(), sizes.data_ptr(), ehist.data_ptr(), ewts.data_ptr(),
            rows.data_ptr(), nc, n_files, c, w, sff, scale_factor_bits, residual_size, chunk_size, stream,
        )
    cuda_build.check(rc, "sea_serialize_vbr")
    launches += 1
    return rows


def _vbr_launcher():
    fn = cuda_build.load("serialize_vbr").sea_serialize_vbr
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 8 + [p]
    fn.restype = ctypes.c_int
    return fn
