"""Whole-file encode and decode, CBR and VBR -- the performance path.

A ``.sea`` file is a fixed-size-chunk container, so every full chunk of a
file has an *identical* byte layout. Decode: the host slices the container
(LMS i16 views, small scale-factor and size unpacks); the packed residual
bytes go to the device untouched, and one fused kernel launch per batch of
chunks unpacks, dequantizes and runs the LMS recurrence for all chunks x
channels (``ops.fused_decode`` for CBR, ``ops.fused_decode_vbr`` for VBR).
The ragged final chunk decodes through the same kernel (``models.decoder``).
Encode: the scale-factor search kernel walks every window of every full
chunk (``ops.encode_file``: one launch for CBR, two per chunk for VBR); CBR
rows are packed on the device (``ops.serialize_device``), VBR rows on the
host (``serialize_full_chunks``); the ragged tail chunk is encoded from the
carried state (``models.cbr``, ``models.vbr``).

Output is byte-identical to ``sea_codec_tpu.batch``.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from .api import SeaDecodeInfo
from .container import (
    CHUNK_TYPE_CBR,
    CHUNK_TYPE_VBR,
    SeaChunk,
    SeaFileHeader,
    scale_factor_items,
)
from .models.decoder import DecoderModel
from .ops import bitpack
from .ops.fused_decode import decode_cbr_fused
from .ops.fused_decode_vbr import decode_vbr_fused
from .utils.device import resolve_device
from .utils.errors import SeaInvalidFrame

_PACK_BLOCK_ROWS = 64  # chunks per host VBR pack; the bytes do not depend on it


class ParsedBatch:
    """Host-parsed arrays for the full chunks of one file."""

    def __init__(self, res_bytes, sf, rs, hist, wts, sfb, sff, residual_size, chunk_type):
        self.res_bytes = res_bytes  # uint8[N, B] packed residual section
        self.sf = sf  # uint8[N, W, C]
        self.rs = rs  # uint8[N, W, C]
        self.hist = hist  # int32[N, C, 4]
        self.wts = wts  # int32[N, C, 4]
        self.scale_factor_bits = sfb
        self.scale_factor_frames = sff
        self.residual_size = residual_size  # constant width for CBR, 0 for VBR
        self.chunk_type = chunk_type


def parse_full_chunks(body: np.ndarray, header: SeaFileHeader) -> ParsedBatch:
    """Parse [N, chunk_size] full-chunk bytes; residuals stay packed."""
    n = body.shape[0]
    c = header.channels
    fpc = header.frames_per_chunk

    chunk_type = int(body[0, 0])
    if chunk_type not in (CHUNK_TYPE_CBR, CHUNK_TYPE_VBR):
        raise SeaInvalidFrame(f"bad chunk type {chunk_type:#x}")
    if not (
        np.all(body[:, 0] == chunk_type)
        and np.all(body[:, 1] == body[0, 1])
        and np.all(body[:, 2] == body[0, 2])
    ):
        raise SeaInvalidFrame("heterogeneous chunk configs in one file")
    sfb = int(body[0, 1]) >> 4
    residual_size = int(body[0, 1]) & 0x0F
    sff = int(body[0, 2])
    if not 1 <= sfb <= 8 or not 1 <= residual_size <= 8 or sff == 0:
        raise SeaInvalidFrame("bad chunk config")

    pos = 4
    lms_bytes = c * 16
    # corrupt headers can declare a chunk_size smaller than the sections the
    # chunk config implies; a clipped slice would crash the reshape/view
    # below instead of rejecting (same checks as SeaChunk.from_bytes)
    if body.shape[1] < pos + lms_bytes:
        raise SeaInvalidFrame("chunk too short for LMS state")
    lms = (
        np.ascontiguousarray(body[:, pos : pos + lms_bytes])
        .view("<i2")
        .reshape(n, c, 8)
        .astype(np.int32)
    )
    hist, wts = lms[:, :, :4], lms[:, :, 4:]
    pos += lms_bytes

    w = -(-fpc // sff)
    sf_items = scale_factor_items(fpc, sff, c)
    sf_bytes = bitpack.packed_byte_len(sfb, sf_items)
    if body.shape[1] < pos + sf_bytes:
        raise SeaInvalidFrame("chunk too short for scale factors")
    sf = bitpack.unpack_bits_rows(body[:, pos : pos + sf_bytes], sfb, sf_items)
    sf = sf.reshape(n, w, c)
    pos += sf_bytes

    if chunk_type == CHUNK_TYPE_VBR:
        vbr_bytes = bitpack.packed_byte_len(2, sf_items)
        if body.shape[1] < pos + vbr_bytes:
            raise SeaInvalidFrame("chunk too short for vbr sizes")
        deltas = bitpack.unpack_bits_rows(body[:, pos : pos + vbr_bytes], 2, sf_items)
        rs = (deltas.astype(np.int32) + residual_size - 1).astype(np.uint8).reshape(n, w, c)
        pos += vbr_bytes
        if np.any((rs < 1) | (rs > 8)):
            raise SeaInvalidFrame("bad vbr residual size")
        # per-chunk residual bytes implied by the size table (full chunks:
        # every window has sff frames except a shorter last one)
        wframes = np.full(w, sff, dtype=np.int64)
        wframes[-1] = fpc - (w - 1) * sff
        res_need = -(-(rs.astype(np.int64) * wframes[None, :, None]).sum(axis=(1, 2)) // 8)
        if int(res_need.max(initial=0)) > body.shape[1] - pos:
            raise SeaInvalidFrame("chunk too short for residuals")
        res_bytes = np.ascontiguousarray(body[:, pos:])
        const_width = 0
    else:
        rs = np.full((n, w, c), residual_size, dtype=np.uint8)
        nbytes = bitpack.packed_byte_len(residual_size, fpc * c)
        if body.shape[1] < pos + nbytes:
            raise SeaInvalidFrame("chunk too short for residuals")
        res_bytes = np.ascontiguousarray(body[:, pos : pos + nbytes])
        const_width = residual_size

    return ParsedBatch(res_bytes, sf, rs, hist, wts, sfb, sff, const_width, chunk_type)


def split_chunks(encoded: bytes):
    """(header, full_chunk_bytes uint8[N, chunk_size] | None, tail bytes)."""
    reader = io.BytesIO(encoded)
    header = SeaFileHeader.from_reader(reader)
    body = encoded[header.serialized_len :]
    cs = header.chunk_size
    fpc = header.frames_per_chunk
    total_frames = header.total_frames

    n_avail = len(body) // cs
    if total_frames > 0:
        # Only chunks holding exactly frames_per_chunk frames are "full";
        # a ragged final chunk can still occupy chunk_size bytes (and when a
        # file's FIRST chunk is ragged, chunk_size IS the ragged size), so
        # the rectangular path must be gated on frame count, not byte count.
        n_full = min(n_avail, total_frames // fpc)
        has_tail = total_frames % fpc != 0
    else:
        n_full = n_avail  # streaming: only whole chunks are decodable
        has_tail = False
    rect = None
    if n_full:
        rect = np.frombuffer(body[: n_full * cs], dtype=np.uint8).reshape(n_full, cs)
    tail = b""
    if has_tail:
        tail = body[n_full * cs :]
    return header, rect, tail


def decode_sea(encoded: bytes, device_batch: int = 1024, device=None) -> SeaDecodeInfo:
    """Decode a whole .sea stream, CBR or VBR (bit-identical to the JAX
    package). Full chunks decode ``device_batch`` chunks per kernel launch,
    each batch's PCM copied back before the next launch, so one batch's PCM
    is on the card at a time."""
    dev = resolve_device(device)
    if device_batch < 1:
        raise ValueError(f"device_batch must be >= 1, got {device_batch}")
    header, rect, tail = split_chunks(encoded)
    c = header.channels
    fpc = header.frames_per_chunk
    total_frames = header.total_frames

    parts: list[np.ndarray] = []
    if rect is not None:
        batch = parse_full_chunks(rect, header)
        n = rect.shape[0]
        vbr = batch.chunk_type == CHUNK_TYPE_VBR
        up = lambda a: torch.from_numpy(np.require(a, requirements=("C", "W"))).to(dev)
        res, sf, hist, wts = (up(a) for a in (batch.res_bytes, batch.sf, batch.hist, batch.wts))
        rs = up(batch.rs) if vbr else None
        kw = dict(sfb=batch.scale_factor_bits, sff=batch.scale_factor_frames, frames=fpc)
        pcm_parts = []
        for start in range(0, n, device_batch):
            sl = slice(start, start + device_batch)
            if vbr:
                out = decode_vbr_fused(res[sl], sf[sl], rs[sl], hist[sl], wts[sl], **kw)
            else:
                out = decode_cbr_fused(res[sl], sf[sl], hist[sl], wts[sl], rs=batch.residual_size, **kw)
            pcm_parts.append(out.cpu().numpy())
        pcm = np.concatenate(pcm_parts)  # [N, fpc, C]
        last = fpc
        if total_frames > 0:
            last = min(fpc, total_frames - (n - 1) * fpc)
        if last == fpc:
            parts.append(pcm.reshape(-1))
        else:
            parts.append(pcm[:-1].reshape(-1))
            parts.append(pcm[-1, :last].reshape(-1))

    if tail:
        n_full = rect.shape[0] if rect is not None else 0
        remaining = total_frames - n_full * fpc if total_frames > 0 else None
        chunk = SeaChunk.from_bytes(tail, header, remaining)
        model = DecoderModel(c, chunk.scale_factor_bits, dev)
        parts.append(model.decode_chunk(chunk))

    samples = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int16)
    if total_frames > 0 and samples.shape[0] < total_frames * c:
        raise SeaInvalidFrame(
            f"stream truncated: decoded {samples.shape[0] // c} of "
            f"{total_frames} frames"
        )
    return SeaDecodeInfo(
        samples=samples, sample_rate=header.sample_rate, channels=header.channels
    )


def _check_chunk_size(n: int) -> None:
    if n > 0xFFFF:
        from .utils.errors import SeaInvalidParameters

        raise SeaInvalidParameters(
            "chunk serializes to more than 65535 bytes (u16 chunk_size field);"
            " reduce frames_per_chunk, channels, or bitrate"
        )


def serialize_full_chunks(
    sf: np.ndarray,  # uint8[nc, w, C]
    codes: np.ndarray,  # uint8[nc, fpc, C]
    sizes: np.ndarray,  # uint8[nc, w, C] absolute VBR sizes
    ehist: np.ndarray,  # int32[nc, C, 4]
    ewts: np.ndarray,  # int32[nc, C, 4]
    scale_factor_bits: int,
    scale_factor_frames: int,
    residual_size: int,
) -> np.ndarray:
    """Host serialization of full VBR chunks -> uint8[nc, chunk_size].

    All full chunks share section lengths (the distribution counts are
    static per full chunk, so the residual bit total is constant), making
    the body one rectangular pack, done ``_PACK_BLOCK_ROWS`` rows at a time
    to bound the packer's temporaries (~40 bytes per code). Variable-width
    residuals cannot use the device serializer's static layouts."""
    nc, w, c = sf.shape
    fpc = codes.shape[1]
    sff = scale_factor_frames
    head = np.tile(
        np.array(
            [CHUNK_TYPE_VBR, ((scale_factor_bits << 4) | residual_size) & 0xFF, sff, 0x5A],
            dtype=np.uint8,
        ),
        (nc, 1),
    )
    lms = np.concatenate([ehist, ewts], axis=2).astype(np.int16)  # [nc, C, 8]
    lms_bytes = np.ascontiguousarray(lms.astype("<i2")).reshape(nc, -1).view(np.uint8)
    rel = (sizes.astype(np.int32) - residual_size + 1).astype(np.uint8)
    parts = [
        head,
        lms_bytes,
        bitpack.pack_bits_rows(sf.reshape(nc, w * c), scale_factor_bits),
        bitpack.pack_bits_rows(rel.reshape(nc, w * c), 2),
    ]
    res = []
    for b0 in range(0, nc, _PACK_BLOCK_ROWS):
        sz = sizes[b0 : b0 + _PACK_BLOCK_ROWS]
        widths = np.repeat(sz.astype(np.int64), sff, axis=1)[:, :fpc]
        res.append(
            bitpack.pack_bits_rows(
                codes[b0 : b0 + _PACK_BLOCK_ROWS].reshape(sz.shape[0], fpc * c),
                widths.reshape(sz.shape[0], fpc * c),
            )
        )
    parts.append(np.concatenate(res))
    return np.hstack(parts)


def encode_sea(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    settings=None,
    device=None,
) -> bytes:
    """Whole-file encode, byte-identical to the JAX package's
    ``batch.encode_sea``. CBR: one search launch for all full chunks, rows
    packed on the device. VBR: two search launches per full chunk
    (``ops.encode_file``), rows packed on the host. The ragged tail chunk is
    encoded from the carried state."""
    from .encoder import EncoderSettings, coerce_samples, validate_encode_params
    from .models.cbr import CbrEncoderModel
    from .models.common import EncoderBaseState
    from .models.vbr import (
        VbrEncoderModel,
        chunk_residual_size,
        interpolate_distribution,
        normalized_vbr_bitrate,
        vbr_base,
    )
    from .ops.encode_file import encode_file_cbr, encode_file_vbr
    from .ops.serialize_device import serialize_chunks_cbr_device

    if settings is None:
        settings = EncoderSettings()
    samples = coerce_samples(samples)
    validate_encode_params(channels, settings, samples.shape[0] // max(channels, 1))
    dev = resolve_device(device)
    c = channels
    fpc = settings.frames_per_chunk
    sff = settings.scale_factor_frames
    sfb = settings.scale_factor_bits
    frames = samples.shape[0] // c
    nc_full = frames // fpc
    residual_size = int(np.floor(settings.residual_bits))
    if settings.vbr:
        target = normalized_vbr_bitrate(settings.residual_bits, fpc, sfb, sff)
        residual_size = chunk_residual_size(settings.residual_bits, target)

    header = SeaFileHeader(
        version=1,
        channels=c,
        chunk_size=0,
        frames_per_chunk=fpc,
        sample_rate=sample_rate,
        total_frames=frames,
        metadata=settings.metadata,
    )
    state = EncoderBaseState.initial(c, dev)
    chunks: list[bytes] = []
    if nc_full:
        # int16 on the wire; the kernel reads the interleaved PCM as is
        pcm = np.require(samples[: nc_full * fpc * c], requirements=("C", "W"))
        x = torch.from_numpy(pcm).to(dev).reshape(nc_full, fpc, c)
        if settings.vbr:
            m1, _t, p1, p2 = interpolate_distribution((fpc * c) // sff, target)
            sf, codes, sizes, ehist, ewts, hist, wts, prev = encode_file_vbr(
                x, state.hist, state.wts, state.prev_sf,
                scale_factor_frames=sff,
                scale_factor_bits=sfb,
                base=vbr_base(target),
                dist=(m1, p1, p2),
            )
            rows = serialize_full_chunks(
                *(t.cpu().numpy() for t in (sf, codes, sizes, ehist, ewts)),
                scale_factor_bits=sfb,
                scale_factor_frames=sff,
                residual_size=residual_size,
            )
        else:
            sf, codes, ehist, ewts, hist, wts, prev = encode_file_cbr(
                x, state.hist, state.wts, state.prev_sf,
                scale_factor_frames=sff,
                scale_factor_bits=sfb,
                residual_size=residual_size,
            )
            rows = serialize_chunks_cbr_device(
                sf, codes, ehist, ewts,
                scale_factor_bits=sfb,
                scale_factor_frames=sff,
                residual_size=residual_size,
            ).cpu().numpy()
        chunks.extend(bytes(row) for row in rows)
        state = EncoderBaseState(hist, wts, prev)

    # ragged tail chunk from the carried state (the session's final chunk)
    tail_frames = frames - nc_full * fpc
    if tail_frames:
        if settings.vbr:
            model = VbrEncoderModel(c, sfb, sff, settings.residual_bits, fpc, state)
        else:
            model = CbrEncoderModel(c, sfb, sff, settings.residual_bits, state)
        ehist_t, ewts_t = model.lms_snapshot
        enc = model.encode(samples[nc_full * fpc * c : frames * c])
        chunk = SeaChunk(
            channels=c,
            frames_in_chunk=tail_frames,
            chunk_type=CHUNK_TYPE_VBR if settings.vbr else CHUNK_TYPE_CBR,
            scale_factor_bits=sfb,
            scale_factor_frames=sff,
            residual_size=residual_size,
            lms_history=ehist_t,
            lms_weights=ewts_t,
            scale_factors=enc.scale_factors,
            vbr_residual_sizes=enc.residual_bits,
            residuals=enc.residuals,
        )
        chunks.append(chunk.serialize())

    if chunks:
        _check_chunk_size(len(chunks[0]))
        header.chunk_size = len(chunks[0])
    return header.serialize() + b"".join(chunks)
