"""Fused VBR decode: packed residual bytes -> int16 PCM in one kernel.

Replaces the TPU kernel ``sea_codec_tpu/ops/pallas_fused_decode.py``
``decode_vbr_fused_single``. On a CUDA tensor, ``decode_vbr_fused`` launches
``csrc/fused_decode_vbr.cu`` through the custom op
``sea_codec_torch::fused_decode_vbr`` (``ops.custom_ops``): the shared
recurrence ring of ``csrc/decode_ring.cuh`` (``ops.decode_ring``), whose
producers build, for
each tile, the bit addressing of the windows it touches (each window's first
bit from a bit cursor carried from tile to tile, its bits per frame, each
channel's prefix) and then unpack the tile's codes straight from device
memory and read their values from the reference tables (``tables.dq_table``;
see the source note there). No packed row is staged, so
the gate ``fused_vbr_supported`` depends on (sfb, sff, C) alone and is open
for every legal one. On a CPU tensor the op runs the plain PyTorch
version, ``decode_vbr_plain``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, custom_ops, decode_ring, tables  # noqa: F401 (custom_ops: registers the op)
from .decode_ring import chunks_per_block, tile_frames
from .device_decode import clean_vbr_tables, decode_chunks_fn, unpack_var

launches = 0

_INT32_BITS = (1 << 31) - 1


def decode_vbr_plain(res_bytes, sf_codes, rs, hist0, wts0, *, sfb, sff, frames):
    """Plain PyTorch version of the kernel: same inputs, same output (sizes
    clamped to 1..8 and scale factors masked to 2^sfb, as the kernel reads
    them)."""
    sf_codes, rs = clean_vbr_tables(sf_codes, rs, sfb)
    codes = unpack_var(res_bytes, rs, sff, frames)
    return decode_chunks_fn(codes, sf_codes, hist0, wts0, sfb, sff, rs)


def windows_per_tile(sff: int, c: int, tile: int | None = None) -> int:
    """The most windows of ``sff`` frames that one tile of ``tile`` frames
    (by default the ring's, ``tile_frames(C)``) can touch."""
    return ((tile or tile_frames(c)) + sff - 2) // sff + 1


def _smem_bytes(sff: int, c: int) -> int:
    """Dynamic shared memory of one block, as the launch asks for it (layout
    in fused_decode_vbr.cu): the barriers, a dq ring laid out like the PCM
    ring, the PCM ring, and per chunk the windows a tile can touch (8 bytes
    each), their entries (8 bytes a channel) and a bit cursor."""
    g = chunks_per_block(c)
    nw = windows_per_tile(sff, c)
    return decode_ring.BARRIER_BYTES + 2 * decode_ring.pcm_ring_bytes(c) + 8 * g * nw * (1 + c) + 4 * g


def fused_vbr_supported(sfb: int, sff: int, c: int) -> bool:
    """Whether the kernel can take chunks of this geometry. Neither the row's
    length nor the number of windows bounds it: the rings and a tile's
    window tables fit for every legal (sfb, sff, C)."""
    return (1 <= sfb <= 8 and 1 <= sff <= 255 and 1 <= c <= 255
            and _smem_bytes(sff, c) <= cuda_build.SMEM_LIMIT)


def decode_vbr_fused(res_bytes, sf_codes, rs, hist0, wts0, *, sfb, sff, frames):
    """Decode N VBR chunks of ``frames`` frames each -> int16[N, frames, C].

    ``res_bytes`` uint8[N, B], each row holding the bits its size table
    implies (bytes past the row read as zero); ``sf_codes`` and ``rs``
    uint8[N, ceil(frames/sff), C]; ``hist0``/``wts0`` int32[N, C, 4]."""
    n, w, c = sf_codes.shape
    device = sf_codes.device
    if not (fused_vbr_supported(sfb, sff, c) and frames >= 1):
        raise ValueError(f"bad decode config sfb={sfb} sff={sff} c={c} frames={frames}")
    if w != -(-frames // sff):
        raise ValueError(f"sf has {w} windows, {frames} frames need {-(-frames // sff)}")
    if frames * c * 8 > _INT32_BITS:
        raise ValueError(f"{frames} frames x {c} channels exceed the kernel's int32 bit offsets")
    if res_bytes.dim() != 2 or res_bytes.shape[0] != n:
        raise ValueError(f"res_bytes must be [{n}, B], got {tuple(res_bytes.shape)}")
    for name, t, dtype, shape in (
        ("res_bytes", res_bytes, torch.uint8, res_bytes.shape),
        ("rs", rs, torch.uint8, (n, w, c)),
        ("hist0", hist0, torch.int32, (n, c, 4)),
        ("wts0", wts0, torch.int32, (n, c, 4)),
        ("sf_codes", sf_codes, torch.uint8, (n, w, c)),
    ):
        if t.dtype != dtype or t.device != device or t.shape != shape:
            raise ValueError(f"{name} must be {dtype}{list(shape)} on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return torch.ops.sea_codec_torch.fused_decode_vbr(res_bytes, sf_codes, rs, hist0, wts0, sfb, sff, frames)


def _launch(res_bytes, sf_codes, rs, hist0, wts0, sfb, sff, frames):
    """The op's CUDA kernel: one launch of ``csrc/fused_decode_vbr.cu`` on
    inputs ``decode_vbr_fused`` checked."""
    global launches
    n, w, c = sf_codes.shape
    device = sf_codes.device
    dqt = tables.dq_table(sfb, device)  # no host copy per launch
    res_bytes, sf_codes, rs = res_bytes.contiguous(), sf_codes.contiguous(), rs.contiguous()
    hist0, wts0 = hist0.contiguous(), wts0.contiguous()
    out = torch.empty((n, frames, c), dtype=torch.int16, device=device)
    if n == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            res_bytes.data_ptr(), sf_codes.data_ptr(), rs.data_ptr(), hist0.data_ptr(),
            wts0.data_ptr(), dqt.data_ptr(), out.data_ptr(), n, res_bytes.shape[1], c, w,
            frames, 1 << sfb, sff, tile_frames(c), chunks_per_block(c), windows_per_tile(sff, c),
            _smem_bytes(sff, c), stream,
        )
    cuda_build.check(rc, "sea_fused_decode_vbr")
    launches += 1
    return out


def _launcher():
    fn = cuda_build.load("fused_decode_vbr").sea_fused_decode_vbr
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] * 11 + [p]
    fn.restype = ctypes.c_int
    return fn
