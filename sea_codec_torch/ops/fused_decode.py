"""Fused CBR decode: packed residual bytes -> int16 PCM in one kernel.

Replaces the TPU kernel ``sea_codec_tpu/ops/pallas_fused_decode.py``
``decode_cbr_fused_single``. On a CUDA tensor, ``decode_cbr_fused`` launches
``csrc/fused_decode_cbr.cu`` through the custom op
``sea_codec_torch::fused_decode_cbr`` (``ops.custom_ops``). What bounds it
is one stream's chain of ``frames`` dependent LMS steps, walked by a thread
that issues in order, so
everything that is not the chain runs on other warps: the shared recurrence
ring of ``csrc/decode_ring.cuh`` (``ops.decode_ring``: ``chunks_per_block(C)``
chunks a block, recurrence warps that walk only the chain, producer warps,
mbarriers between them), whose producers here unpack and dequantize tiles of
``tile_frames(C)`` frames straight from device memory into the dq ring, a
code's value read from the reference table (``tables.dq_table``). A block
stages no packed row, so rows of any length decode. On a CPU tensor
the op runs the plain PyTorch version, ``decode_cbr_plain``. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, custom_ops, decode_ring, tables  # noqa: F401 (custom_ops: registers the op)
from .decode_ring import chunks_per_block, tile_frames
from .device_decode import decode_chunks_fn, unpack_const

launches = 0


def decode_cbr_plain(res_bytes, sf_codes, hist0, wts0, *, sfb, rs, sff, frames):
    """Plain PyTorch version of the kernel: same inputs, same output."""
    n, _w, c = sf_codes.shape
    codes = unpack_const(res_bytes, rs, frames * c).reshape(n, frames, c)
    return decode_chunks_fn(codes, sf_codes, hist0, wts0, sfb, sff, rs)


def _smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block, as the launch asks for it (layout
    in fused_decode_cbr.cu): the barriers, a dq ring laid out like the PCM
    ring, the PCM ring."""
    return decode_ring.BARRIER_BYTES + 2 * decode_ring.pcm_ring_bytes(c)


def fused_cbr_supported(sfb: int, c: int) -> bool:
    """Whether the kernel can take chunks of this geometry. The kernel
    streams the packed row tile by tile, so neither the row's length nor
    ``rs`` bounds it: the rings fit for every legal (sfb, C)."""
    return 1 <= sfb <= 8 and 1 <= c <= 255 and _smem_bytes(c) <= cuda_build.SMEM_LIMIT


def _check_inputs(res_bytes, sf_codes, hist0, wts0, sfb, rs, sff, frames):
    n, w, c = sf_codes.shape
    if not (1 <= sfb <= 8 and 1 <= rs <= 8 and sff >= 1 and 1 <= c <= 255):
        raise ValueError(f"bad decode config sfb={sfb} rs={rs} sff={sff} c={c}")
    if w != -(-frames // sff):
        raise ValueError(f"sf has {w} windows, {frames} frames need {-(-frames // sff)}")
    need = -(-(frames * c * rs) // 8)
    if res_bytes.dim() != 2 or res_bytes.shape[0] != n or res_bytes.shape[1] < need:
        raise ValueError(f"res_bytes must be [{n}, >={need}], got {tuple(res_bytes.shape)}")
    for name, t, dtype in (
        ("res_bytes", res_bytes, torch.uint8),
        ("sf_codes", sf_codes, torch.uint8),
        ("hist0", hist0, torch.int32),
        ("wts0", wts0, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != sf_codes.device:
            raise ValueError(f"{name} is on {t.device}, sf_codes on {sf_codes.device}")
    if hist0.shape != (n, c, 4) or wts0.shape != (n, c, 4):
        raise ValueError("hist0/wts0 must be [N, C, 4]")
    if not fused_cbr_supported(sfb, c):
        raise ValueError(f"sfb={sfb} c={c} exceeds the kernel's shared memory")
    return n, w, c, need


def decode_cbr_fused(res_bytes, sf_codes, hist0, wts0, *, sfb, rs, sff, frames):
    """Decode N full-size CBR chunks -> int16[N, frames, C].

    ``res_bytes`` uint8[N, B >= ceil(frames*C*rs/8)], ``sf_codes``
    uint8[N, ceil(frames/sff), C], ``hist0``/``wts0`` int32[N, C, 4]."""
    _check_inputs(res_bytes, sf_codes, hist0, wts0, sfb, rs, sff, frames)
    if sf_codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sf_codes.device}")
    return torch.ops.sea_codec_torch.fused_decode_cbr(res_bytes, sf_codes, hist0, wts0, sfb, rs, sff, frames)


def _launch(res_bytes, sf_codes, hist0, wts0, sfb, rs, sff, frames):
    """The op's CUDA kernel: one launch of ``csrc/fused_decode_cbr.cu`` on
    inputs ``decode_cbr_fused`` checked."""
    global launches
    n, w, c = sf_codes.shape
    need = -(-(frames * c * rs) // 8)
    device = sf_codes.device
    dqt = tables.dq_table(sfb, device)  # no host copy per launch
    res_bytes = res_bytes.contiguous()
    sf_codes = sf_codes.contiguous()
    hist0 = hist0.contiguous()
    wts0 = wts0.contiguous()
    out = torch.empty((n, frames, c), dtype=torch.int16, device=device)
    if n == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            res_bytes.data_ptr(), sf_codes.data_ptr(), hist0.data_ptr(),
            wts0.data_ptr(), dqt.data_ptr() + 2 * tables.dq_table_offset(rs, sfb), out.data_ptr(),
            n, res_bytes.shape[1], need, c, w, frames, 1 << sfb, rs, sff, tile_frames(c),
            chunks_per_block(c), _smem_bytes(c), stream,
        )
    cuda_build.check(rc, "sea_fused_decode_cbr")
    launches += 1
    return out


def _launcher():
    fn = cuda_build.load("fused_decode_cbr").sea_fused_decode_cbr
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 12 + [p]
    fn.restype = ctypes.c_int
    return fn
