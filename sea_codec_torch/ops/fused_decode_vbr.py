"""Fused VBR decode: packed residual bytes -> int16 PCM in one kernel.

Replaces the TPU kernel ``sea_codec_tpu/ops/pallas_fused_decode.py``
``decode_vbr_fused_single``. On a CUDA tensor, ``decode_vbr_fused`` launches
``csrc/fused_decode_vbr.cu`` (one block per chunk, one thread per channel
stream, a running bit cursor per window; see the source note there). On a
CPU tensor it runs the plain PyTorch version, ``decode_vbr_plain``.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, tables
from .device_decode import decode_chunks_fn, unpack_var

launches = 0


def decode_vbr_plain(res_bytes, sf_codes, rs, hist0, wts0, *, sfb, sff, frames):
    """Plain PyTorch version of the kernel: same inputs, same output."""
    codes = unpack_var(res_bytes, rs, sff, frames)
    return decode_chunks_fn(codes, sf_codes, hist0, wts0, sfb, sff, rs)


def fused_vbr_supported(sfb: int, w: int, c: int, res_len: int) -> bool:
    """Whether the kernel can take chunks of this geometry: a block stages
    every size's tables, the chunk's size table and one whole packed row in
    shared memory."""
    return 4 * (9 * (1 << sfb) + 36) + w * c + res_len + 2 <= cuda_build.SMEM_LIMIT


def decode_vbr_fused(res_bytes, sf_codes, rs, hist0, wts0, *, sfb, sff, frames):
    """Decode N VBR chunks of ``frames`` frames each -> int16[N, frames, C].

    ``res_bytes`` uint8[N, B], each row holding at least the bits its size
    table implies; ``sf_codes`` and ``rs`` uint8[N, ceil(frames/sff), C]
    (sizes 1..8); ``hist0``/``wts0`` int32[N, C, 4]."""
    global launches
    n, w, c = sf_codes.shape
    device = sf_codes.device
    if not (1 <= sfb <= 8 and sff >= 1 and 1 <= c <= 255 and frames >= 1):
        raise ValueError(f"bad decode config sfb={sfb} sff={sff} c={c} frames={frames}")
    if w != -(-frames // sff):
        raise ValueError(f"sf has {w} windows, {frames} frames need {-(-frames // sff)}")
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
    s = 1 << sfb
    b = res_bytes.shape[1]
    if not fused_vbr_supported(sfb, w, c, b):
        raise ValueError(
            f"chunk of {b} residual bytes and {w}x{c} sizes exceeds shared memory; "
            "device_decode.decode_chunks_packed routes such chunks to the two-kernel path"
        )
    if device.type == "cpu":
        return decode_vbr_plain(
            res_bytes, sf_codes, rs, hist0, wts0, sfb=sfb, sff=sff, frames=frames
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    sfval, _recip, curve, ints, _qtab = tables.kernel_tables(sfb, device)
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
            wts0.data_ptr(), sfval.data_ptr(), curve.data_ptr(), ints.data_ptr(),
            out.data_ptr(), n, b, c, w, frames, s, sff, stream,
        )
    cuda_build.check(rc, "sea_fused_decode_vbr")
    launches += 1
    return out


def _launcher():
    fn = cuda_build.load("fused_decode_vbr").sea_fused_decode_vbr
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    return fn
