"""The dequant prologs of the two-kernel decode: packed residual bytes ->
the time-major int16 dq stream that ``ops.lms_decode`` walks.

Replaces the TPU kernels ``sea_codec_tpu/ops/pallas_dequant.py``
``unpack_dequant_cbr_lanes`` and ``unpack_dequant_vbr_lanes``. On a CUDA
tensor, ``unpack_dequant_cbr`` launches ``csrc/dequant_cbr.cu`` and
``unpack_dequant_vbr`` launches ``csrc/dequant_vbr.cu`` (one thread per
(chunk, channel) stream over a tile of frames, nothing staged per chunk, so
a row of any length decodes; see the source notes there). On a CPU tensor
each runs its plain PyTorch version (``unpack_dequant_cbr_plain``,
``unpack_dequant_vbr_plain``: ``device_decode``'s unpack, then
``dequant_codes``). ``cbr_launches`` and ``vbr_launches`` count kernel
launches. Both take a partial last window (``frames % sff != 0``).

The VBR addressing that is a prefix sum over the size table (each window's
first bit, its bits per frame, each channel's bit offset in a frame) is
computed here with ``cumsum`` (``vbr_addressing``), outside the kernel, as
the JAX package computes it outside its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, tables
from .device_decode import clean_vbr_tables, dequant_codes, unpack_const, unpack_var

cbr_launches = 0
vbr_launches = 0

_INT32_BITS = (1 << 31) - 1


def unpack_dequant_cbr_plain(res_bytes, sf_codes, *, sfb, rs, sff, frames):
    """Plain PyTorch version of the CBR kernel: same inputs, same output."""
    n, _w, c = sf_codes.shape
    codes = unpack_const(res_bytes, rs, frames * c).reshape(n, frames, c)
    return dequant_codes(codes, sf_codes, sfb, sff, rs).permute(1, 0, 2).contiguous()


def unpack_dequant_vbr_plain(res_bytes, sf_codes, rs, *, sfb, sff, frames):
    """Plain PyTorch version of the VBR kernel: same inputs, same output."""
    sf_codes, rs = clean_vbr_tables(sf_codes, rs, sfb)
    codes = unpack_var(res_bytes, rs, sff, frames)
    return dequant_codes(codes, sf_codes, sfb, sff, rs).permute(1, 0, 2).contiguous()


def vbr_addressing(rs, sff: int, frames: int):
    """(win_start int32[N, W], wsum int32[N, W], prefix int32[N, W, C]) of
    the sizes ``rs`` uint8[N, W, C]: a code's bit offset in its row is
    ``win_start[w] + t*wsum[w] + prefix[w, ch]`` (see
    ``device_decode.unpack_var``). Sizes clamp to 1..8, as the kernel reads
    them."""
    w = rs.shape[1]
    r = rs.to(torch.int32).clamp(1, 8)
    wsum = r.sum(dim=2, dtype=torch.int32)
    # the channel scan runs over the outer dimension of a transposed copy: a
    # scan over an innermost dimension of a few channels is some hundred
    # times slower on a CUDA card (scripts/torch_vbr_dequant_probe.py)
    rt = r.permute(2, 0, 1).contiguous()
    prefix = (rt.cumsum(dim=0, dtype=torch.int32) - rt).permute(1, 2, 0).contiguous()
    fiw = (frames - torch.arange(w, device=rs.device, dtype=torch.int32) * sff).clamp(0, sff)
    win_bits = fiw[None, :] * wsum
    win_start = win_bits.cumsum(dim=1, dtype=torch.int32) - win_bits
    return win_start, wsum, prefix


def _check(res_bytes, tabs, sfb, sff, frames):
    """Shapes, types and devices shared by both wrappers; ``tabs`` are the
    named uint8[N, W, C] tables, the first the scale factors."""
    sf_codes = tabs[0][1]
    if sf_codes.dim() != 3:
        raise ValueError(f"sf_codes must be [N, W, C], got {tuple(sf_codes.shape)}")
    n, w, c = sf_codes.shape
    device = sf_codes.device
    if not (1 <= sfb <= 8 and sff >= 1 and 1 <= c <= 255 and frames >= 1):
        raise ValueError(f"bad decode config sfb={sfb} sff={sff} c={c} frames={frames}")
    if w != -(-frames // sff):
        raise ValueError(f"sf has {w} windows, {frames} frames need {-(-frames // sff)}")
    if frames * c * 8 > _INT32_BITS:
        raise ValueError(f"{frames} frames x {c} channels exceed the kernels' int32 bit offsets")
    if res_bytes.dim() != 2 or res_bytes.shape[0] != n:
        raise ValueError(f"res_bytes must be [{n}, B], got {tuple(res_bytes.shape)}")
    for name, t, shape in (("res_bytes", res_bytes, res_bytes.shape),
                           *((name, t, (n, w, c)) for name, t in tabs)):
        if t.dtype != torch.uint8 or t.device != device or t.shape != shape:
            raise ValueError(f"{name} must be uint8{list(shape)} on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return n, w, c, device


def unpack_dequant_cbr(res_bytes, sf_codes, *, sfb, rs, sff, frames):
    """CBR rows -> dq int16[frames, N, C]. ``res_bytes`` uint8[N, B >=
    ceil(frames*C*rs/8)] as on the wire, ``sf_codes`` uint8[N,
    ceil(frames/sff), C]."""
    global cbr_launches
    n, w, c, device = _check(res_bytes, (("sf_codes", sf_codes),), sfb, sff, frames)
    if not 1 <= rs <= 8:
        raise ValueError(f"bad residual size {rs}")
    need = -(-(frames * c * rs) // 8)
    if res_bytes.shape[1] < need:
        raise ValueError(f"res_bytes must be [{n}, >={need}], got {tuple(res_bytes.shape)}")
    if device.type == "cpu":
        return unpack_dequant_cbr_plain(res_bytes, sf_codes, sfb=sfb, rs=rs, sff=sff, frames=frames)
    _sfval, _recip, c0_t, stepf_t, endv_t, kmax_t, _cl = tables.rs_tables(sfb)
    sfval = tables.kernel_tables(sfb, device)[0][rs]  # no host copy per launch
    res_bytes, sf_codes = res_bytes.contiguous(), sf_codes.contiguous()
    out = torch.empty((frames, n, c), dtype=torch.int16, device=device)
    if n == 0:
        return out
    fn = _cbr_launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            res_bytes.data_ptr(), sf_codes.data_ptr(), sfval.data_ptr(), out.data_ptr(),
            n, res_bytes.shape[1], c, w, frames, 1 << sfb, rs, sff,
            float(c0_t[rs]), float(stepf_t[rs]), float(endv_t[rs]), int(kmax_t[rs]),
            stream,
        )
    cuda_build.check(rc, "sea_dequant_cbr")
    cbr_launches += 1
    return out


def unpack_dequant_vbr(res_bytes, sf_codes, rs, *, sfb, sff, frames):
    """VBR rows -> dq int16[frames, N, C]. ``res_bytes`` uint8[N, B], each
    row holding the bits its size table implies (bytes past the row read as
    zero); ``sf_codes`` and ``rs`` uint8[N, ceil(frames/sff), C]."""
    global vbr_launches
    n, w, c, device = _check(res_bytes, (("sf_codes", sf_codes), ("rs", rs)), sfb, sff, frames)
    if device.type == "cpu":
        return unpack_dequant_vbr_plain(res_bytes, sf_codes, rs, sfb=sfb, sff=sff, frames=frames)
    win_start, wsum, prefix = vbr_addressing(rs, sff, frames)  # the kernel clamps and masks
    sfval, _recip, curve, ints, _qtab = tables.kernel_tables(sfb, device)
    res_bytes, sf_codes, rs = res_bytes.contiguous(), sf_codes.contiguous(), rs.contiguous()
    out = torch.empty((frames, n, c), dtype=torch.int16, device=device)
    if n == 0:
        return out
    fn = _vbr_launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            res_bytes.data_ptr(), sf_codes.data_ptr(), rs.data_ptr(), win_start.data_ptr(),
            wsum.data_ptr(), prefix.data_ptr(), sfval.data_ptr(), curve.data_ptr(),
            ints.data_ptr(), out.data_ptr(), n, res_bytes.shape[1], c, w, frames,
            1 << sfb, sff, stream,
        )
    cuda_build.check(rc, "sea_dequant_vbr")
    vbr_launches += 1
    return out


def _cbr_launcher():
    fn = cuda_build.load("dequant_cbr").sea_dequant_cbr
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, f, f, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def _vbr_launcher():
    fn = cuda_build.load("dequant_vbr").sea_dequant_vbr
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 10 + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    return fn
