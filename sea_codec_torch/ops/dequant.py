"""The dequant prologs of the two-kernel decode: packed residual bytes ->
the time-major int16 dq stream that ``ops.lms_decode`` walks.

Replaces the TPU kernels ``sea_codec_tpu/ops/pallas_dequant.py``
``unpack_dequant_cbr_lanes`` and ``unpack_dequant_vbr_lanes``, and for VBR
the bit addressing the JAX package computes outside its kernel. Each
wrapper checks its inputs and calls its custom op (``ops.custom_ops``:
``sea_codec_torch::dequant_cbr``, ``::dequant_vbr``), whose CUDA kernel
allocates the output and launches one kernel: ``csrc/dequant_cbr.cu`` and
``csrc/dequant_vbr.cu``. Both are the fused
decodes' producers (``csrc/producer_cbr.cuh``, ``csrc/producer_vbr.cuh``)
without the recurrence: every warp of a block fills a shared-memory tile of
dq for a group of chunks and copies it out time-major; the VBR kernel builds
each tile's window addressing (prefix sums over the size table, a bit cursor
carried from tile to tile) itself. Both read a code's value from the
reference table (``tables.dq_table``, made on the card once per (sfb,
device)), as the fused kernels do. Nothing is staged per row, so a row of
any length decodes (see the source notes there). ``_cbr_launch`` and
``_vbr_launch`` size each launch: the launchers take their block shape and
shared memory from them and compute only the grid. On a CPU
tensor each op runs its plain PyTorch version (``unpack_dequant_cbr_plain``,
``unpack_dequant_vbr_plain``: ``device_decode``'s unpack, then
``dequant_codes``). ``cbr_launches`` and ``vbr_launches`` count kernel
launches. Both take a partial last window (``frames % sff != 0``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build, custom_ops, tables  # noqa: F401 (custom_ops: registers the ops)
from .decode_ring import chunks_per_block, tile_frames
from .device_decode import clean_vbr_tables, dequant_codes, unpack_const, unpack_var
from .fused_decode_vbr import windows_per_tile

cbr_launches = 0
vbr_launches = 0

_INT32_BITS = (1 << 31) - 1
_PAD = 4  # int16 after each chunk's sub-tile in a block's dq slot (kPad)
_MAX_GRID_Y = 65535
# threads a block: every warp a producer (at most 512, the kernels' bound)
CBR_THREADS = 256
VBR_THREADS = 256


def unpack_dequant_cbr_plain(res_bytes, sf_codes, *, sfb, rs, sff, frames):
    """Plain PyTorch version of the CBR kernel: same inputs, same output
    (scale factors masked to 2^sfb, as the kernel reads them)."""
    n, _w, c = sf_codes.shape
    codes = unpack_const(res_bytes, rs, frames * c).reshape(n, frames, c)
    sf_codes = sf_codes & ((1 << sfb) - 1)
    return dequant_codes(codes, sf_codes, sfb, sff, rs).permute(1, 0, 2).contiguous()


def unpack_dequant_vbr_plain(res_bytes, sf_codes, rs, *, sfb, sff, frames):
    """Plain PyTorch version of the VBR kernel: same inputs, same output."""
    sf_codes, rs = clean_vbr_tables(sf_codes, rs, sfb)
    codes = unpack_var(res_bytes, rs, sff, frames)
    return dequant_codes(codes, sf_codes, sfb, sff, rs).permute(1, 0, 2).contiguous()


def vbr_chunks_per_block(c: int) -> int:
    """Chunks one VBR dequant block decodes, walking their tiles in order:
    few, so that the blocks, each a serial walk over its chunks' tiles, are
    many (388 at 1,550 stereo chunks, all resident at once)."""
    return max(1, 8 // c)


def vbr_tile_frames(c: int) -> int:
    """Frames of a VBR dequant block's tile: four of the ring's tiles up to
    four channels (a block walks its tiles in series, and each costs a table
    build behind loads from device memory), the ring's beyond."""
    return tile_frames(c) * (4 if c <= 4 else 1)


def _slot_bytes(group: int, tile: int, c: int) -> int:
    """A block's dq slot: one sub-tile [tile, C] plus ``_PAD`` per chunk,
    rounded up to 16 bytes."""
    return -(-group * (tile * c + _PAD) * 2 // 16) * 16


def _cbr_launch(n: int, c: int, frames: int) -> dict:
    """The launch of ``csrc/dequant_cbr.cu``: a block per
    ``chunks_per_block(C)`` chunks (the grid's x) and tile of
    ``tile_frames(C)`` frames (its y); shared memory for the dq slot (the
    launcher takes ``smem`` as given)."""
    group, tile = chunks_per_block(c), tile_frames(c)
    return {
        "grid": (-(-n // group), -(-frames // tile)), "threads": CBR_THREADS,
        "smem": _slot_bytes(group, tile, c), "group": group, "tile": tile,
    }


def _vbr_launch(n: int, c: int, sff: int, frames: int) -> dict:
    """The launch of ``csrc/dequant_vbr.cu``: a block per
    ``vbr_chunks_per_block(C)`` chunks, each walking all their tiles of
    ``vbr_tile_frames(C)`` frames; shared memory for the dq slot and, per
    chunk, the windows a tile can touch (8 bytes each), their entries (8
    bytes a channel) and a bit cursor (the launcher takes ``smem`` as
    given)."""
    group, tile = vbr_chunks_per_block(c), vbr_tile_frames(c)
    nw = windows_per_tile(sff, c, tile)
    smem = _slot_bytes(group, tile, c) + 8 * group * nw * (1 + c) + 4 * group
    return {"grid": (-(-n // group),), "threads": VBR_THREADS, "smem": smem, "group": group,
            "tile": tile, "nwmax": nw}


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
    n, _w, c, _device = _check(res_bytes, (("sf_codes", sf_codes),), sfb, sff, frames)
    if not 1 <= rs <= 8:
        raise ValueError(f"bad residual size {rs}")
    if -(-frames // tile_frames(c)) > _MAX_GRID_Y:
        raise ValueError(f"{frames} frames exceed the kernel's grid of {_MAX_GRID_Y} tiles")
    need = -(-(frames * c * rs) // 8)
    if res_bytes.shape[1] < need:
        raise ValueError(f"res_bytes must be [{n}, >={need}], got {tuple(res_bytes.shape)}")
    return torch.ops.sea_codec_torch.dequant_cbr(res_bytes, sf_codes, sfb, rs, sff, frames)


def unpack_dequant_vbr(res_bytes, sf_codes, rs, *, sfb, sff, frames):
    """VBR rows -> dq int16[frames, N, C]. ``res_bytes`` uint8[N, B], each
    row holding the bits its size table implies (bytes past the row read as
    zero); ``sf_codes`` and ``rs`` uint8[N, ceil(frames/sff), C]."""
    _check(res_bytes, (("sf_codes", sf_codes), ("rs", rs)), sfb, sff, frames)
    return torch.ops.sea_codec_torch.dequant_vbr(res_bytes, sf_codes, rs, sfb, sff, frames)


def _launch_cbr(res_bytes, sf_codes, sfb, rs, sff, frames):
    """The CBR op's CUDA kernel: one launch of ``csrc/dequant_cbr.cu`` on
    inputs ``unpack_dequant_cbr`` checked."""
    global cbr_launches
    n, w, c = sf_codes.shape
    device = sf_codes.device
    need = -(-(frames * c * rs) // 8)
    dqt = tables.dq_table(sfb, device)  # no host copy per launch
    res_bytes, sf_codes = res_bytes.contiguous(), sf_codes.contiguous()
    out = torch.empty((frames, n, c), dtype=torch.int16, device=device)
    if n == 0:
        return out
    geo = _cbr_launch(n, c, frames)
    with torch.cuda.device(device):
        rc = _cbr_launcher()(
            res_bytes.data_ptr(), sf_codes.data_ptr(),
            dqt.data_ptr() + 2 * tables.dq_table_offset(rs, sfb), out.data_ptr(),
            n, res_bytes.shape[1], need, c, w, frames, 1 << sfb, rs, sff,
            geo["tile"], geo["group"], geo["threads"], geo["smem"],
            torch.cuda.current_stream(device).cuda_stream,
        )
    cuda_build.check(rc, "sea_dequant_cbr")
    cbr_launches += 1
    return out


def _launch_vbr(res_bytes, sf_codes, rs, sfb, sff, frames):
    """The VBR op's CUDA kernel: one launch of ``csrc/dequant_vbr.cu`` on
    inputs ``unpack_dequant_vbr`` checked."""
    global vbr_launches
    n, w, c = sf_codes.shape
    device = sf_codes.device
    dqt = tables.dq_table(sfb, device)  # no host copy per launch
    res_bytes, sf_codes, rs = res_bytes.contiguous(), sf_codes.contiguous(), rs.contiguous()
    out = torch.empty((frames, n, c), dtype=torch.int16, device=device)
    if n == 0:
        return out
    geo = _vbr_launch(n, c, sff, frames)  # the kernel clamps the sizes and masks the scale factors
    with torch.cuda.device(device):
        rc = _vbr_launcher()(
            res_bytes.data_ptr(), sf_codes.data_ptr(), rs.data_ptr(), dqt.data_ptr(),
            out.data_ptr(), n, res_bytes.shape[1], c, w, frames, 1 << sfb, sff,
            geo["tile"], geo["group"], geo["threads"], geo["nwmax"], geo["smem"],
            torch.cuda.current_stream(device).cuda_stream,
        )
    cuda_build.check(rc, "sea_dequant_vbr")
    vbr_launches += 1
    return out


@functools.cache
def _cbr_launcher():
    fn = cuda_build.load("dequant_cbr").sea_dequant_cbr
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 13 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _vbr_launcher():
    fn = cuda_build.load("dequant_vbr").sea_dequant_vbr
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 12 + [p]
    fn.restype = ctypes.c_int
    return fn
