"""The standalone LMS recurrence: a dequantized residual stream -> int16 PCM.

Replaces the TPU kernel ``sea_codec_tpu/ops/pallas_decode.py``
``lms_decode_lanes`` (and its interpret-mode twin). It is the second half of
the two-kernel decode (``ops.dequant`` writes the stream) and the whole
device part of ``device_decode.decode_chunks`` on unpacked codes. On a CUDA
tensor, ``lms_decode`` launches ``csrc/lms_decode.cu`` through the custom op
``sea_codec_torch::lms_decode`` (``ops.custom_ops``): the shared
recurrence ring of ``csrc/decode_ring.cuh`` (``ops.decode_ring``: a block of
``chunks_per_block(C)`` whole chunks, recurrence warps with one thread per
(chunk, channel) stream that walk only the chain), whose producer warps copy
tiles of the block's dq columns into the ring and PCM tiles out (see the
source note there). On a CPU tensor the op runs the plain PyTorch
version, ``lms_decode_plain``. ``launches`` counts kernel launches.

The stream is time-major, ``dq`` int16[F, N, C]: all streams' values of one
frame lie side by side, so a block's streams are contiguous columns and a
tile of them is a copy of whole rows. The PCM comes back as int16[N, F, C],
the layout of every decode entry.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, custom_ops, decode_ring, lms  # noqa: F401 (custom_ops: registers the op)

launches = 0

# A block holds every channel of a chunk, one recurrence thread each, and
# keeps at least one producer warp: 480 channels (the format's stop at 255).
MAX_CHANNELS = 32 * (decode_ring.MAX_WARPS - 1)


def lms_decode_plain(dq, hist0, wts0):
    """Plain PyTorch version of the kernel: same inputs, same output. The
    recurrence is vectorised over streams and loops over frames; the int32
    steps wrap as in the reference (``ops.lms``)."""
    f, n, c = dq.shape
    d = dq.to(torch.int64)
    hist = hist0.to(torch.int64)
    wts = wts0.to(torch.int64)
    out = torch.empty((n, f, c), dtype=torch.int16, device=dq.device)
    for t in range(f):
        recon = lms.clamp_i16(lms.predict(hist, wts) + d[t])
        out[:, t] = recon.to(torch.int16)
        hist, wts = lms.update(hist, wts, recon, d[t])
    return out


def lms_decode(dq, hist0, wts0):
    """Run the recurrence over ``dq`` int16[F, N, C] from the entry state
    ``hist0``/``wts0`` int32[N, C, 4] -> int16[N, F, C]. Any N, F >= 1 and
    1 <= C <= ``MAX_CHANNELS`` (N = 0 gives an empty result)."""
    if dq.dim() != 3 or dq.dtype != torch.int16:
        raise TypeError(f"dq must be int16[F, N, C], got {dq.dtype}{list(dq.shape)}")
    f, n, c = dq.shape
    device = dq.device
    for name, t in (("hist0", hist0), ("wts0", wts0)):
        if t.dtype != torch.int32 or t.device != device or t.shape != (n, c, 4):
            raise ValueError(f"{name} must be int32[{n}, {c}, 4] on {device}")
    if f < 1 or not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"dq needs at least one frame and 1..{MAX_CHANNELS} channels, got {list(dq.shape)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if n * c >= 1 << 31:
        raise ValueError(f"{n * c} streams exceed the kernel's int32 indexing")
    return torch.ops.sea_codec_torch.lms_decode(dq, hist0, wts0)


def _launch(dq, hist0, wts0):
    """The op's CUDA kernel: one launch of ``csrc/lms_decode.cu`` on inputs
    ``lms_decode`` checked."""
    global launches
    f, n, c = dq.shape
    device = dq.device
    dq, hist0, wts0 = dq.contiguous(), hist0.contiguous(), wts0.contiguous()
    out = torch.empty((n, f, c), dtype=torch.int16, device=device)
    if n == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(dq.data_ptr(), hist0.data_ptr(), wts0.data_ptr(), out.data_ptr(), n, f, c,
                decode_ring.tile_frames(c), decode_ring.chunks_per_block(c), stream)
    cuda_build.check(rc, "sea_lms_decode")
    launches += 1
    return out


def _launcher():
    fn = cuda_build.load("lms_decode").sea_lms_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn
