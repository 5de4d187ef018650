"""VBR encoder model (reference ``src/codec/encoder_vbr.rs``).

Two passes per chunk:

1. *analyze*: search every window at ``base+1`` bits recording per-window
   per-channel error ranks, then restore the LMS state -- but, exactly like
   the reference (``encoder_vbr.rs:168`` restores only ``lms``), keep the
   advanced ``prev_scalefactor``.
2. choose per-(window, channel) residual sizes from the error ranking via the
   interpolated TARGET_RESIDUAL_DISTRIBUTION (``encoder_vbr.rs:20-21,66-137``,
   float32 arithmetic reproduced exactly), then search again with those sizes.

The ranking is a stable argsort (the reference's sort is unstable,
``encoder_vbr.rs:103``): on exactly tied error ranks the windows promoted
can differ from the Rust binary while the encoding stays valid and
deterministic. Sizes are clamped to 1..8 (the reference panics on 0 or 9).
The whole-file path encodes full chunks in ``ops.encode_file``; this model
encodes the ragged tail chunk, whose last window is masked to its valid
frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.encode_file import vbr_size_range, vbr_sizes
from ..ops.tables import LMS_LEN
from ..ops.window_search import window_search
from .common import EncodedSamples, EncoderBaseState

# ([0, target-1, target, target+1, target+2, 0]) -- reference encoder_vbr.rs:21
TARGET_RESIDUAL_DISTRIBUTION = (0.00, 0.00, 0.95, 0.05, 0.00, 0.00)


def normalized_vbr_bitrate(
    residual_bits: float,
    frames_per_chunk: int,
    scale_factor_bits: int,
    scale_factor_frames: int,
) -> np.float32:
    """Compensate the target bitrate for container overhead, f32-exact.

    Reference ``encoder_vbr.rs:40-63``.
    """
    f32 = np.float32
    d = [f32(x) for x in TARGET_RESIDUAL_DISTRIBUTION]
    vbr = f32(residual_bits)
    # compensate lms
    vbr = f32(vbr - f32(f32(f32(LMS_LEN) * f32(16.0) * f32(2.0)) / f32(frames_per_chunk)))
    # compensate scale factor data
    vbr = f32(vbr - f32(f32(scale_factor_bits) / f32(scale_factor_frames)))
    # compensate vbr data
    vbr = f32(vbr - f32(f32(2.0) / f32(scale_factor_frames)))
    # compensate with target distribution
    base = f32(np.floor(f32(residual_bits)))
    new_bitrate = f32(
        f32(f32(d[1] * f32(base - f32(1.0))) + f32(d[2] * base))
        + f32(f32(d[3] * f32(base + f32(1.0))) + f32(d[4] * f32(base + f32(2.0))))
    )
    diff = f32(new_bitrate - base)
    return f32(vbr - diff)


def interpolate_distribution(items: int, target_rate: np.float32) -> tuple[int, int, int, int]:
    """Item counts for sizes [target-1, target, target+1, target+2].

    Exact f32 replication of reference ``encoder_vbr.rs:66-96`` including the
    truncating casts and the leftover dump into the target bucket.
    """
    f32 = np.float32
    d = [f32(x) for x in TARGET_RESIDUAL_DISTRIBUTION]
    frac = f32(target_rate - np.trunc(target_rate))
    om_frac = f32(f32(1.0) - frac)
    pct = [f32(f32(d[i] * frac) + f32(d[i + 1] * om_frac)) for i in range(4)]

    res = [0, 0, 0, 0]
    total = 0
    while total < items:
        remaining = items - total
        for i in range(4):
            value = int(f32(f32(remaining) * pct[i]))  # f32 mult, trunc
            total += value
            res[i] += value
        if items - total == remaining:
            total += remaining
            res[1] += remaining
    return res[0], res[1], res[2], res[3]


def vbr_base(target: np.float32) -> int:
    """trunc-to-u8 with saturation, matching Rust `f32 as u8`
    (``encoder_vbr.rs:108,140``): tiny-chunk/high-overhead configs can push
    the normalized target negative; Rust saturates to 0."""
    return int(np.clip(np.trunc(np.float32(target)), 0, 255))


def chunk_residual_size(residual_bits: float, target: np.float32) -> int:
    """The chunk header's residual_size field, which anchors the 2-bit size
    deltas (stored as size - field + 1, range 0..3). The reference always
    writes floor(residual_bits) (chunk.rs:60), which gives corrupt streams
    when overhead compensation pulls the size base more than 1 below it; the
    anchor min(floor(residual_bits), base + 1) is byte-identical wherever the
    reference is correct, and valid everywhere."""
    return min(int(np.floor(residual_bits)), vbr_base(target) + 1)


class VbrEncoderModel:
    def __init__(
        self,
        channels: int,
        scale_factor_bits: int,
        scale_factor_frames: int,
        residual_bits: float,
        frames_per_chunk: int,
        state: EncoderBaseState,
    ):
        self.channels = channels
        self.scale_factor_bits = scale_factor_bits
        self.scale_factor_frames = scale_factor_frames
        self.vbr_target_bitrate = normalized_vbr_bitrate(
            residual_bits, frames_per_chunk, scale_factor_bits, scale_factor_frames
        )
        self.chunk_residual_size = chunk_residual_size(residual_bits, self.vbr_target_bitrate)
        self.state = state

    @property
    def lms_snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """Chunk-entry LMS state (reference src/codec/file.rs:146-149)."""
        return self.state.hist.cpu().numpy(), self.state.wts.cpu().numpy()

    def encode(self, samples: np.ndarray) -> EncodedSamples:
        """samples: int16[frames * channels] interleaved; one chunk's worth."""
        c = self.channels
        sff = self.scale_factor_frames
        device = self.state.hist.device
        frames = samples.shape[0] // c
        w = -(-frames // sff)
        x = np.zeros((w * sff, c), dtype=np.int16)
        x[:frames] = samples.reshape(frames, c)
        n_valid = np.clip(frames - np.arange(w) * sff, 0, sff).astype(np.int32)
        x_d = torch.from_numpy(x).to(device)
        nv_d = torch.from_numpy(n_valid).to(device)
        kw = dict(sfb=self.scale_factor_bits, sff=sff, wpc=max(w, 1))
        hist, wts = self.state.hist, self.state.wts

        # pass 1: analyze at base+1; LMS restored, prev_sf kept
        base = vbr_base(self.vbr_target_bitrate)
        _sf, _codes, ranks, _eh, _ew, _h1, _w1, prev1 = window_search(
            x_d, nv_d, hist, wts, self.state.prev_sf, rs=base + 1, ranks_only=True, **kw
        )
        # last partial windows must keep the base size (encoder_vbr.rs:100)
        sortable = samples.shape[0] // sff
        m1, _t, p1, p2 = interpolate_distribution(sortable, self.vbr_target_bitrate)
        sizes = vbr_sizes(ranks, base, (m1, p1, p2), sortable)

        # pass 2: encode with the assigned sizes
        sf, codes, _ranks, _eh, _ew, hist2, wts2, prev2 = window_search(
            x_d, nv_d, hist, wts, prev1, rs=sizes, rs_range=vbr_size_range(base), **kw
        )
        self.state = EncoderBaseState(hist2, wts2, prev2)
        return EncodedSamples(
            scale_factors=sf.cpu().numpy().reshape(-1),
            residuals=codes[:frames].cpu().numpy().reshape(-1),
            residual_bits=sizes.to(torch.uint8).cpu().numpy().reshape(-1),
        )
