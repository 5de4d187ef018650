"""CBR encoder model for one chunk (reference ``src/codec/encoder_cbr.rs``).

Constant residual size = floor(residual_bits); the chunk's windows run the
scale-factor search in order, with LMS and prev_sf carried in ``state``
across windows and chunks. The whole-file path encodes full chunks in
``ops.encode_file``; this model encodes the ragged tail chunk, whose last
window is masked to its valid frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.window_search import window_search
from .common import EncodedSamples, EncoderBaseState


class CbrEncoderModel:
    def __init__(
        self,
        channels: int,
        scale_factor_bits: int,
        scale_factor_frames: int,
        residual_bits: float,
        state: EncoderBaseState,
    ):
        self.channels = channels
        self.scale_factor_bits = scale_factor_bits
        self.scale_factor_frames = scale_factor_frames
        self.residual_size = int(np.floor(residual_bits))
        self.chunk_residual_size = self.residual_size  # the chunk header's field
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
        sf, codes, _ranks, _eh, _ew, hist, wts, prev = window_search(
            torch.from_numpy(x).to(device),
            torch.from_numpy(n_valid).to(device),
            self.state.hist, self.state.wts, self.state.prev_sf,
            sfb=self.scale_factor_bits, rs=self.residual_size, sff=sff, wpc=max(w, 1),
        )
        self.state = EncoderBaseState(hist, wts, prev)
        return EncodedSamples(
            scale_factors=sf.cpu().numpy().reshape(-1),
            residuals=codes[:frames].cpu().numpy().reshape(-1),
            residual_bits=np.zeros(0, dtype=np.uint8),
        )
