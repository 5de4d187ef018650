"""Chunk decoder model for a single (ragged tail) chunk
(reference ``src/codec/decoder.rs``).

Full chunks decode as one batch in ``batch.decode_sea``; the ragged tail
chunk goes through the same fused kernel by zero-padding its packed
residuals and scale factors to a full chunk. The recurrence runs forward, so
the real frames are unaffected by the padding, which is sliced away.
"""

from __future__ import annotations

import numpy as np
import torch

from ..container import CHUNK_TYPE_VBR, SeaChunk
from ..ops import bitpack
from ..ops.fused_decode import decode_cbr_fused
from ..utils.errors import SeaInvalidFrame


class DecoderModel:
    def __init__(self, channels: int, scale_factor_bits: int, device):
        self.channels = channels
        self.scale_factor_bits = scale_factor_bits
        self.device = device

    def decode_chunk(self, chunk: SeaChunk, frames_padded: int | None = None) -> np.ndarray:
        """Decode one CBR chunk -> int16[frames * channels] interleaved,
        padded to ``frames_padded`` frames for the kernel."""
        if chunk.chunk_type == CHUNK_TYPE_VBR:
            raise NotImplementedError(
                "VBR decode is not ported yet (see ROADMAP.md, Queue A)"
            )
        if chunk.scale_factor_bits != self.scale_factor_bits:
            raise SeaInvalidFrame(
                "chunk scale_factor_bits "
                f"{chunk.scale_factor_bits} != stream {self.scale_factor_bits}"
            )
        c = self.channels
        f = chunk.frames_in_chunk
        sff = chunk.scale_factor_frames
        rs = chunk.residual_size
        w = -(-f // sff)
        fp = max(frames_padded or f, f)
        wp = -(-fp // sff)
        res = np.zeros((1, bitpack.packed_byte_len(rs, fp * c)), np.uint8)
        packed = bitpack.pack_bits(chunk.residuals, rs)
        res[0, : packed.shape[0]] = packed
        sf = np.zeros((1, wp, c), np.uint8)
        sf[0, :w] = chunk.scale_factors.reshape(w, c)
        dev = self.device
        out = decode_cbr_fused(
            torch.from_numpy(res).to(dev),
            torch.from_numpy(sf).to(dev),
            torch.from_numpy(chunk.lms_history.reshape(1, c, 4).astype(np.int32)).to(dev),
            torch.from_numpy(chunk.lms_weights.reshape(1, c, 4).astype(np.int32)).to(dev),
            sfb=self.scale_factor_bits, rs=rs, sff=sff, frames=fp,
        )
        return out.cpu().numpy().reshape(fp * c)[: f * c]
