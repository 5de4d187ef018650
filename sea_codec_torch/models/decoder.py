"""Chunk decoder model for a single (ragged tail) chunk
(reference ``src/codec/decoder.rs``).

Full chunks decode in batches in ``batch.decode_sea``; a single chunk (the
ragged tail, or any chunk of a session) goes through the same router
(``ops.device_decode.decode_chunks_packed``) at its own length: its residual
section as packed on the wire already lies where the full-chunk addressing
expects it (every window before the last is complete; the last window holds
the leading frames), and the kernels take a partial last window. The JAX
package pads the tail to a full chunk to reuse one compiled program; here
nothing is compiled per shape, and the padding would only add work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..container import CHUNK_TYPE_VBR, SeaChunk
from ..ops.device_decode import decode_chunks_packed
from ..utils.errors import SeaInvalidFrame


class DecoderModel:
    def __init__(self, channels: int, scale_factor_bits: int, device):
        self.channels = channels
        self.scale_factor_bits = scale_factor_bits
        self.device = device

    def decode_chunk(self, chunk: SeaChunk) -> np.ndarray:
        """Decode one chunk -> int16[frames * channels] interleaved."""
        if chunk.scale_factor_bits != self.scale_factor_bits:
            raise SeaInvalidFrame(
                "chunk scale_factor_bits "
                f"{chunk.scale_factor_bits} != stream {self.scale_factor_bits}"
            )
        c = self.channels
        f = chunk.frames_in_chunk
        sff = chunk.scale_factor_frames
        w = -(-f // sff)
        up = lambda a: torch.from_numpy(np.require(a, requirements=("C", "W"))).to(self.device)
        sf = up(chunk.scale_factors.reshape(1, w, c))
        hist = up(chunk.lms_history.reshape(1, c, 4).astype(np.int32))
        wts = up(chunk.lms_weights.reshape(1, c, 4).astype(np.int32))
        packed = up(chunk.residual_bytes[None])  # as on the wire
        vbr = chunk.chunk_type == CHUNK_TYPE_VBR
        rs = up(chunk.vbr_residual_sizes.reshape(1, w, c)) if vbr else None
        out = decode_chunks_packed(
            packed, sf, rs, hist, wts, sfb=self.scale_factor_bits, sff=sff, frames=f,
            residual_size=0 if vbr else chunk.residual_size,
        )
        return out.cpu().numpy().reshape(f * c)
