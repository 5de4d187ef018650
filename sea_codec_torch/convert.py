"""Carry state and settings over from the JAX package's numpy arrays.

A codec has no weights; what one implementation hands another mid-stream is
the encoder state (per-channel LMS history and weights, the previous winning
scale factor), a chunk's LMS entry state, and the settings; and, between the
halves of the two-kernel decode, a parsed batch of chunks, a dequantized
residual stream and a lane-major LMS state. These helpers take the JAX
package's numpy values (or anything array-like), in its layouts, and return
the port's tensors and settings in the port's layouts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .encoder import EncoderSettings
from .models.common import EncoderBaseState


def _i32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.require(x, np.int32, ("C", "W"))).to(device)


def encoder_state(hist, wts, prev_sf, device="cpu") -> EncoderBaseState:
    """(hist [C, 4], wts [C, 4], prev_sf [C]) -> the port's encoder state."""
    return EncoderBaseState(_i32(hist, device), _i32(wts, device), _i32(prev_sf, device))


def lms_entry_state(hist, wts, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk LMS entry state [N, C, 4] x 2 -> int32 tensors."""
    return _i32(hist, device), _i32(wts, device)


def settings(jax_settings) -> EncoderSettings:
    """The JAX package's ``EncoderSettings`` -> the port's."""
    return EncoderSettings(
        **{f.name: getattr(jax_settings, f.name) for f in dataclasses.fields(EncoderSettings)}
    )


def parsed_batch(batch, device="cpu"):
    """The JAX package's ``ParsedBatch`` (or any object with its array
    fields) -> ``(res_bytes, sf, rs, hist, wts)`` tensors as
    ``ops.device_decode.decode_chunks_packed`` takes them."""
    u8 = lambda a: torch.from_numpy(np.require(a, np.uint8, ("C", "W"))).to(device)
    return (u8(batch.res_bytes), u8(batch.sf), u8(batch.rs),
            _i32(batch.hist, device), _i32(batch.wts, device))


def dq_stream(dq_rows, n: int, c: int, frames: int, device="cpu") -> torch.Tensor:
    """The JAX dequant kernels' output -> the port's dq stream int16[F, N, C].
    ``dq_rows`` int16[Fp*C, Npad] has code-major rows (row = frame*C +
    channel) and chunks on lanes, padded in both directions."""
    rows = np.asarray(dq_rows)
    npad = rows.shape[1]
    dq = rows.reshape(-1, c, npad)[:frames, :, :n].transpose(0, 2, 1)
    return torch.from_numpy(np.require(dq, np.int16, ("C", "W"))).to(device)


def lms_lane_state(lms_l, n: int, c: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX recurrence kernel's lane-major state int32[8, lanes] (planes
    h0..h3, w0..w3; lane = chunk*C + channel, padded) -> the port's entry
    state ``(hist, wts)`` int32[N, C, 4]."""
    state = np.asarray(lms_l).reshape(8, -1)[:, : n * c].T.reshape(n, c, 8)
    return _i32(state[:, :, :4], device), _i32(state[:, :, 4:], device)
