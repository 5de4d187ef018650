"""The 4-tap sign-sign LMS predictor as PyTorch tensor functions.

Semantics are the reference's exactly (``src/codec/lms.rs``):

- ``predict`` = (sum_i w_i * h_i) >> 13, with *wrapping* int32 products and
  sum (the reference is Rust release-mode arithmetic).
- ``update``: delta = dequantized >> 4; w_i += sign(h_i)*delta (h_i >= 0 gets
  +delta); history shifts left and appends the reconstructed sample.
- ``weights_penalty`` = max((sum_i w_i^2 >> 18) - 0x8ff, 0)^2 in 64-bit.

PyTorch leaves int32 overflow to the C++ compiler, so the wrapping int32
steps are computed in int64 and folded back with ``wrap_i32``. State
tensors are int64 holding int32 values; the last axis is the 4 taps and any
leading batch axes (chunks, channels, candidates) broadcast through.
"""

from __future__ import annotations

import torch

from .tables import FLOATING_BITS, LMS_LEN

I16_MIN = -32768
I16_MAX = 32767


def initial_weights(channels: int, device="cpu") -> torch.Tensor:
    """int32[channels, 4] initial encoder weights (reference lms.rs:26-27)."""
    w = torch.zeros((channels, LMS_LEN), dtype=torch.int32, device=device)
    w[:, LMS_LEN - 2] = -(1 << (16 - FLOATING_BITS))  # -2^13
    w[:, LMS_LEN - 1] = 1 << (17 - FLOATING_BITS)  # 2^14
    return w


def initial_history(channels: int, device="cpu") -> torch.Tensor:
    return torch.zeros((channels, LMS_LEN), dtype=torch.int32, device=device)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits (int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def predict(history: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[..., 4] x [..., 4] int64 -> [...]; wrapping int32 dot then >> 13."""
    return wrap_i32((weights * history).sum(dim=-1)) >> (16 - FLOATING_BITS)


def clamp_i16(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(I16_MIN, I16_MAX)


def update(
    history: torch.Tensor,
    weights: torch.Tensor,
    reconstructed: torch.Tensor,
    dequantized: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LMS update step. ``reconstructed``/``dequantized`` are [...]."""
    delta = (dequantized >> (FLOATING_BITS + 1)).unsqueeze(-1)
    new_weights = wrap_i32(weights + torch.where(history < 0, -delta, delta))
    new_history = torch.cat([history[..., 1:], reconstructed.unsqueeze(-1)], dim=-1)
    return new_history, new_weights


def weights_penalty(weights: torch.Tensor) -> torch.Tensor:
    """u64 rank penalty of the *current* weights (reference lms.rs:53-62),
    as the int64 tensor holding the same 64 bits (wrapping multiplies)."""
    s = (weights * weights).sum(dim=-1)
    p = ((s >> 18) - 0x8FF).clamp_min(0)
    return p * p
