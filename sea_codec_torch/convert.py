"""Carry state and settings over from the JAX package's numpy arrays.

A codec has no weights; what one implementation hands another mid-stream is
the encoder state (per-channel LMS history and weights, the previous winning
scale factor), a chunk's LMS entry state, and the settings. These helpers
take the JAX package's numpy values (or anything array-like) and return the
port's tensors and settings.
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
