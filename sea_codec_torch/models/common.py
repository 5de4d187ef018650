"""Shared encoder-model plumbing.

``EncodedSamples`` mirrors the reference's encoder output struct
(``src/codec/common.rs:125-134``). ``EncoderBaseState`` holds the only state
the reference threads across scale-factor windows and chunks: per-channel LMS
and the previous winning scale factor (``encoder_base.rs:180-185``), as
int32 tensors on the encoder's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import lms as lms_ops


@dataclass
class EncodedSamples:
    scale_factors: np.ndarray  # uint8, window-major then channel
    residuals: np.ndarray  # uint8, interleaved like the input samples
    residual_bits: np.ndarray  # uint8 per (window, channel); empty for CBR


@dataclass
class EncoderBaseState:
    hist: torch.Tensor  # int32[C, 4]
    wts: torch.Tensor  # int32[C, 4]
    prev_sf: torch.Tensor  # int32[C]

    @classmethod
    def initial(cls, channels: int, device) -> "EncoderBaseState":
        return cls(
            lms_ops.initial_history(channels, device),
            lms_ops.initial_weights(channels, device),
            torch.zeros(channels, dtype=torch.int32, device=device),
        )
