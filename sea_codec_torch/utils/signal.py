"""Synthetic test-signal generator and audio quality metrics.

Reproduces the reference test fixtures (``tests/helpers.rs:29-116``): layered
square/sine waves over regions of the buffer, mono expanded to N channels
with a per-channel delay of rate/25 samples, and the RMS/PSNR oracle
(psnr = -20*log10(2/rms); *lower* is better, tests gate at < -20 dB).
"""

from __future__ import annotations

import numpy as np

TEST_SAMPLE_RATE = 44100


def _write_square_wave(signal: np.ndarray, gain: float, frequency: float) -> None:
    period = TEST_SAMPLE_RATE / frequency
    i = np.arange(signal.shape[0])
    high = (i % int(period)) < int(period / 2.0)
    signal += np.where(high, gain, -gain).astype(np.float32)


def _write_sine_wave(signal: np.ndarray, gain: float, frequency: float) -> None:
    w = 2.0 * np.pi * frequency / TEST_SAMPLE_RATE
    i = np.arange(signal.shape[0], dtype=np.float64)
    signal += (gain * np.sin(w * i)).astype(np.float32)


def _chunk(signal: np.ndarray, start: float, end: float) -> np.ndarray:
    n = signal.shape[0]
    return signal[int(n * start) : int(n * end)]


def _mono_to_multi(mono: np.ndarray, channels: int) -> np.ndarray:
    delay = TEST_SAMPLE_RATE // 25
    total = mono.shape[0] + (channels - 1) * delay
    multi = np.zeros(total * channels, dtype=np.float32)
    for ch in range(channels):
        idx = (np.arange(mono.shape[0]) + delay * ch) * channels + ch
        keep = idx < multi.shape[0]
        multi[idx[keep]] = mono[keep]
    return multi


def gen_test_signal(channels: int, samples: int) -> np.ndarray:
    """int16 interleaved multi-channel test signal (helpers.rs:79-93)."""
    mono = np.zeros(samples, dtype=np.float32)
    _write_square_wave(_chunk(mono, 0.0, 0.3), 0.5, 440.0)
    _write_square_wave(_chunk(mono, 0.1, 0.2), 0.3, 2150.1)
    _write_sine_wave(_chunk(mono, 0.1, 0.7), 0.5, 105.0)
    _write_square_wave(_chunk(mono, 0.6, 0.7), 0.5, 14000.0)
    _write_sine_wave(_chunk(mono, 0.5, 0.8), 0.8, 12000.0)
    _write_sine_wave(_chunk(mono, 0.8, 0.9), 1.0, 440.0)
    multi = _mono_to_multi(mono, channels)
    return (np.clip(multi, -1.0, 1.0) * 32767.0).astype(np.int16)


def varied_signal(channels: int, frames: int, seed: int) -> np.ndarray:
    """int16 interleaved signal with seed-dependent content: a random layered
    mix of sines/squares (random regions, frequencies, gains) plus a low
    noise floor. Used for bench corpora, where per-file content diversity
    matters (identical files would make VBR size distributions, parse costs
    and group batching unrealistically homogeneous); tests keep
    ``gen_test_signal`` for reference parity."""
    rng = np.random.default_rng(seed)
    mono = np.zeros(frames, dtype=np.float32)
    for _ in range(int(rng.integers(3, 8))):
        a, b = np.sort(rng.uniform(0.0, 1.0, 2))
        if b - a < 0.05:
            b = min(1.0, a + 0.05)
        region = _chunk(mono, float(a), float(b))
        freq = float(rng.uniform(60.0, 15000.0))
        gain = float(rng.uniform(0.1, 0.8))
        if rng.random() < 0.5:
            _write_sine_wave(region, gain, freq)
        else:
            _write_square_wave(region, gain, freq)
    mono += rng.normal(0.0, float(rng.uniform(0.001, 0.02)), frames).astype(np.float32)
    multi = _mono_to_multi(mono, channels)[: frames * channels]
    return (np.clip(multi, -1.0, 1.0) * 32767.0).astype(np.int16)


def audio_quality(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(rms, psnr) between two int16 signals (helpers.rs:101-116)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    af = a.astype(np.float64) / 32767.0
    bf = b.astype(np.float64) / 32767.0
    rms = float(np.sqrt(np.mean((af - bf) ** 2)))
    psnr = -20.0 * np.log10(2.0 / rms) if rms > 0 else float("-inf")
    return rms, psnr
