"""The codec's tables and VBR arithmetic, built from the format's definitions
(``FORMAT.md``; upstream ``src/codec/dqt.rs``, ``qt.rs``, ``encoder_vbr.rs``).

Every floating-point step of the format is float32 with truncation (Rust
``as i32``) or rounding half away from zero (``f32::round``); numpy float32
scalars reproduce them.
"""

from __future__ import annotations

import functools

import numpy as np

LMS_LEN = 4
IDEAL_POW_FACTOR = (12.0, 11.65, 11.20, 10.58, 9.64, 8.75, 7.66, 6.63)
TARGET_RESIDUAL_DISTRIBUTION = (0.00, 0.00, 0.95, 0.05, 0.00, 0.00)

f32 = np.float32


def _trunc(x) -> int:
    return int(float(x))


def _round_half_away(x: np.float32) -> np.float32:
    return f32(np.floor(f32(x + f32(0.5)))) if x >= 0 else f32(np.ceil(f32(x - f32(0.5))))


@functools.cache
def scale_factors(rs: int, sfb: int) -> np.ndarray:
    """int64[2^sfb]: trunc(i ^ (IDEAL_POW_FACTOR[rs-1] / sfb)) for i = 1..2^sfb."""
    p = f32(f32(IDEAL_POW_FACTOR[rs - 1]) / f32(sfb))
    return np.array([_trunc(np.power(f32(i), p, dtype=np.float32)) for i in range(1, (1 << sfb) + 1)],
                    np.int64)


@functools.cache
def reciprocals(rs: int, sfb: int) -> np.ndarray:
    """int64[2^sfb]: trunc(65536 / sf), float32."""
    return np.array([_trunc(f32(f32(65536.0) / f32(int(s)))) for s in scale_factors(rs, sfb)], np.int64)


def _curve(rs: int) -> list:
    if rs == 1:
        return [f32(2.0)]
    if rs == 2:
        return [f32(1.115), f32(4.0)]
    steps = 1 << (rs - 1)
    end = f32((1 << rs) - 1)
    step = f32(np.floor(f32(f32(end - f32(0.75)) / f32(steps - 1))))
    curve = [f32(f32(0.5) + f32(f32(i) * step)) for i in range(steps)]
    curve[0], curve[-1] = f32(0.75), end
    return curve


@functools.cache
def dqt(rs: int, sfb: int) -> np.ndarray:
    """int64[2^sfb, 2^rs]: code 2k -> +round(sf * curve[k]), 2k+1 -> its negation."""
    out = np.zeros((1 << sfb, 1 << rs), np.int64)
    for s, sf in enumerate(scale_factors(rs, sfb)):
        for k, c in enumerate(_curve(rs)):
            v = _trunc(_round_half_away(f32(f32(int(sf)) * c)))
            out[s, 2 * k], out[s, 2 * k + 1] = v, -v
    return out


@functools.cache
def quant(rs: int) -> np.ndarray:
    """int64[2^(rs+1) + 1]: the code of a clamped scaled residual n, at
    index n + 2^rs (upstream ``qt.rs``: a zig-zag over the dequantised
    values' order, with its special case at rs 2)."""
    items = (1 << (rs + 1)) + 1
    t = [0] * items
    mid = items // 2
    x = items // 2 - 1
    t[0] = x
    for i in range(1, mid, 2):
        t[i] = t[i + 1] = x
        x -= 2
    x = 0
    for i in range(mid, items - 1, 2):
        t[i] = t[i + 1] = x
        x += 2
    t[items - 1] = x - 2
    if rs == 2:
        t[2], t[6] = 1, 0
    return np.array(t, np.int64)


def normalized_vbr_bitrate(residual_bits: float, fpc: int, sfb: int, sff: int) -> np.float32:
    """The VBR target after the container's overhead (``encoder_vbr.rs:40-63``)."""
    d = [f32(x) for x in TARGET_RESIDUAL_DISTRIBUTION]
    v = f32(residual_bits)
    v = f32(v - f32(f32(f32(LMS_LEN) * f32(16.0) * f32(2.0)) / f32(fpc)))
    v = f32(v - f32(f32(sfb) / f32(sff)))
    v = f32(v - f32(f32(2.0) / f32(sff)))
    base = f32(np.floor(f32(residual_bits)))
    mix = f32(f32(f32(d[1] * f32(base - f32(1.0))) + f32(d[2] * base))
              + f32(f32(d[3] * f32(base + f32(1.0))) + f32(d[4] * f32(base + f32(2.0)))))
    return f32(v - f32(mix - base))


def vbr_base(target: np.float32) -> int:
    return int(np.clip(np.trunc(f32(target)), 0, 255))


def vbr_header_size(residual_bits: float, target: np.float32) -> int:
    """The chunk header's residual size: the anchor of the 2-bit size deltas."""
    return min(int(np.floor(residual_bits)), vbr_base(target) + 1)


def interpolate_distribution(items: int, target: np.float32) -> tuple[int, int, int, int]:
    """Counts of sizes base-1, base, base+1, base+2 among ``items``
    (``encoder_vbr.rs:66-96``, float32 with truncating casts)."""
    d = [f32(x) for x in TARGET_RESIDUAL_DISTRIBUTION]
    frac = f32(target - np.trunc(target))
    om = f32(f32(1.0) - frac)
    pct = [f32(f32(d[i] * frac) + f32(d[i + 1] * om)) for i in range(4)]
    res, total = [0, 0, 0, 0], 0
    while total < items:
        remaining = items - total
        for i in range(4):
            v = int(f32(f32(remaining) * pct[i]))
            total += v
            res[i] += v
        if items - total == remaining:
            total += remaining
            res[1] += remaining
    return res[0], res[1], res[2], res[3]


def initial_weights() -> np.ndarray:
    """The encoder's LMS weights at the start of a file (``lms.rs:26-27``)."""
    return np.array([0, 0, -(1 << 13), 1 << 14], np.int64)
