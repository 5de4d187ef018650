"""Quantization / dequantization tables and scale factors for the SEA codec.

These tables define the codec's rate-distortion behavior and must be
reproduced *bit-exactly*. Semantics derived from the reference:

- quantization table (zig-zag):   reference ``src/codec/qt.rs:8-52``
- scale factors / reciprocals:    reference ``src/codec/dqt.rs:44-69``
- dequantization curves + table:  reference ``src/codec/dqt.rs:75-126``

All floating-point steps in the reference are ``f32`` with truncation
(`as i32`) or round-half-away-from-zero (``f32::round``). We reproduce them
with numpy float32 scalar arithmetic (the platform ``powf`` via numpy) and
explicit truncation/rounding helpers. The generated tables are tiny (the
largest is 2^5 x 2^8 int32) and are cached per configuration.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# 4-tap sign-sign LMS predictor parameters (reference src/codec/lms.rs:1,9).
LMS_LEN = 4
FLOATING_BITS = 3

# Experimentally-tuned exponents for the scale-factor curve
# (reference src/codec/dqt.rs:14). Index = residual_bits - 1.
IDEAL_POW_FACTOR = (12.0, 11.65, 11.20, 10.58, 9.64, 8.75, 7.66, 6.63)

# Sizes of the per-residual-size zig-zag quant tables: (1 << (rs+1)) + 1
# entries for rs in 1..=8 (reference src/codec/qt.rs:4,40).
QUANT_TAB_SIZE = 5 + 9 + 17 + 33 + 65 + 129 + 257 + 513  # = 1028


def _f32(x) -> np.float32:
    return np.float32(x)


def _trunc_f32_to_i32(x: np.float32) -> int:
    """Rust `f32 as i32`: truncate toward zero, saturating at i32 bounds."""
    xf = float(x)
    if np.isnan(xf):
        return 0
    if xf <= -2147483648.0:
        return -2147483648
    if xf >= 2147483647.0:
        return 2147483647
    return int(xf)  # Python int() truncates toward zero


def _round_half_away_f32(x: np.float32) -> np.float32:
    """Rust `f32::round` / C `roundf`: round half away from zero.

    Implemented as floor(x+0.5) / ceil(x-0.5) in f32; exact for |x| < 2^22
    (the +-0.5 addition is representable there), far above any table value.
    """
    half = _f32(0.5)
    if x >= 0:
        return np.float32(np.floor(np.float32(x + half)))
    return np.float32(np.ceil(np.float32(x - half)))


# ---------------------------------------------------------------------------
# Quantization table (residual -> code), zig-zag pattern.
# ---------------------------------------------------------------------------


def _fill_zigzag(items: int) -> list[int]:
    """One per-residual-size table (reference src/codec/qt.rs:8-31)."""
    table = [0] * items
    midpoint = items // 2
    x = items // 2 - 1
    table[0] = x & 0xFF
    for i in range(1, midpoint, 2):
        table[i] = x & 0xFF
        if i + 1 < items:
            table[i + 1] = x & 0xFF
        x -= 2
    x = 0
    for i in range(midpoint, items - 1, 2):
        table[i] = x & 0xFF
        if i + 1 < items:
            table[i + 1] = x & 0xFF
        x += 2
    table[items - 1] = (x - 2) & 0xFF

    # special case when residual_size = 2 (reference src/codec/qt.rs:27-30)
    if items == 9:
        table[2] = 1
        table[6] = 0
    return table


@lru_cache(maxsize=None)
def quant_tab() -> np.ndarray:
    """Flat uint8[1028] quant table (reference src/codec/qt.rs:33-52)."""
    flat: list[int] = []
    for shift in range(2, 10):
        flat.extend(_fill_zigzag((1 << shift) + 1))
    assert len(flat) == QUANT_TAB_SIZE
    out = np.asarray(flat, dtype=np.uint8)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def quant_offsets() -> np.ndarray:
    """offsets[rs] = start of the table for residual size ``rs`` (1..=8).

    The reference stores offsets[shift-1] for shift in 2..=9
    (src/codec/qt.rs:37-48); residual size rs uses offsets[rs].
    """
    offsets = np.zeros(9, dtype=np.int32)
    current = 0
    for shift in range(2, 10):
        offsets[shift - 1] = current
        current += (1 << shift) + 1
    offsets.setflags(write=False)
    return offsets


# ---------------------------------------------------------------------------
# Scale factors, reciprocals, dequantization table.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def scale_factors(residual_bits: int, scale_factor_bits: int) -> np.ndarray:
    """int32[2^sfb]: index^(IDEAL_POW_FACTOR[rb-1]/sfb), f32, truncated.

    Reference src/codec/dqt.rs:40-55.
    """
    assert 1 <= residual_bits <= 8
    power_factor = _f32(_f32(IDEAL_POW_FACTOR[residual_bits - 1]) / _f32(scale_factor_bits))
    n = 1 << scale_factor_bits
    out = np.empty(n, dtype=np.int32)
    for index in range(1, n + 1):
        value = np.float32(np.power(_f32(index), power_factor, dtype=np.float32))
        out[index - 1] = _trunc_f32_to_i32(value)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def reciprocals(residual_bits: int, scale_factor_bits: int) -> np.ndarray:
    """int32[2^sfb]: (65536f32 / sf) truncated (reference src/codec/dqt.rs:57-69)."""
    sf = scale_factors(residual_bits, scale_factor_bits)
    out = np.empty_like(sf)
    for i, s in enumerate(sf):
        out[i] = _trunc_f32_to_i32(np.float32(_f32(1 << 16) / _f32(int(s))))
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def _dqt_curve(residual_bits: int) -> tuple:
    """f32 dequant curve per residual size (reference src/codec/dqt.rs:75-97)."""
    if residual_bits == 1:
        return (_f32(2.0),)
    if residual_bits == 2:
        return (_f32(1.115), _f32(4.0))

    start = _f32(0.75)
    steps = 1 << (residual_bits - 1)
    end = _f32((1 << residual_bits) - 1)
    step = np.float32(np.float32(end - start) / _f32(steps - 1))
    step_floor = np.float32(np.floor(step))

    curve = [_f32(0.0)] * steps
    for i in range(1, steps):
        curve[i] = np.float32(_f32(0.5) + np.float32(_f32(i) * step_floor))
    curve[0] = start
    curve[steps - 1] = end
    return tuple(curve)


def rs_curve_constants(residual_bits: int) -> tuple[float, float, float, int]:
    """(c0, stepfloor, endval, kmax) of the f32-exact dequant curve for one
    residual size -- the closed form the decode kernels evaluate per sample
    (``curve = 0.5 + k*stepfloor``, endpoints overridden). Single source:
    the CUDA kernels and their plain versions all take the constants from
    here, so a rounding fix cannot diverge them."""
    curve = _dqt_curve(residual_bits)
    c0 = float(curve[0])
    endval = float(curve[-1])
    if residual_bits >= 3:
        start = _f32(0.75)
        end = _f32((1 << residual_bits) - 1)
        steps = 1 << (residual_bits - 1)
        stepfloor = float(np.floor(np.float32(np.float32(end - start) / _f32(steps - 1))))
    else:
        stepfloor = 0.0
    kmax = (1 << (residual_bits - 1)) - 1
    return c0, stepfloor, endval, kmax


@lru_cache(maxsize=None)
def rs_tables(scale_factor_bits: int):
    """Per-residual-size constants of the decode and search kernels and
    their plain versions, f32-exact, each indexed by rs (row 0 unused):
    (sfval f32[9, S], recip i32[9, S], c0, stepfloor, endval f32[9],
    kmax i32[9], climit i32[9])."""
    s = 1 << scale_factor_bits
    sfval = np.zeros((9, s), dtype=np.float32)
    recip = np.zeros((9, s), dtype=np.int32)
    c0 = np.zeros(9, dtype=np.float32)
    stepfloor = np.zeros(9, dtype=np.float32)
    endval = np.zeros(9, dtype=np.float32)
    kmax = np.zeros(9, dtype=np.int32)
    climit = np.zeros(9, dtype=np.int32)
    for rb in range(1, 9):
        sfval[rb] = scale_factors(rb, scale_factor_bits).astype(np.float32)
        recip[rb] = reciprocals(rb, scale_factor_bits)
        c0[rb], stepfloor[rb], endval[rb], kmax[rb] = rs_curve_constants(rb)
        climit[rb] = 1 << rb
    return sfval, recip, c0, stepfloor, endval, kmax, climit


@lru_cache(maxsize=None)
def kernel_tables(scale_factor_bits: int, device) -> tuple:
    """``rs_tables`` as the CUDA kernels take them, on ``device`` and made
    once per (sfb, device), so that a launch copies nothing from the host
    (a pageable host-to-device copy waits for the stream):
    (sfval f32[9, S], recip i32[9, S], curve f32[3, 9] rows c0, stepfloor,
    endval, ints i32[2, 9] rows kmax and ``quant_offsets``, quant table
    u8[1028])."""
    import torch

    sfval, recip, c0, stepf, endv, kmax, _cl = rs_tables(scale_factor_bits)
    host = (
        sfval, recip, np.stack([c0, stepf, endv]), np.stack([kmax, quant_offsets()]),
        quant_tab().copy(),
    )
    return tuple(torch.as_tensor(a, device=device) for a in host)


@lru_cache(maxsize=None)
def dqt(residual_bits: int, scale_factor_bits: int) -> np.ndarray:
    """int32[2^sfb, 2^rb] dequant table (reference src/codec/dqt.rs:99-126).

    Row s, code 2k   = +round(scale_factors[s] * curve[k])
    Row s, code 2k+1 = -round(scale_factors[s] * curve[k])
    """
    curve = _dqt_curve(residual_bits)
    sf = scale_factors(residual_bits, scale_factor_bits)
    n_sf = 1 << scale_factor_bits
    dqt_items = 1 << (residual_bits - 1)
    out = np.zeros((n_sf, 2 * dqt_items), dtype=np.int32)
    for s in range(n_sf):
        sf_f = _f32(int(sf[s]))
        for k in range(dqt_items):
            val = _trunc_f32_to_i32(_round_half_away_f32(np.float32(sf_f * curve[k])))
            out[s, 2 * k] = val
            out[s, 2 * k + 1] = -val
    out.setflags(write=False)
    return out


def dq_table_offset(residual_bits: int, scale_factor_bits: int) -> int:
    """Where ``dqt(residual_bits, sfb)`` starts in ``dq_table(sfb, ...)``:
    after the tables of the smaller sizes, 2^sfb * (2 + 4 + ... + 2^(rs-1))
    entries."""
    return (1 << scale_factor_bits) * ((1 << residual_bits) - 2)


@lru_cache(maxsize=None)
def dq_table(scale_factor_bits: int, device):
    """``dqt`` of every residual size 1..8 as the dequant prologs' kernels
    read it: int16 (|dq| <= 27090), the [2^sfb, 2^rs] table of size rs from
    ``dq_table_offset(rs, sfb)`` on; on ``device``, made once per (sfb,
    device) so that a launch copies nothing from the host."""
    import torch

    flat = np.concatenate([dqt(rs, scale_factor_bits).reshape(-1) for rs in range(1, 9)])
    return torch.as_tensor(flat.astype(np.int16), device=device)


# Rows of ``search_table``: 2^(rs+2) + 1 half-step quotients for rs in 1..=8.
SEARCH_TAB_ROWS = 4 * 510 + 8  # = 2048


def search_table_rows(residual_size) -> tuple[int, int]:
    """(first row, rows) of ``search_table`` that a launch stages: one
    residual size's rows (an int), the rows of the sizes ``lo..hi`` (a pair:
    per-window sizes known to lie in that range), or every row (None). A
    size's rows follow the last size's: size ``rs`` starts at row
    ``2^(rs+2) + rs - 9`` and has ``2^(rs+2) + 1``."""
    if residual_size is None:
        return 0, SEARCH_TAB_ROWS
    lo, hi = (residual_size, residual_size) if isinstance(residual_size, int) else residual_size
    first = (4 << lo) + lo - 9
    return first, (8 << hi) + hi - 8 - first


@lru_cache(maxsize=None)
def search_table(scale_factor_bits: int) -> np.ndarray:
    """int32[SEARCH_TAB_ROWS, 2^sfb]: the search kernel's one-lookup
    quantizer and dequantizer. The kernel divides in half steps: its clamped
    quotient ``n2`` in ``-2^(rs+1)..2^(rs+1)`` stands for the reference's
    clamped quotient ``n = (n2 + 1) >> 1`` in ``-2^rs..2^rs``. Row
    ``search_table_rows(rs)[0] + 2^(rs+1) + n2`` holds, for each candidate
    scale factor ``s``, ``dqt(rs, sfb)[s, code] << 8 | code`` with ``code =
    quant_tab()[quant_offsets()[rs] + 2^rs + n]``: the code is the low byte
    and the dequantized value (|dq| <= 27090) the arithmetic shift by 8.
    Candidates are the minor axis, so the 32 lanes of a warp, each with its
    own row, read 32 different banks."""
    codes = quant_tab().astype(np.int64)
    offsets = quant_offsets()
    out = np.empty((SEARCH_TAB_ROWS, 1 << scale_factor_bits), dtype=np.int32)
    for rb in range(1, 9):
        first, rows = search_table_rows(rb)
        n = (np.arange(-(2 << rb), (2 << rb) + 1) + 1) >> 1
        q = codes[int(offsets[rb]) + (1 << rb) + n]
        out[first : first + rows] = (dqt(rb, scale_factor_bits).astype(np.int64).T[q] << 8) | q[:, None]
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def search_kernel_table(scale_factor_bits: int, device):
    """``search_table`` on ``device``, made once per (sfb, device) like
    ``kernel_tables``."""
    import torch

    return torch.as_tensor(search_table(scale_factor_bits).copy(), device=device)
