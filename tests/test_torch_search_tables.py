"""What the redesigned search and fused CBR decode kernels add on the host
side, on the CPU: the search's one-lookup table against the port's and the
JAX package's table builds for every (sfb, rs, scale factor, code); the
shared-memory sums of both wrappers at their edges; and the search (plain
version) against the JAX package's search from entry weights on both sides
of the weights penalty's bound, where the kernel's guard switches loops.
Tolerance: exact everywhere, an integer codec."""

from __future__ import annotations

from conftest import pallas_interpret

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_codec_torch.ops import cuda_build, fused_decode, tables
from sea_codec_torch.ops import window_search as ws
from sea_codec_tpu.ops import tables as j_tables
from sea_codec_tpu.ops.pallas_encode import encode_windows_pallas_fn

torch.set_num_threads(1)

PENALTY_BOUND = 0x900 << 18  # sum(w^2) from which the penalty is non-zero


@pytest.mark.parametrize("sfb", range(1, 9))
@pytest.mark.parametrize("rs", range(1, 9))
def test_search_table_equals_the_table_builds(sfb, rs):
    """Row (first + 2^(rs+1) + n2) of the lookup table is (dq << 8 | code)
    for the clamped half-step quotient n2, which stands for the reference's
    quotient n = (n2 + 1) >> 1: the code from the zig-zag table at n and dq
    from ``dqt``, the port's and the JAX package's, for every candidate."""
    first, rows = tables.search_table_rows(rs)
    assert rows == (4 << rs) + 1
    table = tables.search_table(sfb)[first : first + rows]
    assert table.shape == (rows, 1 << sfb) and table.dtype == np.int32
    n = (np.arange(-(2 << rs), (2 << rs) + 1) + 1) >> 1
    assert n.min() == -(1 << rs) and n.max() == 1 << rs
    zero = int(tables.quant_offsets()[rs]) + (1 << rs)
    codes = tables.quant_tab()[zero + n].astype(np.int64)
    np.testing.assert_array_equal(codes, np.asarray(j_tables.quant_tab())[zero + n])
    # every (scale factor, code) of the size appears: the zig-zag table is onto
    assert set(codes.tolist()) == set(range(1 << rs))
    np.testing.assert_array_equal(table & 0xFF, np.broadcast_to(codes[:, None], table.shape))
    for dqt in (tables.dqt(rs, sfb), np.asarray(j_tables.dqt(rs, sfb))):
        np.testing.assert_array_equal(table >> 8, dqt.T[codes])


def test_search_table_covers_all_sizes_once():
    assert tables.search_table_rows(None) == (0, tables.SEARCH_TAB_ROWS)
    ends = [sum(tables.search_table_rows(rs)) for rs in range(1, 9)]
    starts = [tables.search_table_rows(rs)[0] for rs in range(1, 9)]
    assert starts == [0] + ends[:-1] and ends[-1] == tables.SEARCH_TAB_ROWS == 2048
    # the kernel computes a size's first row as 2^(rs+2) + rs - 9
    assert starts == [(4 << rs) + rs - 9 for rs in range(1, 9)]


@pytest.mark.parametrize("rs", range(1, 9))
def test_half_step_quotient_equals_sea_div(rs):
    """The kernel's division: n2 = high word of (8v) * (recip << 14), clamped
    to 1..2c for v > 0, -2c..-2 for v < 0 and 0 for 0, gives the reference's
    sea_div with its sign fix and clamp as (n2 + 1) >> 1, for every
    reciprocal of the size and residuals over the whole range |v| < 2^19."""
    c = 1 << rs
    rng = np.random.default_rng(rs)
    v = np.concatenate([rng.integers(-(1 << 19) + 1, 1 << 19, 50_000), np.arange(-600, 601)]).astype(np.int64)
    recips = {int(r) for sfb in (1, 4, 8) for r in tables.reciprocals(rs, sfb)} | {16, 65535, 65536}
    assert min(recips) > 0 and max(recips) <= 65536
    for r in sorted(recips):
        n = (v * r + (1 << 15)) >> 16
        want = np.clip(n + np.sign(v) - np.sign(n), -c, c)
        v8 = v * 8
        assert np.abs(v8).max() < 2**31 and (r << 14) < 2**31
        n2 = (v8 * (r << 14)) >> 32  # __mulhi
        lo = np.where(v8 > 0, 1, -2 * c)
        hi = np.where(v8 < 0, -2, 2 * c)
        np.testing.assert_array_equal((np.minimum(np.maximum(n2, lo), hi) + 1) >> 1, want)


@pytest.mark.parametrize(
    "sfb,rs,ranks_only",
    [(4, 3, False), (4, None, False), (5, None, True), (6, None, False), (8, 6, False), (8, 7, False), (8, 8, True)],
)
def test_search_shared_memory_edges(sfb, rs, ranks_only):
    """The wrapper's sum follows the kernel's layout: the lookup table where
    it fits, else the arithmetic form's constants; the largest sff that fits
    is taken and the next raises ``ValueError`` on any device."""
    s = 1 << sfb
    rows = tables.search_table_rows(rs)[1]
    common = lambda sff: 4 * (9 * s + 2 * sff) + (0 if ranks_only else sff * s)
    assert ws._smem_bytes(s, 20, ranks_only, rows) == common(20) + 4 * rows * s
    assert ws._smem_bytes(s, 20, ranks_only, 0) == common(20) + 4 * (9 * s + 45) + tables.QUANT_TAB_SIZE
    limit = cuda_build.SMEM_LIMIT - ws._STATIC_SMEM  # the kernel's 256 static bytes count too
    assert ws._STATIC_SMEM == 256
    fits_table = common(20) + 4 * rows * s <= limit
    assert ws._table_rows(s, 20, ranks_only, rs) == (rows if fits_table else 0)
    assert fits_table == ((sfb, rs) not in ((5, None), (6, None), (8, 6), (8, 7), (8, 8)))
    # the largest sff: whichever form is the smaller one still fits
    fits = lambda sff: min(ws._smem_bytes(s, sff, ranks_only, r) for r in (0, rows)) <= limit
    last = max(sff for sff in range(1, 40000) if fits(sff))
    assert fits(last) and not fits(last + 1)
    assert ws._table_rows(s, last, ranks_only, rs) in (0, rows)
    with pytest.raises(ValueError, match="exceeds the kernel's shared memory"):
        ws._table_rows(s, last + 1, ranks_only, rs)
    c = 1
    x = torch.zeros((last + 1, c), dtype=torch.int16)
    st = torch.zeros((c, 4), dtype=torch.int32)
    rs_arg = 3 if rs is None else rs
    with pytest.raises(ValueError, match="exceeds the kernel's shared memory"):
        ws.window_search(x, None, st, st, torch.zeros(c, dtype=torch.int32),
                         sfb=sfb, rs=rs_arg if rs is not None else torch.full((1, c), 3, dtype=torch.uint8),
                         sff=last + 1, wpc=1, ranks_only=ranks_only)


def test_search_takes_the_longest_window_that_fits():
    """At sfb 1 the longest window that fits shared memory runs (plain, on
    the CPU) and one frame more is refused."""
    s, c = 2, 1
    fits = lambda sff: ws._smem_bytes(s, sff, False, 33) <= cuda_build.SMEM_LIMIT - ws._STATIC_SMEM
    last = max(sff for sff in range(1, 40000) if fits(sff))
    assert ws._smem_bytes(s, last, False, 33) < ws._smem_bytes(s, last, False, 0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-3000, 3000, (last, c)).astype(np.int16))
    st = torch.zeros((c, 4), dtype=torch.int32)
    sf, codes, ranks, *_ = ws.window_search(
        x[:400], None, st, st, torch.zeros(c, dtype=torch.int32), sfb=1, rs=3, sff=400, wpc=1)
    assert sf.shape == (1, c) and codes.shape == (400, c)
    assert ws._table_rows(s, last, False, 3) == 33
    with pytest.raises(ValueError, match="exceeds the kernel's shared memory"):
        ws.window_search(torch.zeros((last + 1, c), dtype=torch.int16), None, st, st,
                         torch.zeros(c, dtype=torch.int32), sfb=1, rs=3, sff=last + 1, wpc=1)


@pytest.mark.parametrize("c", [1, 2, 3, 8, 16, 17, 32, 33, 255])
def test_fused_cbr_shared_memory_follows_the_layout(c):
    """Two slots of dq and two of PCM, each a block's chunks x (tile x C + 4)
    int16, and eight barriers; every legal (sfb, C) fits, whatever the row's
    length."""
    group, tile = fused_decode.chunks_per_block(c), fused_decode.tile_frames(c)
    assert group == max(1, 32 // c) and group * c <= max(32, c)
    assert tile % 32 == 0 and 32 <= tile <= 256
    for sfb in (1, 8):
        want = 4 * group * (tile * c + 4) * 2 + 64
        assert fused_decode._smem_bytes(c) == want <= cuda_build.SMEM_LIMIT
        assert fused_decode.fused_cbr_supported(sfb, c)
    assert not fused_decode.fused_cbr_supported(0, c)


# entry weights just below the kernel's f32 guard, between the guard and the
# bound, at the bound (penalty 1), above it, and at the int32 ends
EDGE_WEIGHTS = [
    (0, 0, -8, 24574), (0, 0, 0, 24575), (0, 0, 0, -24576), (12288, 12288, -12288, 12288),
    (12288, 12288, 12288, 12287), (20000, -20000, 3, 1), (2**31 - 1, -(2**31 - 1), 2**31 - 1, -(2**31)),
]


@pytest.mark.parametrize("weights", EDGE_WEIGHTS)
@pytest.mark.parametrize("sfb,rs,sff", [(4, 3, 20), (2, 5, 7)])
def test_search_across_the_penalty_bound_matches_jax(weights, sfb, rs, sff):
    """The search from entry weights around sum(w^2) = 0x900 << 18 equals
    the JAX package's (Pallas kernel in interpret mode): sf, codes, u64
    ranks and the state, with the penalty zero, one, and large."""
    sumsq = sum(w * w for w in weights)
    assert (sumsq >= PENALTY_BOUND) == (weights not in EDGE_WEIGHTS[:2] + EDGE_WEIGHTS[4:5])
    c, nw = 2, 3
    rng = np.random.default_rng(abs(hash(weights)) % 2**31)
    samples = rng.integers(-9000, 9000, (nw * sff, c)).astype(np.int16)
    hist = rng.integers(-32768, 32768, (c, 4)).astype(np.int32)
    wts = np.array([weights, weights[::-1]], dtype=np.int64).astype(np.int32)
    prev = rng.integers(0, 1 << sfb, c).astype(np.int32)
    n_valid = np.full(nw, sff, np.int32)
    got = ws.window_search(
        torch.from_numpy(samples), None, torch.from_numpy(hist), torch.from_numpy(wts),
        torch.from_numpy(prev), sfb=sfb, rs=rs, sff=sff, wpc=nw,
    )
    want = encode_windows_pallas_fn(
        *(jnp.asarray(a) for a in (samples.astype(np.int32), np.full((nw, c), rs, np.int32), n_valid,
                                   hist, wts, prev)),
        scale_factor_frames=sff, scale_factor_bits=sfb, interpret=pallas_interpret(),
    )
    j_sf, j_codes, j_ranks, j_h, j_w, j_p = (np.asarray(x) for x in want)
    sf, codes, ranks, _eh, _ew, h2, w2, p2 = got
    np.testing.assert_array_equal(sf.numpy(), j_sf)
    np.testing.assert_array_equal(codes.numpy(), j_codes)
    np.testing.assert_array_equal(ranks.numpy().view(np.uint64), j_ranks)
    np.testing.assert_array_equal(h2.numpy(), j_h)
    np.testing.assert_array_equal(w2.numpy(), j_w)
    np.testing.assert_array_equal(p2.numpy(), j_p)
    if sumsq >= PENALTY_BOUND + (1 << 18):
        assert int(ranks.numpy().view(np.uint64).min()) > 0  # the penalty shows in every rank
