"""The dequant prologs and the decode router of the PyTorch port (plain
versions on the CPU) against the JAX package: the two Pallas dequant kernels
in interpret mode (their dq rows compared per (chunk, frame, channel) after
undoing each side's layout, and their full two-kernel decodes), and
``decode_chunks_packed`` with the fused kernels on and off. Integer codec:
exact equality."""

from __future__ import annotations

from conftest import pallas_interpret

import numpy as np
import pytest
import torch

from sea_codec_torch import convert
from sea_codec_torch.ops import dequant, fused_decode, fused_decode_vbr, lms_decode
from sea_codec_torch.ops import tables as t_tables
from sea_codec_torch.ops.device_decode import decode_chunks_packed
from sea_codec_tpu.ops import bitpack as j_bitpack
from sea_codec_tpu.ops import tables as j_tables
from sea_codec_tpu.ops.device_decode import _dequant_window_constants as j_window_constants
from sea_codec_tpu.ops.device_decode import decode_chunks_packed as j_decode_packed
from sea_codec_tpu.ops.pallas_dequant import (
    LANES,
    _plan_blocks,
    decode_chunks_packed_fused,
    decode_chunks_packed_fused_vbr,
    unpack_dequant_cbr_lanes,
)

torch.set_num_threads(1)


def _cbr_batch(rng, n, frames, c, sff, sfb, rs):
    w = -(-frames // sff)
    res = rng.integers(0, 256, (n, -(-frames * c * rs // 8)), dtype=np.uint8)
    sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 24), 1 << 24, (n, c, 4)).astype(np.int32)
    return res, sf, hist, wts


def _vbr_batch(rng, n, frames, c, sff, sfb, max_size=8):
    w = -(-frames // sff)
    rs = rng.integers(1, max_size + 1, (n, w, c), dtype=np.uint8)
    fiw = np.clip(frames - np.arange(w) * sff, 0, sff)
    bits = (rs.astype(np.int64) * fiw[None, :, None]).sum(axis=(1, 2))
    res = rng.integers(0, 256, (n, int(-(-bits.max() // 8))), dtype=np.uint8)
    sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 24), 1 << 24, (n, c, 4)).astype(np.int32)
    return res, sf, rs, hist, wts


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CBR_SHAPES = [
    # n, frames, c, sff, sfb, rs
    (3, 40, 2, 20, 4, 3),
    (5, 100, 1, 20, 4, 1),
    (2, 60, 3, 20, 5, 5),  # c=3: the geometry that takes this kernel on the TPU
    (4, 40, 2, 5, 3, 8),
    (4, 40, 8, 5, 4, 4),
]


@pytest.mark.parametrize("n,frames,c,sff,sfb,rs", CBR_SHAPES)
def test_cbr_dq_rows_match_jax_kernel(n, frames, c, sff, sfb, rs):
    """The port's dq stream against the rows of ``unpack_dequant_cbr_lanes``,
    fed as ``decode_chunks_packed_fused`` feeds it (bytes transposed onto
    lanes, scale-factor values per window)."""
    rng = np.random.default_rng(n * 100 + rs)
    res, sf, _hist, _wts = _cbr_batch(rng, n, frames, c, sff, sfb, rs)
    w = frames // sff
    m, wp = _plan_blocks(w, sff, c, rs)
    npad = -(-n // LANES) * LANES
    btot = (wp // m) * ((m * sff * c * rs) // 8)
    resT = np.zeros((btot, npad), np.uint8)
    breal = min(res.shape[1], btot)
    resT[:breal, :n] = res[:, :breal].T
    sfval_win = np.asarray(
        j_window_constants(sf.astype(np.int32), np.full((n, w, c), rs, np.int32), sfb, rs)[0]
    )
    sfvalT = np.zeros((wp, c, npad), np.float32)
    sfvalT[:w, :, :n] = sfval_win.transpose(1, 2, 0)
    rows = unpack_dequant_cbr_lanes(
        resT, sfvalT, rs=rs, sff=sff, c=c, m=m, sfb=sfb, interpret=pallas_interpret()
    )
    want = convert.dq_stream(rows, n, c, frames)
    got = dequant.unpack_dequant_cbr(*_t(res, sf), sfb=sfb, rs=rs, sff=sff, frames=frames)
    assert got.dtype == torch.int16 and got.shape == (frames, n, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,frames,c,sff,sfb,rs", CBR_SHAPES)
def test_cbr_two_kernel_matches_jax_two_kernel(n, frames, c, sff, sfb, rs):
    rng = np.random.default_rng(n * 100 + rs + 1)
    res, sf, hist, wts = _cbr_batch(rng, n, frames, c, sff, sfb, rs)
    want = np.asarray(
        decode_chunks_packed_fused(
            res, sf, hist, wts, scale_factor_frames=sff, frames=frames,
            residual_size=rs, sfb=sfb, interpret=pallas_interpret(),
        )
    )
    got = decode_chunks_packed(
        *_t(res, sf), None, *_t(hist, wts), sfb=sfb, sff=sff, frames=frames,
        residual_size=rs, fused=False,
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "n,frames,c,sff,sfb,mcb",
    [
        (3, 40, 2, 20, 4, 4),
        (5, 100, 1, 20, 4, 8),
        (2, 60, 3, 20, 5, 6),
        (4, 40, 8, 5, 4, 4),
        (1, 25, 2, 5, 3, 8),
        (6, 35, 7, 5, 5, 2),
        (2, 82, 1, 41, 4, 8),
        # a window a frame, and windows longer than the kernel's tiles; 17
        # and 33 channels (one chunk a block, a warp's scan over more than
        # one pass of entries); frames over several of the kernel's tiles
        (2, 600, 2, 1, 4, 8),
        (2, 300, 17, 255, 3, 8),
        (1, 100, 33, 1, 5, 4),
        (2, 150, 33, 20, 4, 8),
        (3, 1100, 1, 255, 8, 8),
        (2, 2100, 2, 20, 4, 4),
    ],
)
def test_vbr_two_kernel_matches_jax_two_kernel(n, frames, c, sff, sfb, mcb):
    """The VBR prolog + recurrence against ``decode_chunks_packed_fused_vbr``
    in interpret mode, set up as the JAX package's own test sets it up."""
    rng = np.random.default_rng(n * 1000 + c * 10 + sfb)
    res, sf, rs, hist, wts = _vbr_batch(rng, n, frames, c, sff, sfb, max_size=mcb)
    want = np.asarray(
        decode_chunks_packed_fused_vbr(
            res, sf, rs, hist, wts, scale_factor_frames=sff, frames=frames, sfb=sfb,
            max_code_bits=mcb, interpret=pallas_interpret(),
        )
    )
    t = _t(res, sf, rs, hist, wts)
    got = decode_chunks_packed(*t, sfb=sfb, sff=sff, frames=frames, residual_size=0, fused=False)
    np.testing.assert_array_equal(got.numpy(), want)
    dq = dequant.unpack_dequant_vbr(*t[:3], sfb=sfb, sff=sff, frames=frames)
    assert dq.dtype == torch.int16 and dq.shape == (frames, n, c)
    assert torch.equal(got, lms_decode.lms_decode(dq, t[3], t[4]))


@pytest.mark.parametrize("fused", [True, False, "env"])
@pytest.mark.parametrize("vbr", [False, True])
def test_router_matches_jax_router(vbr, fused, monkeypatch):
    """Every routing gives the JAX router's PCM, a partial last window
    included (frames % sff != 0)."""
    rng = np.random.default_rng(17 + vbr)
    n, frames, c, sff, sfb = 4, 93, 2, 20, 4
    if vbr:
        res, sf, rs, hist, wts = _vbr_batch(rng, n, frames, c, sff, sfb)
        rsz = 0
    else:
        rsz = 3
        res, sf, hist, wts = _cbr_batch(rng, n, frames, c, sff, sfb, rsz)
        rs = np.full(sf.shape, rsz, np.uint8)
    want = np.asarray(
        j_decode_packed(
            res, sf, rs, hist, wts, np.asarray(j_tables.dqt_stacked(sfb).reshape(-1), np.int32),
            scale_factor_frames=sff, frames=frames, residual_size=rsz,
        )
    )
    kw = dict(sfb=sfb, sff=sff, frames=frames, residual_size=rsz)
    if fused == "env":
        monkeypatch.setenv("SEA_FUSED_PROLOG", "0")
    else:
        kw["fused"] = fused
    calls = []
    for mod, name in ((fused_decode, "decode_cbr_fused"), (fused_decode_vbr, "decode_vbr_fused"),
                      (dequant, "unpack_dequant_cbr"), (dequant, "unpack_dequant_vbr")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _real=real, _name=name, **k: (calls.append(_name), _real(*a, **k))[1]
        )
    got = decode_chunks_packed(*_t(res, sf, rs, hist, wts), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    mode = "vbr" if vbr else "cbr"
    assert calls == [f"decode_{mode}_fused" if fused is True else f"unpack_dequant_{mode}"]


def test_router_reads_env_at_each_call(monkeypatch):
    rng = np.random.default_rng(3)
    res, sf, hist, wts = _cbr_batch(rng, 2, 40, 1, 20, 4, 3)
    args = (*_t(res, sf), None, *_t(hist, wts))
    kw = dict(sfb=4, sff=20, frames=40, residual_size=3)
    seen = []
    real = dequant.unpack_dequant_cbr
    monkeypatch.setattr(dequant, "unpack_dequant_cbr", lambda *a, **k: (seen.append(1), real(*a, **k))[1])
    monkeypatch.delenv("SEA_FUSED_PROLOG", raising=False)
    a = decode_chunks_packed(*args, **kw)
    assert seen == []
    monkeypatch.setenv("SEA_FUSED_PROLOG", "0")
    b = decode_chunks_packed(*args, **kw)
    assert seen == [1] and torch.equal(a, b)


def test_router_sends_long_vbr_rows_to_the_fused_kernel(monkeypatch):
    """VBR rows wider than a block's shared memory (255 channels, 1,000
    frames at sizes 7-8: ~250 KB a row) go to the fused kernel under the
    default routing, which streams them, and to the two-kernel path only
    with the fused kernels off; both give the same PCM."""
    from sea_codec_torch.ops.cuda_build import SMEM_LIMIT

    rng = np.random.default_rng(29)
    n, frames, c, sff, sfb = 2, 1000, 255, 20, 4
    res, sf, rs, hist, wts = _vbr_batch(rng, n, frames, c, sff, sfb)
    rs = np.where(rng.random(rs.shape) < 0.05, 7, 8).astype(np.uint8)
    res = rng.integers(0, 256, (n, frames * c), dtype=np.uint8)
    assert res.shape[1] > SMEM_LIMIT
    calls = []
    for mod, name in ((fused_decode_vbr, "decode_vbr_fused"), (dequant, "unpack_dequant_vbr")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _real=real, _name=name, **k: (calls.append(_name), _real(*a, **k))[1]
        )
    kw = dict(sfb=sfb, sff=sff, frames=frames, residual_size=0)
    monkeypatch.delenv("SEA_FUSED_PROLOG", raising=False)
    fused = decode_chunks_packed(*_t(res, sf, rs, hist, wts), **kw)
    assert calls == ["decode_vbr_fused"]
    calls.clear()
    monkeypatch.setenv("SEA_FUSED_PROLOG", "0")
    two = decode_chunks_packed(*_t(res, sf, rs, hist, wts), **kw)
    assert calls == ["unpack_dequant_vbr"]
    assert torch.equal(fused, two)


@pytest.mark.parametrize("vbr", [False, True])
def test_router_leaves_an_illegal_geometry_to_the_fused_wrapper(vbr, monkeypatch):
    """The router routes on ``fused`` alone: a geometry outside the format
    (256 channels) reaches the fused wrapper, which refuses it, instead of
    slipping down the two-kernel path."""
    rng = np.random.default_rng(31)
    n, frames, c, sff, sfb = 1, 20, 256, 20, 4
    res, sf, rs, hist, wts = _vbr_batch(rng, n, frames, c, sff, sfb)
    if not vbr:
        res = rng.integers(0, 256, (n, frames * c * 3 // 8), dtype=np.uint8)
    monkeypatch.delenv("SEA_FUSED_PROLOG", raising=False)
    with pytest.raises(ValueError, match="c=256|exceeds"):
        decode_chunks_packed(*_t(res, sf, rs, hist, wts), sfb=sfb, sff=sff, frames=frames,
                             residual_size=0 if vbr else 3)


@pytest.mark.parametrize("sfb", [1, 4, 8])
def test_dequant_matches_table_for_every_code(sfb):
    """Frame 0 of streams enumerating every (sf, code): the CBR prolog, and
    the VBR prolog with every size in one window, against ``tables.dqt``."""
    s = 1 << sfb
    for rs in range(1, 9):
        m = 1 << rs
        sf_all = np.repeat(np.arange(s), m).astype(np.uint8)
        code_all = np.tile(np.arange(m), s)
        n = sf_all.size
        res = np.stack([j_bitpack.pack_bits(np.array([q], np.uint32), rs) for q in code_all])
        dq = dequant.unpack_dequant_cbr(
            *_t(res, sf_all.reshape(n, 1, 1)), sfb=sfb, rs=rs, sff=1, frames=1
        )
        want = t_tables.dqt(rs, sfb)[sf_all, code_all]
        np.testing.assert_array_equal(dq.reshape(-1).numpy(), want)
        dq_v = dequant.unpack_dequant_vbr(
            *_t(res, sf_all.reshape(n, 1, 1), np.full((n, 1, 1), rs, np.uint8)),
            sfb=sfb, sff=1, frames=1,
        )
        np.testing.assert_array_equal(dq_v.reshape(-1).numpy(), want)


def test_vbr_malformed_tables_decode_without_raising():
    """Sizes outside 1..8 clamp and scale factors mask to 2^sfb; a row
    shorter than its size table implies reads zeros past its end."""
    rng = np.random.default_rng(9)
    res, sf, rs, _h, _w = _vbr_batch(rng, 2, 30, 2, 10, 3)
    bad_rs = rs.copy()
    bad_rs[0, 0, 0], bad_rs[1, 1, 1] = 0, 200
    bad_sf = sf | 0xF0
    kw = dict(sfb=3, sff=10, frames=30)
    got = dequant.unpack_dequant_vbr(*_t(res[:, :5], bad_sf, bad_rs), **kw)
    want = dequant.unpack_dequant_vbr(*_t(res[:, :5], sf, np.clip(bad_rs, 1, 8)), **kw)
    assert torch.equal(got, want)


def test_wrappers_check_inputs():
    rng = np.random.default_rng(1)
    res, sf, _h, _w = _t(*_cbr_batch(rng, 2, 40, 2, 20, 4, 3))
    kw = dict(sfb=4, rs=3, sff=20, frames=40)
    with pytest.raises(ValueError):
        dequant.unpack_dequant_cbr(res[:, :5], sf, **kw)
    with pytest.raises(ValueError):
        dequant.unpack_dequant_cbr(res, sf, **dict(kw, sff=10))
    with pytest.raises(ValueError):
        dequant.unpack_dequant_cbr(res, sf.int(), **kw)
    with pytest.raises(ValueError):
        dequant.unpack_dequant_cbr(res, sf, **dict(kw, rs=9))
    with pytest.raises(ValueError):
        dequant.unpack_dequant_vbr(res, sf, sf[:1], sfb=4, sff=20, frames=40)
