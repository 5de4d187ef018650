"""Fused CBR decode of the PyTorch port (its plain version on the CPU)
against the JAX package's fused Pallas kernel (interpret mode on the CPU)
and its XLA decode path, on random packed bytes and random LMS entry
states, large weights included. Integer codec: exact equality."""

from __future__ import annotations

from conftest import pallas_interpret

import numpy as np
import pytest
import torch

from sea_codec_torch.ops.device_decode import unpack_const
from sea_codec_torch.ops.fused_decode import decode_cbr_fused, decode_cbr_plain
from sea_codec_tpu.ops import bitpack as j_bitpack
from sea_codec_tpu.ops import tables as j_tables
from sea_codec_tpu.ops.device_decode import decode_chunks_packed_fn as j_decode
from sea_codec_tpu.ops.pallas_fused_decode import decode_chunks_packed_fused_single

torch.set_num_threads(1)

SFB_FOR_RS = {1: 1, 3: 4, 5: 8, 8: 6}


def _random_batch(rng, n, c, rs, sfb, frames, sff):
    w = -(-frames // sff)
    res = rng.integers(0, 256, (n, -(-frames * c * rs // 8)), dtype=np.uint8)
    sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 24), 1 << 24, (n, c, 4)).astype(np.int32)
    return res, sf, hist, wts


@pytest.mark.parametrize("rs", [1, 3, 5, 8])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_fused_decode_matches_jax(c, rs):
    sfb = SFB_FOR_RS[rs]
    frames, sff, n = 200, 20, 3
    rng = np.random.default_rng(100 * c + rs)
    res, sf, hist, wts = _random_batch(rng, n, c, rs, sfb, frames, sff)
    got = decode_cbr_fused(
        torch.from_numpy(res), torch.from_numpy(sf), torch.from_numpy(hist),
        torch.from_numpy(wts), sfb=sfb, rs=rs, sff=sff, frames=frames,
    ).numpy()
    pallas = np.asarray(
        decode_chunks_packed_fused_single(
            res, sf, hist, wts, scale_factor_frames=sff, frames=frames,
            residual_size=rs, sfb=sfb, interpret=pallas_interpret(),
        )
    )
    xla = np.asarray(
        j_decode(
            res, sf, np.full(sf.shape, rs, np.uint8), hist, wts,
            np.asarray(j_tables.dqt_stacked(sfb).reshape(-1), np.int32),
            scale_factor_frames=sff, frames=frames, residual_size=rs,
        )
    )
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("width", [1, 2, 3, 5, 7, 8])
def test_unpack_const_matches_bitpack(width):
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, (4, 61), dtype=np.uint8)
    count = 61 * 8 // width
    got = unpack_const(torch.from_numpy(data), width, count).numpy()
    np.testing.assert_array_equal(got, j_bitpack.unpack_bits_rows(data, width, count))


def test_wrapper_on_cpu_is_plain_and_checks_inputs():
    rng = np.random.default_rng(7)
    res, sf, hist, wts = (torch.from_numpy(a) for a in _random_batch(rng, 2, 2, 4, 5, 40, 8))
    kw = dict(sfb=5, rs=4, sff=8, frames=40)
    assert torch.equal(decode_cbr_fused(res, sf, hist, wts, **kw), decode_cbr_plain(res, sf, hist, wts, **kw))
    with pytest.raises(ValueError):
        decode_cbr_fused(res[:, :5], sf, hist, wts, **kw)
    with pytest.raises(TypeError):
        decode_cbr_fused(res, sf, hist.long(), wts, **kw)
    with pytest.raises(ValueError):
        decode_cbr_fused(res, sf, hist, wts, **dict(kw, sff=10))
