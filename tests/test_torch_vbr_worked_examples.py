"""The hand-derived VBR vectors, held against the PyTorch port.

The expected values were derived by hand from the reference source
(``src/codec/encoder_vbr.rs:40-137``, ``src/codec/chunk.rs:245-278``,
``src/codec/bits.rs:104-134``), not by running any implementation; the
derivations are written out in ``tests/test_vbr_worked_examples.py``, which
pins the JAX package to the same values. Here the port's rate helpers, its
size chooser (``ops.encode_file.vbr_sizes``, which ranks on the device) and
its chunk serializer are pinned to them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sea_codec_torch.container import CHUNK_TYPE_VBR, SeaChunk
from sea_codec_torch.models.vbr import (
    chunk_residual_size,
    interpolate_distribution,
    normalized_vbr_bitrate,
    vbr_base,
)
from sea_codec_torch.ops.encode_file import vbr_sizes

torch.set_num_threads(1)


def _choose(errors, c, rb, fpc, sfb, sff, input_len):
    """The tail-chunk model's chooser (``models.vbr.VbrEncoderModel.encode``)
    on given error ranks: sizes uint8[W*C]."""
    target = normalized_vbr_bitrate(rb, fpc, sfb, sff)
    sortable = input_len // sff
    m1, _t, p1, p2 = interpolate_distribution(sortable, target)
    ranks = torch.tensor(np.asarray(errors, np.int64)).reshape(-1, c)
    return vbr_sizes(ranks, vbr_base(target), (m1, p1, p2), sortable).reshape(-1).numpy()


@pytest.mark.parametrize(
    "args,want",
    [((3.0, 640, 4, 20), 2.45), ((2.9, 512, 4, 5), 1.40), ((3.0, 2560, 3, 25), 2.70)],
)
def test_normalized_bitrate_hand_values(args, want):
    assert float(normalized_vbr_bitrate(*args)) == pytest.approx(want, abs=2e-6)


@pytest.mark.parametrize(
    "items,target,want",
    [(32, 2.45, (0, 18, 14, 0)), (9, 1.40, (0, 6, 3, 0)), (40, 2.70, (0, 12, 27, 1))],
)
def test_interpolate_distribution_hand_values(items, target, want):
    assert interpolate_distribution(items, np.float32(target)) == want


def test_chooser_example_a_scrambled_ranks():
    errors = [((7 * i) % 32) * 100 for i in range(32)]
    want = np.full(32, 2)
    want[[3, 4, 8, 9, 12, 13, 17, 18, 21, 22, 26, 27, 30, 31]] = 3
    np.testing.assert_array_equal(_choose(errors, 1, 3.0, 640, 4, 20, 640), want)


def test_chooser_example_b_partial_window_quirk():
    """sortable = 46 samples // 5 = 9: slot 8 (partial window, channel 0) is
    promoted, slot 9 keeps the base despite the largest error."""
    errors = [10, 20, 30, 40, 50, 60, 70, 80, 1000, 999999]
    np.testing.assert_array_equal(
        _choose(errors, 2, 2.9, 512, 4, 5, 46), [1, 1, 1, 1, 1, 1, 2, 2, 2, 1]
    )


def test_chooser_example_c_plus_two_anchor_extreme():
    errors = np.arange(40) ** 2
    want = np.full(40, 2)
    want[12:39] = 3
    want[39] = 4
    np.testing.assert_array_equal(_choose(errors, 1, 3.0, 2560, 3, 25, 1000), want)
    # base + 1 = 3 = floor(3.0): the anchor is the reference's (chunk.rs:60)
    assert chunk_residual_size(3.0, normalized_vbr_bitrate(3.0, 2560, 3, 25)) == 3


def test_chooser_example_e_tied_ranks():
    """Stable order on ties: of the fifteen 200s the lowest-indexed stays."""
    i200 = np.array([1, 4, 5, 9, 10, 11, 14, 17, 20, 22, 25, 27, 28, 30, 31])
    errors = np.full(32, 100)
    errors[i200] = 200
    sizes = _choose(errors, 1, 3.0, 640, 4, 20, 640)
    assert int((sizes == 3).sum()) == 14
    want = np.full(32, 2)
    want[i200] = 3
    want[i200.min()] = 2
    np.testing.assert_array_equal(sizes, want)


def test_chooser_orders_ranks_as_unsigned():
    """Ranks are u64 bits held in int64: a rank with the top bit set is the
    largest, not negative."""
    errors = np.array([5, -1, 7, 6] + [1] * 28, np.int64)  # -1 is 2^64 - 1
    sizes = _choose(errors, 1, 3.0, 640, 4, 20, 640)
    assert sizes[1] == 3 and sizes[2] == 3 and sizes[3] == 3 and sizes[0] == 3
    assert int((sizes == 3).sum()) == 14


def _chunk(channels, frames, sff, sf, sizes, residuals):
    return SeaChunk(
        channels=channels, frames_in_chunk=frames, chunk_type=CHUNK_TYPE_VBR,
        scale_factor_bits=4, scale_factor_frames=sff, residual_size=2,
        lms_history=np.zeros((channels, 4), np.int32),
        lms_weights=np.zeros((channels, 4), np.int32),
        scale_factors=np.array(sf, np.uint8),
        vbr_residual_sizes=np.array(sizes, np.uint8),
        residuals=np.array(residuals, np.uint8),
    )


def test_vbr_section_bytes_mono():
    got = _chunk(1, 10, 5, [9, 4], [2, 3], [1, 2, 3, 0, 1, 5, 7, 0, 3, 6]).serialize()
    assert got[:4] == bytes([CHUNK_TYPE_VBR, 0x42, 5, 0x5A])
    assert got[4:20] == bytes(16)
    assert got[20:] == bytes([0x94, 0x60, 0x6C, 0x6F, 0x0F, 0x00])


def test_vbr_section_bytes_stereo_interleave():
    got = _chunk(2, 4, 2, [1, 2, 3, 4], [1, 2, 3, 1], [1, 3, 0, 2, 5, 1, 7, 0]).serialize()
    assert got[:4] == bytes([CHUNK_TYPE_VBR, 0x42, 2, 0x5A])
    assert got[36:] == bytes([0x12, 0x34, 0x18, 0xEA, 0xF8])


@pytest.mark.parametrize("fused", [True, False])
def test_hand_packed_section_decodes_to_its_codes(fused):
    """The stereo example's residual bytes 0xEA 0xF8 through both decode
    routes: with zero LMS state, frame 0 of each channel is the dequantized
    first code (channel 0: code 1 at 1 bit, channel 1: code 3 at 2 bits)."""
    from sea_codec_torch.ops import tables
    from sea_codec_torch.ops.device_decode import decode_chunks_packed

    res = torch.tensor([[0xEA, 0xF8]], dtype=torch.uint8)
    sf = torch.tensor([[[1, 2], [3, 4]]], dtype=torch.uint8)
    rs = torch.tensor([[[1, 2], [3, 1]]], dtype=torch.uint8)
    zero = torch.zeros((1, 2, 4), dtype=torch.int32)
    pcm = decode_chunks_packed(res, sf, rs, zero, zero, sfb=4, sff=2, frames=4,
                               residual_size=0, fused=fused)
    assert pcm[0, 0].tolist() == [int(tables.dqt(1, 4)[1, 1]), int(tables.dqt(2, 4)[2, 3])]
