"""The standalone LMS recurrence of the PyTorch port (its plain version on
the CPU) against the JAX package's recurrence kernel in interpret mode, on
random dequantized streams and LMS entry states, extreme weights included.
Integer codec: exact equality."""

from __future__ import annotations

from conftest import pallas_interpret

import numpy as np
import pytest
import torch

from sea_codec_torch import convert
from sea_codec_torch.ops.device_decode import decode_chunks, decode_chunks_fn
from sea_codec_torch.ops.lms_decode import lms_decode, lms_decode_plain
from sea_codec_tpu.ops import tables as j_tables
from sea_codec_tpu.ops.device_decode import decode_chunks as j_decode_chunks
from sea_codec_tpu.ops.pallas_decode import decode_scan_pallas

torch.set_num_threads(1)


def _random_stream(rng, n, f, c, wlim):
    dq = rng.integers(-27090, 27091, (n, f, c)).astype(np.int16)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-wlim, wlim, (n, c, 4)).astype(np.int32)
    return dq, hist, wts


def _numpy_recurrence(dq, hist, wts):
    """Scalar int32 model of the reference decoder loop (decoder.rs:36-45)."""
    n, f, c = dq.shape
    out = np.zeros((n, f, c), np.int16)
    with np.errstate(over="ignore"):
        for i in range(n):
            for ch in range(c):
                h = hist[i, ch].astype(np.int32).copy()
                w = wts[i, ch].astype(np.int32).copy()
                for t in range(f):
                    d = np.int32(dq[i, t, ch])
                    pred = np.int32((w * h).sum(dtype=np.int32)) >> np.int32(13)
                    recon = np.int32(min(max(int(pred) + int(d), -32768), 32767))
                    out[i, t, ch] = recon
                    delta = d >> np.int32(4)
                    w = w + np.where(h < 0, -delta, delta).astype(np.int32)
                    h = np.array([h[1], h[2], h[3], recon], np.int32)
    return out


@pytest.mark.parametrize(
    "n,f,c,wlim",
    [(3, 200, 2, 1 << 14), (1, 37, 1, 1 << 24), (5, 128, 3, 1 << 31), (2, 131, 8, 1 << 20)],
)
def test_recurrence_matches_jax_kernel(n, f, c, wlim):
    rng = np.random.default_rng(n * 1000 + f + c)
    dq, hist, wts = _random_stream(rng, n, f, c, wlim)
    want = np.asarray(decode_scan_pallas(dq, hist, wts, interpret=pallas_interpret()))
    dq_t = torch.from_numpy(np.ascontiguousarray(dq.transpose(1, 0, 2)))
    h_t, w_t = convert.lms_entry_state(hist, wts)
    got = lms_decode(dq_t, h_t, w_t)
    assert got.dtype == torch.int16 and got.shape == (n, f, c)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, lms_decode_plain(dq_t, h_t, w_t))


@pytest.mark.parametrize("mag", [1 << 15, (1 << 31) - 1])
def test_int32_wrap_at_extreme_state(mag):
    """Weights and history at +-mag: the four products overflow int32 many
    times over; the sum must wrap as int32 arithmetic does (the plain
    version computes in int64 and folds back)."""
    rng = np.random.default_rng(mag % 97)
    n, f, c = 2, 60, 2
    dq = rng.integers(-27090, 27091, (n, f, c)).astype(np.int16)
    sign = lambda: rng.choice(np.array([-1, 1]), (n, c, 4))
    hist = (sign() * min(mag, 32767)).astype(np.int32)
    wts = (sign() * mag).astype(np.int32)
    want = _numpy_recurrence(dq, hist, wts)
    got = lms_decode(torch.from_numpy(np.ascontiguousarray(dq.transpose(1, 0, 2))),
                     torch.from_numpy(hist), torch.from_numpy(wts)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(decode_scan_pallas(dq, hist, wts, interpret=pallas_interpret()))
    )


def test_negative_dq_shift_is_arithmetic():
    """dq >> 4 of a negative value rounds toward minus infinity: -1 >> 4 is
    -1, so a weight with non-negative history moves by -1, not 0."""
    dq = torch.tensor([[[-1]], [[0]]], dtype=torch.int16)  # [F=2, N=1, C=1]
    hist = torch.zeros((1, 1, 4), dtype=torch.int32)
    wts = torch.zeros((1, 1, 4), dtype=torch.int32)
    wts[0, 0, 3] = 1 << 13
    out = lms_decode(dq, hist, wts)
    # frame 0: pred 0, recon -1, weights -= 1 (all history >= 0);
    # frame 1: pred = ((2^13 - 1) * -1) >> 13 = -1
    assert out.reshape(-1).tolist() == [-1, -1]


@pytest.mark.parametrize("static_rs", [0, 3])
def test_decode_chunks_matches_jax(static_rs):
    """``decode_chunks`` on unpacked codes against the JAX entry with its
    recurrence kernel in interpret mode (``use_pallas=True``)."""
    rng = np.random.default_rng(11 + static_rs)
    n, f, c, sff, sfb = 3, 100, 2, 20, 4
    w = f // sff
    rs = np.full((n, w, c), static_rs, np.uint8) if static_rs else rng.integers(1, 9, (n, w, c), dtype=np.uint8)
    per_frame = np.repeat(rs, sff, axis=1)
    codes = (rng.integers(0, 256, (n, f, c)) & ((1 << per_frame.astype(np.int64)) - 1)).astype(np.uint8)
    sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 24), 1 << 24, (n, c, 4)).astype(np.int32)
    want = np.asarray(
        j_decode_chunks(
            codes, sf, rs, hist, wts,
            np.asarray(j_tables.dqt_stacked(sfb).reshape(-1), np.int32),
            scale_factor_frames=sff, use_pallas=True,
            pallas_interpret=pallas_interpret(), static_rs=static_rs,
        )
    )
    t = [torch.from_numpy(a) for a in (codes, sf, rs, hist, wts)]
    got = decode_chunks(*t, sfb=sfb, sff=sff, static_rs=static_rs)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = decode_chunks_fn(t[0], t[1], t[3], t[4], sfb, sff, static_rs if static_rs else t[2])
    assert torch.equal(got, plain)


def test_lane_state_conversion_round_trips():
    """The JAX kernel's lane-major state [8, lanes] -> the port's [N, C, 4]."""
    rng = np.random.default_rng(5)
    n, c = 3, 2
    hist = rng.integers(-9, 9, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-9, 9, (n, c, 4)).astype(np.int32)
    lanes = np.zeros((8, 1024), np.int32)
    lanes[:, : n * c] = np.concatenate([hist, wts], axis=-1).reshape(n * c, 8).T
    h, w = convert.lms_lane_state(lanes.reshape(8, 8, 128), n, c)
    np.testing.assert_array_equal(h.numpy(), hist)
    np.testing.assert_array_equal(w.numpy(), wts)


def test_wrapper_checks_inputs():
    dq = torch.zeros((4, 2, 1), dtype=torch.int16)
    st = torch.zeros((2, 1, 4), dtype=torch.int32)
    assert lms_decode(dq, st, st).shape == (2, 4, 1)
    assert lms_decode(dq[:, :0], st[:0], st[:0]).shape == (0, 4, 1)
    with pytest.raises(TypeError):
        lms_decode(dq.int(), st, st)
    with pytest.raises(ValueError):
        lms_decode(dq, st[:1], st)
    with pytest.raises(ValueError):
        lms_decode(dq, st.long(), st)
    with pytest.raises(ValueError):
        lms_decode(dq[:0], st, st)


def test_wrapper_takes_channels_up_to_one_block():
    """A block holds every channel of a chunk, one recurrence thread each,
    with a producer warp left over: 480 channels, past the format's 255;
    more are refused on every device, so the CPU and the card agree."""
    from sea_codec_torch.ops import decode_ring
    from sea_codec_torch.ops.lms_decode import MAX_CHANNELS

    assert MAX_CHANNELS == 480 and -(-MAX_CHANNELS // 32) == decode_ring.MAX_WARPS - 1
    dq = torch.ones((2, 1, MAX_CHANNELS + 1), dtype=torch.int16)
    st = torch.zeros((1, MAX_CHANNELS + 1, 4), dtype=torch.int32)
    out = lms_decode(dq[:, :, :MAX_CHANNELS], st[:, :MAX_CHANNELS], st[:, :MAX_CHANNELS])
    assert out.shape == (1, 2, MAX_CHANNELS) and bool((out == 1).all())
    with pytest.raises(ValueError, match="channels"):
        lms_decode(dq, st, st)
