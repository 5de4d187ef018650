"""VBR round trip of the PyTorch port (``device="cpu"``: the plain versions
of the kernels) against the JAX package: the host rate helpers, the
scale-factor search with per-(window, channel) sizes and in its ranks-only
form, the whole-file two-pass encode, the VBR decode (against the JAX fused
Pallas kernel in interpret mode and its XLA path at 255 channels), seeded
``sea_encode``/``sea_decode`` round trips, and streams written with the
reference's delta anchor. Integer codec: every comparison is exact."""

from __future__ import annotations

from conftest import pallas_interpret

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fixtures import ANCHOR_MATRIX, anchored_matrix_stream

from sea_codec_torch import EncoderSettings, convert, sea_decode, sea_encode
from sea_codec_torch.batch import decode_sea, parse_full_chunks, split_chunks
from sea_codec_torch.models import vbr as t_vbr
from sea_codec_torch.ops import bitpack as t_bitpack
from sea_codec_torch.ops.encode_file import encode_file_vbr as t_encode_file_vbr
from sea_codec_torch.ops.fused_decode_vbr import decode_vbr_fused
from sea_codec_torch.ops.window_search import window_search
from sea_codec_tpu import EncoderSettings as JaxSettings
from sea_codec_tpu.batch import decode_sea as jax_decode
from sea_codec_tpu.batch import encode_sea as jax_encode
from sea_codec_tpu.models import vbr as j_vbr
from sea_codec_tpu.ops import bitpack as j_bitpack
from sea_codec_tpu.ops import tables as j_tables
from sea_codec_tpu.ops.device_decode import decode_chunks_packed_fn as j_decode
from sea_codec_tpu.ops.device_encode import encode_windows_fn
from sea_codec_tpu.ops.encode_file import encode_file_vbr as j_encode_file_vbr
from sea_codec_tpu.ops.pallas_encode import encode_windows_pallas_fn
from sea_codec_tpu.ops.pallas_fused_decode import decode_chunks_packed_fused_vbr_single
from sea_codec_tpu.utils.signal import varied_signal

torch.set_num_threads(1)


def test_rate_helpers_equal_jax():
    for rb in np.arange(1.0, 8.01, 0.25):
        for fpc, sfb, sff in [(5120, 4, 20), (200, 4, 20), (100, 5, 10), (16, 4, 2), (64, 8, 4)]:
            t = t_vbr.normalized_vbr_bitrate(rb, fpc, sfb, sff)
            j = j_vbr.normalized_vbr_bitrate(rb, fpc, sfb, sff)
            assert t == j and t.dtype == np.float32
            assert t_vbr.vbr_base(t) == j_vbr.vbr_base(j)
            for items in (0, 1, 7, 40, 512, 3000):
                assert t_vbr.interpolate_distribution(items, t) == j_vbr.interpolate_distribution(items, j)
    # the main-path configuration (stereo, rb 2.5, defaults)
    target = t_vbr.normalized_vbr_bitrate(2.5, 5120, 4, 20)
    assert t_vbr.vbr_base(target) == 2
    assert t_vbr.interpolate_distribution(512, target) == (0, 426, 83, 3)


@pytest.mark.parametrize("width", [1, 3, 8, "var"])
def test_pack_bits_rows_equals_jax(width):
    rng = np.random.default_rng(11)
    if width == "var":
        w = rng.integers(1, 9, (1, 90))
        widths = np.concatenate([w, rng.permutation(w[0])[None], w[:, ::-1]])  # equal row totals
    else:
        widths = width
    vals = (rng.integers(0, 256, (3, 90)) & ((1 << np.asarray(widths)) - 1)).astype(np.uint8)
    np.testing.assert_array_equal(
        t_bitpack.pack_bits_rows(vals, widths), j_bitpack.pack_bits_rows(vals, widths)
    )


def _jax_search(samples, rs, n_valid, hist, wts, prev, sff, sfb, ranks_only=False):
    args = [jnp.asarray(a) for a in (samples, rs, n_valid, hist, wts, prev)]
    if sfb <= 7:
        return encode_windows_pallas_fn(
            *args, scale_factor_frames=sff, scale_factor_bits=sfb,
            interpret=pallas_interpret(), ranks_only=ranks_only,
        )
    return encode_windows_fn(
        *args,
        jnp.asarray(j_tables.dqt_stacked(sfb).reshape(-1), jnp.int32),
        jnp.asarray(j_tables.reciprocals_stacked(sfb), jnp.int32),
        jnp.asarray(j_tables.quant_tab(), jnp.int32),
        jnp.asarray(j_tables.quant_offsets(), jnp.int32),
        scale_factor_frames=sff, n_candidates=1 << sfb,
    )


def _search_case(c, sff, sfb, nw, seed):
    rng = np.random.default_rng(seed)
    samples = rng.integers(-32768, 32768, (nw * sff, c)).astype(np.int16)
    rs = rng.integers(1, 9, (nw, c)).astype(np.uint8)
    n_valid = np.full(nw, sff, np.int32)
    n_valid[-1] = max(1, sff - 3)  # ragged last window
    hist = rng.integers(-32768, 32768, (c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 22), 1 << 22, (c, 4)).astype(np.int32)
    prev = rng.integers(0, 1 << sfb, c).astype(np.int32)
    return samples, rs, n_valid, hist, wts, prev


@pytest.mark.parametrize(
    "c,sff,sfb,nw",
    [(1, 10, 1, 3), (2, 10, 4, 4), (3, 5, 7, 3), (2, 4, 8, 3)],
)
def test_window_search_per_window_sizes_match_jax(c, sff, sfb, nw):
    """Mixed [W, C] sizes from a mid-stream state, ragged last window; then
    the ranks-only form, whose sf, ranks and state equal the full form's."""
    samples, rs, n_valid, hist, wts, prev = _search_case(c, sff, sfb, nw, seed=c * 100 + sfb)
    st = convert.encoder_state(hist, wts, prev)
    kw = dict(sfb=sfb, sff=sff, wpc=nw)
    args = (torch.from_numpy(samples), torch.from_numpy(n_valid), st.hist, st.wts, st.prev_sf)
    full = window_search(*args, rs=torch.from_numpy(rs), **kw)
    want = _jax_search(samples.astype(np.int32), rs.astype(np.int32), n_valid, hist, wts, prev, sff, sfb)
    sf, codes, ranks, ehist, ewts, h2, w2, p2 = full
    j_sf, j_codes, j_ranks, j_h, j_w, j_p = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(sf.numpy(), j_sf)
    np.testing.assert_array_equal(codes.numpy(), j_codes)
    np.testing.assert_array_equal(ranks.numpy().view(np.uint64), j_ranks)
    np.testing.assert_array_equal(h2.numpy(), j_h)
    np.testing.assert_array_equal(w2.numpy(), j_w)
    np.testing.assert_array_equal(p2.numpy(), j_p)
    np.testing.assert_array_equal(ehist[0].numpy(), hist)
    np.testing.assert_array_equal(ewts[0].numpy(), wts)

    ro = window_search(*args, rs=torch.from_numpy(rs), ranks_only=True, **kw)
    assert ro[1] is None
    for i in (0, 2, 3, 4, 5, 6, 7):
        assert torch.equal(ro[i], full[i])


def test_ranks_only_matches_jax_ranks_only():
    """Constant base+1 size, as VBR pass 1 calls it, against the Pallas
    kernel's own ranks-only form."""
    samples, _rs, n_valid, hist, wts, prev = _search_case(2, 8, 4, 3, seed=5)
    st = convert.encoder_state(hist, wts, prev)
    got = window_search(
        torch.from_numpy(samples), torch.from_numpy(n_valid), st.hist, st.wts, st.prev_sf,
        sfb=4, rs=3, sff=8, wpc=3, ranks_only=True,
    )
    want = _jax_search(
        samples.astype(np.int32), np.full((3, 2), 3, np.int32), n_valid, hist, wts, prev,
        8, 4, ranks_only=True,
    )
    j_sf, _codes, j_ranks, j_h, j_w, j_p = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), j_sf)
    np.testing.assert_array_equal(got[2].numpy().view(np.uint64), j_ranks)
    for a, b in zip(got[5:], (j_h, j_w, j_p)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("c,fpc,sff,sfb,rb,nc", [(2, 40, 10, 4, 2.5, 3), (1, 24, 8, 8, 5.5, 2)])
def test_encode_file_vbr_matches_jax(c, fpc, sff, sfb, rb, nc):
    rng = np.random.default_rng(c * 1000 + fpc)
    x = rng.integers(-32768, 32768, (nc, fpc, c)).astype(np.int16)
    hist = rng.integers(-32768, 32768, (c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 22), 1 << 22, (c, 4)).astype(np.int32)
    prev = rng.integers(0, 1 << sfb, c).astype(np.int32)
    target = t_vbr.normalized_vbr_bitrate(rb, fpc, sfb, sff)
    base = t_vbr.vbr_base(target)
    m1, _t, p1, p2 = t_vbr.interpolate_distribution(fpc * c // sff, target)
    st = convert.encoder_state(hist, wts, prev)
    kw = dict(scale_factor_frames=sff, scale_factor_bits=sfb, base=base, dist=(m1, p1, p2))
    got = t_encode_file_vbr(torch.from_numpy(x), st.hist, st.wts, st.prev_sf, **kw)
    want = j_encode_file_vbr(
        jnp.asarray(x), jnp.asarray(hist), jnp.asarray(wts), jnp.asarray(prev),
        use_pallas=False, **kw,
    )
    for a, b in zip(got, want):  # the JAX sizes are [nc, W*C]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(a.shape))


def _random_vbr_batch(rng, n, c, sfb, frames, sff, max_rs=8):
    w = -(-frames // sff)
    rs = rng.integers(1, max_rs + 1, (n, w, c)).astype(np.uint8)
    fiw = np.clip(frames - np.arange(w) * sff, 0, sff)
    bits = (rs.astype(np.int64) * fiw[None, :, None]).sum(axis=(1, 2))
    res = rng.integers(0, 256, (n, int(-(-bits.max() // 8))), dtype=np.uint8)
    sf = rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 24), 1 << 24, (n, c, 4)).astype(np.int32)
    return res, sf, rs, hist, wts


def _decode(batch, sfb, sff, frames):
    return decode_vbr_fused(*(torch.from_numpy(a) for a in batch), sfb=sfb, sff=sff, frames=frames).numpy()


@pytest.mark.parametrize("c,sfb,frames,sff", [(1, 4, 200, 20), (2, 3, 190, 20), (3, 5, 100, 10)])
def test_vbr_decode_matches_jax_fused_kernel(c, sfb, frames, sff):
    """Random bytes, per-window sizes 1..8 and LMS states, partial last
    window; the JAX fused kernel runs in interpret mode."""
    rng = np.random.default_rng(10 * c + sfb)
    batch = _random_vbr_batch(rng, 3, c, sfb, frames, sff)
    want = decode_chunks_packed_fused_vbr_single(
        *batch, scale_factor_frames=sff, frames=frames, sfb=sfb,
        max_code_bits=int(batch[2].max()), interpret=pallas_interpret(),
    )
    np.testing.assert_array_equal(_decode(batch, sfb, sff, frames), np.asarray(want))


def test_vbr_decode_255_channels_matches_jax_xla_path():
    """255 channels: the JAX fused kernel is gated off there (VMEM), so the
    reference is its XLA windowed-unpack path."""
    rng = np.random.default_rng(255)
    sfb, frames, sff = 4, 9, 4
    batch = _random_vbr_batch(rng, 2, 255, sfb, frames, sff)
    dqt_flat = np.asarray(j_tables.dqt_stacked(sfb).reshape(-1), np.int32)
    res, sf, rs, hist, wts = batch
    want = j_decode(
        res, sf, rs, hist, wts, dqt_flat,
        scale_factor_frames=sff, frames=frames, residual_size=0,
    )
    np.testing.assert_array_equal(_decode(batch, sfb, sff, frames), np.asarray(want))


@pytest.mark.parametrize("sfb", [1, 4, 7])
@pytest.mark.parametrize("bad_size", [0, 9, 255])
def test_vbr_plain_cleans_malformed_tables(sfb, bad_size):
    """Sizes outside 1..8 and scale factors at or past 2^sfb decode as the
    kernels read them: the plain version equals itself on the cleaned
    tables (sizes clamped, scale factors masked), instead of failing, and
    the two-kernel path's plain versions agree."""
    from sea_codec_torch.ops import dequant
    from sea_codec_torch.ops.fused_decode_vbr import decode_vbr_plain
    from sea_codec_torch.ops.lms_decode import lms_decode_plain

    rng = np.random.default_rng(100 * sfb + bad_size)
    frames, sff, c = 61, 7, 3
    res, sf, rs, hist, wts = _random_vbr_batch(rng, 2, c, sfb, frames, sff)
    bad = rng.random(rs.shape) < 0.4
    rs_bad = np.where(bad, np.uint8(bad_size), rs)
    sf_bad = sf | (rng.integers(1, 1 << (8 - sfb), sf.shape) << sfb).astype(np.uint8)
    kw = dict(sfb=sfb, sff=sff, frames=frames)
    t = lambda *a: [torch.from_numpy(x) for x in a]
    got = decode_vbr_plain(*t(res, sf_bad, rs_bad, hist, wts), **kw)
    clean = t(res, sf_bad & ((1 << sfb) - 1), np.clip(rs_bad, 1, 8), hist, wts)
    np.testing.assert_array_equal(got.numpy(), decode_vbr_plain(*clean, **kw).numpy())
    assert torch.equal(got, decode_vbr_fused(*t(res, sf_bad, rs_bad, hist, wts), **kw))
    dq = dequant.unpack_dequant_vbr_plain(*t(res, sf_bad, rs_bad), **kw)
    assert torch.equal(got, lms_decode_plain(dq, *t(hist, wts)))


@pytest.mark.parametrize(
    "channels,frames,fpc,sff,sfb,rb",
    [
        (2, 333, 96, 16, 4, 2.5),  # ragged tail
        (1, 250, 100, 10, 3, 1.5),
        (2, 160, 40, 20, 5, 8.0),  # base+2 = 9 clamps to 8
        (1, 200, 64, 4, 4, 4.0),  # high overhead: anchor base+1 < floor(rb)
        (2, 120, 40, 20, 8, 3.5),  # sfb 8
        (3, 150, 60, 20, 6, 2.5),  # 3 channels
    ],
)
def test_seeded_vbr_round_trip_matches_jax(channels, frames, fpc, sff, sfb, rb):
    sig = varied_signal(channels, frames, seed=frames + 7 * channels)
    kw = dict(
        scale_factor_bits=sfb, scale_factor_frames=sff, residual_bits=rb,
        frames_per_chunk=fpc, vbr=True,
    )
    encoded = sea_encode(sig, 44100, channels, EncoderSettings(**kw), device="cpu")
    assert encoded == jax_encode(sig, 44100, channels, JaxSettings(**kw))
    out = sea_decode(encoded, device="cpu")
    np.testing.assert_array_equal(out.samples, jax_decode(encoded).samples)
    assert out.samples.shape == (frames * channels,)


def test_high_overhead_anchor_is_base_plus_one():
    target = t_vbr.normalized_vbr_bitrate(4.0, 64, 4, 4)
    assert t_vbr.vbr_base(target) + 1 == t_vbr.chunk_residual_size(4.0, target) < 4


@pytest.mark.parametrize("i", [0, 1, 3, 5, 7, 11, 14, 17, 20, 23])
def test_reference_anchored_streams_decode_like_jax(i):
    """Streams whose chunk headers carry the reference's anchor
    floor(residual_bits) (tests/test_fixtures.py's matrix)."""
    encoded = anchored_matrix_stream(ANCHOR_MATRIX[i], seed=100 + i)
    np.testing.assert_array_equal(
        sea_decode(encoded, device="cpu").samples, jax_decode(encoded).samples
    )


@pytest.mark.parametrize("vbr", [False, True])
def test_device_batch_does_not_change_pcm(vbr):
    sig = varied_signal(2, 5 * 64 + 17, seed=3)
    st = EncoderSettings(frames_per_chunk=64, scale_factor_frames=16, residual_bits=2.5, vbr=vbr)
    encoded = sea_encode(sig, 44100, 2, st, device="cpu")
    header, rect, _tail = split_chunks(encoded)
    assert rect.shape[0] == 5 and parse_full_chunks(rect, header).chunk_type == (2 if vbr else 1)
    default = decode_sea(encoded, device="cpu").samples
    np.testing.assert_array_equal(decode_sea(encoded, device_batch=1, device="cpu").samples, default)
    np.testing.assert_array_equal(decode_sea(encoded, device_batch=2, device="cpu").samples, default)
    with pytest.raises(ValueError):
        decode_sea(encoded, device_batch=0, device="cpu")
