"""Scale-factor search and the CBR encode core of the PyTorch port (plain
versions on the CPU) against the JAX package: the Pallas search kernel in
interpret mode (sfb <= 7, its VMEM gate) and the XLA window kernel (sfb 8),
from mid-stream states carried over with ``sea_codec_torch.convert`` and
with ragged valid-frame counts. sf, codes, u64 ranks and the final state
are all compared exactly."""

from __future__ import annotations

from conftest import pallas_interpret

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_codec_torch import convert
from sea_codec_torch.ops.encode_file import corpus_cbr_scan, corpus_n_valid
from sea_codec_torch.ops.window_search import window_search
from sea_codec_tpu.ops import tables as j_tables
from sea_codec_tpu.ops.device_encode import encode_windows_fn
from sea_codec_tpu.ops.encode_file import encode_file_cbr as j_encode_file
from sea_codec_tpu.ops.pallas_encode import encode_windows_pallas_fn

torch.set_num_threads(1)


def _mid_stream_state(rng, c, big):
    hist = rng.integers(-32768, 32768, (c, 4)).astype(np.int32)
    lim = 1 << 22 if big else 1 << 15
    wts = rng.integers(-lim, lim, (c, 4)).astype(np.int32)
    prev = rng.integers(0, 1 << 8, c).astype(np.int32)
    return hist, wts, prev


def _jax_search(samples, rs, n_valid, hist, wts, prev, sff, sfb):
    args = [jnp.asarray(a) for a in (samples, rs, n_valid, hist, wts, prev)]
    if sfb <= 7:
        return encode_windows_pallas_fn(
            *args, scale_factor_frames=sff, scale_factor_bits=sfb,
            interpret=pallas_interpret(),
        )
    return encode_windows_fn(
        *args,
        jnp.asarray(j_tables.dqt_stacked(sfb).reshape(-1), jnp.int32),
        jnp.asarray(j_tables.reciprocals_stacked(sfb), jnp.int32),
        jnp.asarray(j_tables.quant_tab(), jnp.int32),
        jnp.asarray(j_tables.quant_offsets(), jnp.int32),
        scale_factor_frames=sff, n_candidates=1 << sfb,
    )


@pytest.mark.parametrize(
    "c,sff,sfb,rs,nw,ragged,big",
    [
        (1, 10, 1, 1, 3, False, False),
        (2, 10, 4, 3, 4, True, True),
        (3, 5, 3, 8, 4, True, False),
        (2, 8, 7, 5, 3, False, True),
        (1, 6, 2, 2, 3, True, False),
        (2, 4, 8, 4, 3, True, True),
    ],
)
def test_window_search_matches_jax(c, sff, sfb, rs, nw, ragged, big):
    rng = np.random.default_rng(hash((c, sff, sfb, rs)) % 2**31)
    samples = rng.integers(-32768, 32768, (nw * sff, c)).astype(np.int16)
    n_valid = np.full(nw, sff, np.int32)
    if ragged:
        n_valid[-1] = sff - 3
    hist, wts, prev = _mid_stream_state(rng, c, big)
    prev %= 1 << sfb
    st = convert.encoder_state(hist, wts, prev)
    sf, codes, ranks, ehist, ewts, h2, w2, p2 = window_search(
        torch.from_numpy(samples), torch.from_numpy(n_valid), st.hist, st.wts, st.prev_sf,
        sfb=sfb, rs=rs, sff=sff, wpc=nw,
    )
    want = _jax_search(
        samples.astype(np.int32), np.full((nw, c), rs, np.int32), n_valid,
        hist, wts, prev, sff, sfb,
    )
    j_sf, j_codes, j_ranks, j_h, j_w, j_p = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(sf.numpy(), j_sf)
    np.testing.assert_array_equal(codes.numpy(), j_codes)
    np.testing.assert_array_equal(ranks.numpy().view(np.uint64), j_ranks)
    np.testing.assert_array_equal(h2.numpy(), j_h)
    np.testing.assert_array_equal(w2.numpy(), j_w)
    np.testing.assert_array_equal(p2.numpy(), j_p)
    np.testing.assert_array_equal(ehist[0].numpy(), hist)
    np.testing.assert_array_equal(ewts[0].numpy(), wts)


@pytest.mark.parametrize(
    "c,fpc,sff,sfb,rs,nc",
    [(2, 40, 10, 4, 3, 3), (1, 24, 8, 8, 2, 2), (3, 20, 5, 5, 6, 2)],
)
def test_encode_file_cbr_matches_jax(c, fpc, sff, sfb, rs, nc):
    """Whole-file search from a mid-stream state, through the corpus core
    with one file's lanes: per-chunk entry states come out of the one
    launch and equal the JAX chunk scan's."""
    rng = np.random.default_rng(c * 1000 + fpc)
    x = rng.integers(-32768, 32768, (nc, fpc, c)).astype(np.int16)
    hist, wts, prev = _mid_stream_state(rng, c, big=True)
    prev %= 1 << sfb
    st = convert.encoder_state(hist, wts, prev)
    nv = corpus_n_valid(torch.full((c,), nc * fpc), nc, fpc, sff, full_only=False)
    got = corpus_cbr_scan(
        torch.from_numpy(x), nv, st.hist, st.wts, st.prev_sf,
        scale_factor_frames=sff, scale_factor_bits=sfb, residual_size=rs,
    )
    want = j_encode_file(
        jnp.asarray(x), jnp.asarray(hist), jnp.asarray(wts), jnp.asarray(prev),
        scale_factor_frames=sff, scale_factor_bits=sfb, residual_size=rs,
        use_pallas=False,
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_convert_settings_and_entry_state():
    from sea_codec_tpu.encoder import EncoderSettings as JaxSettings

    js = JaxSettings(scale_factor_bits=6, residual_bits=5.0, frames_per_chunk=640, metadata="a=b\n")
    ts = convert.settings(js)
    assert (ts.scale_factor_bits, ts.residual_bits, ts.frames_per_chunk, ts.metadata) == (6, 5.0, 640, "a=b\n")
    h, w = convert.lms_entry_state(np.ones((2, 3, 4), np.int64), np.zeros((2, 3, 4)))
    assert h.dtype == w.dtype == torch.int32 and h.shape == (2, 3, 4)
