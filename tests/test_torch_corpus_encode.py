"""The lane-packed corpus encode of the PyTorch port (``device="cpu"``: the
plain versions of the kernels) against the JAX package and against the
port's own per-file encode: ``encode_corpus`` in both modes (ragged, empty
and sub-chunk files, 255 channels, sfb 8, several lane groups), the search's
per-lane valid-length form and its staged size range, the corpus cores and
serializer, the batched VBR size rule, ``parse_file``, the stage hooks and
parameter validation. Integer codec: every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, batch, convert
from sea_codec_torch.ops import encode_file, serialize_device, tables
from sea_codec_torch.ops import window_search as ws
from sea_codec_torch.utils.errors import SeaInvalidParameters
from sea_codec_torch.utils.profiling import StageTimes
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, varied_signal
from sea_codec_tpu import EncoderSettings as JaxSettings
from sea_codec_tpu import batch as j_batch
from sea_codec_tpu.ops import encode_file as j_encode_file
from sea_codec_tpu.ops import serialize_device as j_serialize

torch.set_num_threads(1)


def _corpus(channels, lens, seed):
    return [varied_signal(channels, n, seed=seed + i) for i, n in enumerate(lens)]


def _per_file(files, channels, st):
    return [batch.encode_sea(f, TEST_SAMPLE_RATE, channels, st, device="cpu") for f in files]


@pytest.fixture
def search_calls(monkeypatch):
    """Counts ``window_search`` calls from the encode paths: each is one
    kernel launch on the card (on the CPU the kernel's launch counter stays
    at 0)."""
    calls = []

    def counting(*args, **kw):
        calls.append(kw.get("ranks_only", False))
        return ws.window_search(*args, **kw)

    monkeypatch.setattr(encode_file, "window_search", counting)
    monkeypatch.setattr(batch, "window_search", counting)
    return calls


@pytest.mark.parametrize("vbr", [False, True])
def test_encode_corpus_matches_jax_and_per_file(vbr, search_calls):
    """Ragged tails, exact multiples, a sub-chunk file and an empty file in
    one corpus: byte-identical to the JAX ``encode_corpus`` and to the
    port's per-file ``encode_sea``, in one lane group."""
    rng = np.random.default_rng(11 + vbr)
    st = EncoderSettings(frames_per_chunk=500, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    lens = [int(x) for x in rng.integers(120, 1600, size=6)] + [500, 1000, 77, 0]
    files = _corpus(2, lens, 100 * vbr)
    out = batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu")
    n_calls = len(search_calls)
    assert out == _per_file(files, 2, st)
    jst = JaxSettings(frames_per_chunk=500, residual_bits=st.residual_bits, vbr=vbr)
    assert out == j_batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, jst)
    # lane-packed: one launch for CBR; two a chunk index and two for the tails
    assert n_calls == (2 * (max(lens) // 500) + 2 if vbr else 1)


@pytest.mark.parametrize(
    "channels,sfb,vbr",
    [(255, 4, False), (255, 4, True), (3, 8, False), (3, 8, True)],
)
def test_encode_corpus_wide_and_sfb8_ride_the_lanes(channels, sfb, vbr, search_calls):
    """255 channels and sfb 8, which the JAX package encodes one file at a
    time, ride the lane-packed path here: one search launch a lane group
    for CBR, two a chunk index (and two for the tails) for VBR, for all
    the files together; byte-identical to per-file ``encode_sea``."""
    fpc = 40 if channels == 255 else 100
    st = EncoderSettings(frames_per_chunk=fpc, scale_factor_bits=sfb, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    lens = [3 * fpc + 7, fpc, fpc // 2, 2 * fpc + 1]
    files = _corpus(channels, lens, 7)
    out = batch.encode_corpus(files, TEST_SAMPLE_RATE, channels, st, device="cpu")
    calls = list(search_calls)
    assert out == _per_file(files, channels, st)
    if vbr:
        assert len(calls) == 2 * 3 + 2 and sum(calls) == 3 + 1  # half of them ranks-only
    else:
        assert calls == [False]


def test_encode_corpus_several_groups_in_flight(monkeypatch, search_calls):
    """A device-memory bound small enough for one file a group: one launch a
    group, longest files first, the same bytes at every pipeline depth."""
    st = EncoderSettings(frames_per_chunk=100)
    lens = [250, 730, 0, 99, 400]
    files = _corpus(2, lens, 3)
    want = _per_file(files, 2, st)
    assert batch._lane_groups(lens, 2, 100) == [[1, 4, 0, 3, 2]]
    monkeypatch.setattr(batch, "_GROUP_DEVICE_BYTES", 2 * 100 * batch._LANE_FRAME_BYTES)
    assert batch._lane_groups(lens, 2, 100) == [[1], [4], [0], [3], [2]]
    for depth in (0, 1, 4):
        del search_calls[:]
        assert batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, pipeline_depth=depth, device="cpu") == want
        assert len(search_calls) == 4  # the empty file launches nothing


def _jax_lanes(samples, rs, n_valid, hist, wts, prev, sff, sfb):
    """The JAX package's XLA search with per-lane valid lengths."""
    run = j_encode_file._window_kernel(False, sff, sfb)
    out = run(*(jnp.asarray(a) for a in (samples.astype(np.int32), rs, n_valid, hist, wts, prev)))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("sfb,sff,c,form", [(4, 20, 5, "cbr"), (2, 7, 3, "sizes"), (8, 4, 4, "ranks_only"),
                                            (5, 10, 6, "sizes")])
def test_per_lane_search_matches_jax_and_each_lane_alone(sfb, sff, c, form):
    """``n_valid`` int32[W, C] mixing full, partial and empty windows per
    lane (a prefix length on some lanes, any count per window on others):
    equal to the JAX search's per-lane form, and each lane equal to that
    lane searched alone with its own int32[W]."""
    rng = np.random.default_rng(sfb * 100 + c)
    nw = 6
    samples = rng.integers(-32768, 32768, (nw * sff, c)).astype(np.int16)
    length = np.array([nw * sff, 0, 2 * sff + 3, 5, nw * sff - 1, 3 * sff][:c])
    nv = np.clip(length[None, :] - np.arange(nw)[:, None] * sff, 0, sff).astype(np.int32)
    nv[:, 3::2] = rng.integers(0, sff + 1, (nw, len(range(3, c, 2))))
    hist = rng.integers(-32768, 32768, (c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 22), 1 << 22, (c, 4)).astype(np.int32)
    prev = rng.integers(0, 1 << sfb, c).astype(np.int32)
    st = convert.encoder_state(hist, wts, prev)
    sizes = rng.integers(1, 9, (nw, c)).astype(np.int32) if form == "sizes" else np.full((nw, c), 3, np.int32)
    rs = torch.from_numpy(sizes) if form == "sizes" else 3
    kw = dict(sfb=sfb, sff=sff, wpc=4, rs=rs, ranks_only=form == "ranks_only")
    got = ws.window_search(torch.from_numpy(samples), torch.from_numpy(nv), st.hist, st.wts, st.prev_sf, **kw)
    j_sf, j_codes, j_ranks, j_h, j_w, j_p = _jax_lanes(samples, sizes, nv, hist, wts, prev, sff, sfb)
    np.testing.assert_array_equal(got[0].numpy(), j_sf)
    if form != "ranks_only":
        np.testing.assert_array_equal(got[1].numpy(), j_codes)
    np.testing.assert_array_equal(got[2].numpy().view(np.uint64), j_ranks)
    for g, w in zip(got[5:], (j_h, j_w, j_p)):
        np.testing.assert_array_equal(g.numpy(), w)
    for lane in range(c):
        one = ws.window_search(
            torch.from_numpy(samples[:, lane : lane + 1].copy()), torch.from_numpy(nv[:, lane].copy()),
            st.hist[lane : lane + 1], st.wts[lane : lane + 1], st.prev_sf[lane : lane + 1],
            **dict(kw, rs=rs[:, lane : lane + 1] if torch.is_tensor(rs) else rs),
        )
        for axis, g, o in zip((1, 1, 1, 1, 1, 0, 0, 0), got, one):
            if g is not None:
                np.testing.assert_array_equal(g.narrow(axis, lane, 1).numpy(), o.numpy())
    # a lane masked throughout keeps its entry state and previous winner
    assert torch.equal(got[5][1], st.hist[1]) and int(got[7][1]) == prev[1]


@pytest.mark.parametrize("lo,hi", [(1, 4), (2, 5), (5, 8), (3, 3), (1, 8)])
def test_staged_size_range(lo, hi):
    """The rows a per-window launch stages for sizes lo..hi hold each size's
    rows where the kernel looks for them (its first row less the first
    staged size's); the search with the range equals the all-rows form, and
    sizes outside the range are refused."""
    first, rows = tables.search_table_rows((lo, hi))
    table = tables.search_table(4)
    staged = table[first : first + rows]
    row_base = (4 << lo) + lo - 9
    for rs in range(lo, hi + 1):
        f, n = tables.search_table_rows(rs)
        row0 = (4 << rs) + rs - 9 - row_base
        np.testing.assert_array_equal(staged[row0 : row0 + n], table[f : f + n])
    assert first + rows == sum(tables.search_table_rows(hi))
    assert ws._table_rows(16, 20, False, (lo, hi)) == rows
    rng = np.random.default_rng(lo * 10 + hi)
    c, nw, sff = 3, 4, 20
    x = torch.from_numpy(rng.integers(-20000, 20000, (nw * sff, c)).astype(np.int16))
    st = convert.encoder_state(np.zeros((c, 4), np.int32), rng.integers(-9000, 9000, (c, 4)).astype(np.int32),
                               np.zeros(c, np.int32))
    sizes = torch.from_numpy(rng.integers(lo, hi + 1, (nw, c)).astype(np.uint8))
    kw = dict(sfb=4, sff=sff, wpc=nw, rs=sizes)
    got = ws.window_search(x, None, st.hist, st.wts, st.prev_sf, rs_range=(lo, hi), **kw)
    want = ws.window_search(x, None, st.hist, st.wts, st.prev_sf, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if (lo, hi) != (1, 8):
        bad = sizes.clone()
        bad[0, 0] = hi + 1 if hi < 8 else lo - 1
        with pytest.raises(ValueError, match="outside the staged range"):
            ws.window_search(x, None, st.hist, st.wts, st.prev_sf, rs_range=(lo, hi), **dict(kw, rs=bad))


def _sizes_reference(errors_u64, sortable, base, m1, p1, p2):
    """The JAX package's chooser (``models/vbr.py``) in numpy, with the
    distribution given."""
    order = np.argsort(errors_u64[:sortable], kind="stable")
    sizes = np.full(errors_u64.shape[0], base, dtype=np.int64)
    sizes[order[:m1]] = base - 1
    sizes[order[sortable - p2 - p1 : sortable - p2]] = base + 1
    sizes[order[sortable - p2 :]] = base + 2
    return np.clip(sizes, 1, 8)


def test_vbr_size_range_and_batched_rule():
    """The batched positional rule, each row with its own distribution and
    sortable count, equals the reference chooser row by row, in u64 order
    (a rank of 2^64 - 1 included, tied with the unsortable items' key);
    the sizes fall in ``vbr_size_range``."""
    rng = np.random.default_rng(5)
    assert encode_file.vbr_size_range(2) == (1, 4)
    assert encode_file.vbr_size_range(0) == (1, 2)
    assert encode_file.vbr_size_range(7) == (6, 8)
    ranks = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (5, 24)))
    ranks[2, 3:9] = ranks[2, 10]  # ties keep their order
    ranks[4, 1] = -1  # u64 max: its key is the unsortable items' key
    ranks[0, :4] = -ranks[0, :4].abs()  # u64 above 2^63
    rows = [(24, 2, 3, 1), (17, 0, 5, 2), (12, 4, 0, 0), (24, 1, 1, 1), (9, 1, 2, 3)]
    n_s, m1, p1, p2 = (torch.tensor([[r[k]] for r in rows]) for k in range(4))
    for base in (0, 2, 7):
        got = encode_file.vbr_sizes_rows(ranks, base, m1, p1, p2, n_s)
        lo, hi = encode_file.vbr_size_range(base)
        assert int(got.min()) >= lo and int(got.max()) <= hi
        for i, (n, a, b, d) in enumerate(rows):
            want = _sizes_reference(ranks[i].numpy().view(np.uint64), n, base, a, b, d)
            np.testing.assert_array_equal(got[i].numpy(), want)
            one = encode_file.vbr_sizes(ranks[i].reshape(4, 6), base, (a, b, d), n)
            np.testing.assert_array_equal(one.reshape(-1).numpy(), want)


@pytest.mark.parametrize("full_only", [False, True])
def test_corpus_n_valid_matches_jax(full_only):
    frames = np.array([0, 1, 99, 100, 101, 350, 400], np.int32)
    got = encode_file.corpus_n_valid(torch.from_numpy(frames), 5, 100, 20, full_only)
    want = j_encode_file.corpus_n_valid(jnp.asarray(frames), 5, 100, 20, full_only)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_cbr_chunk_size_matches_jax():
    for args in [(1, 5120, 4, 20, 3), (2, 300, 4, 20, 3), (255, 7, 8, 3, 8), (3, 1, 1, 1, 1)]:
        assert serialize_device.cbr_chunk_size(*args) == j_serialize.cbr_chunk_size(*args)


def test_corpus_cbr_packed_matches_jax():
    """The CBR corpus core: rows, tail gathers and final state equal to the
    JAX core's on lane-packed inputs (lane = file * C + channel)."""
    rng = np.random.default_rng(9)
    nf, c, nc, fpc, sff = 3, 2, 3, 60, 20
    lens = [170, 60, 31]
    b = nf * c
    x = np.zeros((nc, fpc, b), np.int16)
    for j, n in enumerate(lens):
        sig = rng.integers(-20000, 20000, (n, c)).astype(np.int16)
        pad = np.zeros((nc * fpc, c), np.int16)
        pad[:n] = sig
        x[:, :, j * c : (j + 1) * c] = pad.reshape(nc, fpc, c)
    frames = np.repeat(np.asarray(lens, np.int32), c)
    tail_idx = np.asarray([n // fpc for n in lens])
    st = convert.encoder_state(np.zeros((b, 4), np.int32),
                               np.tile([[0, 0, -(1 << 13), 1 << 14]], (b, 1)).astype(np.int32),
                               np.zeros(b, np.int32))
    got = encode_file.corpus_cbr_packed(
        torch.from_numpy(x), torch.from_numpy(frames), torch.from_numpy(tail_idx), st.hist, st.wts, st.prev_sf,
        scale_factor_frames=sff, scale_factor_bits=4, residual_size=3, n_files=nf,
    )
    want = j_encode_file._corpus_cbr_packed_core(
        jnp.asarray(x), jnp.asarray(frames), jnp.asarray(tail_idx.astype(np.int32)),
        *(jnp.asarray(t.numpy()) for t in (st.hist, st.wts, st.prev_sf)),
        scale_factor_frames=sff, scale_factor_bits=4, residual_size=3, n_files=nf, use_pallas=False,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_parse_file_matches_jax():
    for vbr, n in [(False, 437), (True, 437), (False, 300), (True, 63), (False, 37)]:
        st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
        enc = batch.encode_sea(varied_signal(2, n, seed=n), TEST_SAMPLE_RATE, 2, st, device="cpu")
        header, parsed, frames_real = batch.parse_file(enc)
        j_header, j_parsed, j_frames = j_batch.parse_file(enc)
        assert header.serialize() == j_header.serialize()
        for g, w in zip(parsed, j_parsed):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(frames_real, j_frames)


def test_stage_times_recorded_and_bytes_unchanged():
    """With ``PIPELINE_TIMES`` set, both corpus paths record their stages
    and byte counters, and their outputs do not change."""
    st = EncoderSettings(frames_per_chunk=100)
    files = _corpus(2, [250, 99, 0], 4)
    enc = batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu")
    dec = batch.decode_corpus(enc[:2], device="cpu")
    batch.PIPELINE_TIMES = times = StageTimes()
    try:
        assert batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu") == enc
        got = batch.decode_corpus(enc[:2], device="cpu")
    finally:
        batch.PIPELINE_TIMES = None
    for a, b in zip(got, dec):
        np.testing.assert_array_equal(a.samples, b.samples)
    for key in ("encode_stage", "encode_put", "encode_fetch", "encode_assemble", "decode_parse", "decode_tails",
                "decode_stage", "decode_put", "decode_fetch", "decode_assemble"):
        assert times[key] > 0, key
    # the samples, each lane's frames, each file's tail index, the tails'
    # lanes and frames
    assert times["encode_put_bytes"] == (250 + 99) * 2 * 2 + 6 * 4 + 3 * 8 + 4 * 8 + 2 * 8
    assert times["decode_fetch_bytes"] == 4 * 100 * 2 * 2
    assert "encode_put_bytes" in times.report() and "total" in times.report()


def test_device_trace_writes_where_sea_profile_names(tmp_path, monkeypatch):
    """``device_trace`` records a torch.profiler Chrome trace into the
    directory ``SEA_PROFILE`` names, and does nothing without one."""
    from sea_codec_torch.utils.profiling import device_trace

    monkeypatch.delenv("SEA_PROFILE", raising=False)
    with device_trace():
        torch.ones(3).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("SEA_PROFILE", str(tmp_path / "prof"))
    with device_trace():
        torch.ones(3).sum()
    traces = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize(
    "channels,kwargs",
    [
        (300, {}),
        (0, {}),
        (2, dict(scale_factor_bits=9)),
        (2, dict(scale_factor_bits=0)),
        (2, dict(residual_bits=0.5)),
        (2, dict(residual_bits=9.0)),
        (2, dict(scale_factor_frames=7)),  # does not divide frames_per_chunk
        (2, dict(frames_per_chunk=0)),
    ],
)
def test_encode_corpus_validates_parameters(channels, kwargs):
    """The corpus encode rejects what ``encode_sea`` rejects, with the same
    error, before it needs a device."""
    samples = np.zeros(600 * max(channels, 1), dtype=np.int16)
    with pytest.raises(SeaInvalidParameters):
        batch.encode_corpus([samples], TEST_SAMPLE_RATE, channels, EncoderSettings(**kwargs), device="cpu")
