"""``decode_range`` and ``decode_corpus`` of the PyTorch port
(``device="cpu"``) against the JAX package's functions: tail-only files, a
ragged mix, several configurations in one corpus, ``on_error="skip"``, the
wave drain, results that own their PCM, both routings of the decode,
corrupt full chunks refused with the host parser's texts, and full chunks
parsed on the card alone. Mirrors the JAX package's tail-merge and batch
tests. Integer codec: exact equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, batch, convert, sea_decode, sea_encode
from sea_codec_torch.ops import dequant, fused_decode
from sea_codec_torch.ops.device_decode import decode_chunks_packed
from sea_codec_torch.parallel import pipeline
from sea_codec_torch.utils.errors import SeaInvalidFrame
from sea_codec_torch.utils.profiling import StageTimes
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, varied_signal
from sea_codec_tpu import batch as j_batch

torch.set_num_threads(1)


def _st(vbr, fpc=100, **kw):
    return EncoderSettings(residual_bits=2.5 if vbr else 3.0, frames_per_chunk=fpc, vbr=vbr, **kw)


def _encode(channels, frames, st, seed=None):
    sig = varied_signal(channels, frames, seed=frames if seed is None else seed)
    return sea_encode(sig, TEST_SAMPLE_RATE, channels, st, device="cpu")


def _assert_same(outs, wants):
    assert len(outs) == len(wants)
    for o, w in zip(outs, wants):
        assert (o is None) == (w is None)
        if o is not None:
            assert (o.channels, o.sample_rate) == (w.channels, w.sample_rate)
            np.testing.assert_array_equal(o.samples, w.samples)


@pytest.mark.parametrize("vbr", [False, True])
def test_decode_range_matches_jax(vbr):
    """Ranges that start and end inside chunks, cross chunk boundaries,
    reach into the tail, and run past the end."""
    channels, fpc, frames = 2, 100, 437
    enc = _encode(channels, frames, _st(vbr))
    full = sea_decode(enc, device="cpu").samples.reshape(-1, channels)
    for start, count in [(0, 437), (0, 1), (37, 20), (95, 10), (150, 250), (399, 38),
                         (410, 500), (437, 5), (1000, 3), (5, 0)]:
        got = batch.decode_range(enc, start, count, device="cpu")
        np.testing.assert_array_equal(got, j_batch.decode_range(enc, start, count))
        np.testing.assert_array_equal(got, full[start : start + count].reshape(-1))


def test_decode_range_tail_only_file():
    enc = _encode(1, 63, _st(False))
    np.testing.assert_array_equal(
        batch.decode_range(enc, 10, 40, device="cpu"), j_batch.decode_range(enc, 10, 40)
    )


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("vbr", [False, True])
def test_corpus_tail_only_and_ragged_mix(vbr, fused, monkeypatch):
    """Tail-only files (a group of their own at the full-chunk width) mixed
    with ragged and exact-multiple files, through both routings."""
    monkeypatch.setenv("SEA_FUSED_PROLOG", fused)
    channels = 2
    st = _st(vbr)
    encs = [_encode(channels, n, st) for n in [37, 99, 100, 63, 251, 700, 1, 200]]
    outs = batch.decode_corpus(encs, device="cpu")
    _assert_same(outs, j_batch.decode_corpus(encs))
    for e, o in zip(encs, outs):
        np.testing.assert_array_equal(o.samples, sea_decode(e, device="cpu").samples)


def test_corpus_mixed_configurations_and_small_batches():
    """CBR and VBR, mono/stereo/3-channel, two chunk lengths, in one corpus,
    decoded two chunks per batch."""
    encs = [
        _encode(2, 330, _st(False)), _encode(2, 250, _st(True)), _encode(3, 410, _st(False)),
        _encode(1, 130, _st(True, fpc=60)), _encode(2, 205, _st(False)), _encode(3, 77, _st(True)),
        _encode(1, 60, _st(False, fpc=60, scale_factor_bits=6)),
    ]
    _assert_same(batch.decode_corpus(encs, device_batch=2, device="cpu"), j_batch.decode_corpus(encs))
    assert batch.decode_corpus([], device="cpu") == []
    with pytest.raises(ValueError):
        batch.decode_corpus(encs, device_batch=0, device="cpu")


def test_corpus_on_error_skip():
    st = _st(False)
    good = _encode(2, 250, st)
    truncated = good[: len(good) - 40]
    garbage = b"not a sea file at all"
    files = [good, garbage, truncated, _encode(2, 99, st)]
    outs = batch.decode_corpus(files, on_error="skip", device="cpu")
    _assert_same(outs, j_batch.decode_corpus(files, on_error="skip"))
    assert outs[1] is None and outs[0] is not None and outs[3] is not None
    with pytest.raises(Exception):
        batch.decode_corpus(files, device="cpu")
    with pytest.raises(ValueError, match="on_error"):
        batch.decode_corpus(files, on_error="ignore", device="cpu")


@pytest.mark.parametrize("vbr", [False, True])
def test_corpus_wave_drain_gives_the_same_pcm(vbr, monkeypatch):
    """A live-bytes bound below one batch brings each batch down before the
    next launch. Downloads here never land on their own, as on a card still
    busy: with the bound, the bytes fetched at each launch are those of
    every batch launched before it; without it, none has come down before
    the last launch. The PCM is the same either way."""
    st = _st(vbr)
    encs = [_encode(2, n, st) for n in [330, 250, 99, 401]]
    want = batch.decode_corpus(encs, device_batch=2, device="cpu")
    monkeypatch.setattr(batch._Download, "ready", lambda self: False)
    real = batch.decode_chunks_packed
    seen = []  # (PCM bytes fetched before a launch, the launch's PCM bytes)

    def launch(*a, **k):
        out = real(*a, **k)
        seen.append((batch.PIPELINE_TIMES["decode_fetch_bytes"], out.nbytes))
        return out

    monkeypatch.setattr(batch, "decode_chunks_packed", launch)
    for bound in (None, "1"):
        if bound is None:
            monkeypatch.delenv("SEA_DECODE_MAX_LIVE_BYTES", raising=False)
        else:
            monkeypatch.setenv("SEA_DECODE_MAX_LIVE_BYTES", bound)
        seen.clear()
        batch.PIPELINE_TIMES = times = StageTimes()
        try:
            got = batch.decode_corpus(encs, device_batch=2, device="cpu")
        finally:
            batch.PIPELINE_TIMES = None
        _assert_same(got, want)
        fetched = [f for f, _n in seen]
        launched = np.cumsum([0] + [n for _f, n in seen]).tolist()
        assert len(seen) >= 5 and times["decode_fetch_bytes"] == launched[-1]
        assert fetched == (launched[:-1] if bound else [0] * len(seen))


def _own_pcm_corpus(vbr):
    """Mixed configurations of one mode: ragged tails, an exact multiple of
    the chunk, a tail-only file, another channel count and chunk length."""
    return [_encode(2, 437, _st(vbr)), _encode(2, 63, _st(vbr)), _encode(3, 410, _st(vbr)),
            _encode(2, 300, _st(vbr)), _encode(1, 130, _st(vbr, fpc=60)), _encode(2, 251, _st(vbr))]


def _assert_own_pcm(outs, encs):
    """Each result a C-contiguous int16 array of its file's frames x
    channels, owning its memory and sharing it with no other result."""
    kept = [(o, e) for o, e in zip(outs, encs) if o is not None]
    for o, e in kept:
        header = batch.split_chunks(e)[0]
        s = o.samples
        assert s.dtype == np.int16 and s.ndim == 1 and s.flags.c_contiguous and s.flags.owndata
        assert s.size == header.total_frames * header.channels
    for i, (o, _e) in enumerate(kept):
        for p, _f in kept[i + 1 :]:
            assert not np.shares_memory(o.samples, p.samples)


class _Unfinished:
    """A copy's future that reads as still running until it is waited for."""

    def __init__(self, future):
        self.future = future

    def done(self):
        return False

    def result(self):
        return self.future.result()


@pytest.fixture
def threaded_placement(monkeypatch):
    """Placement through the copy threads in small pieces, each read as
    running until waited for (as a placement still copying), with a bound
    on PCM in flight below two batches; records the bytes in flight after
    each batch starts, beside the batch's own."""
    monkeypatch.setattr(batch, "_STAGE_PIECE_BYTES", 256)
    monkeypatch.setattr(batch, "_DRAIN_PINNED_BYTES", 3000)
    copy = batch._copy
    monkeypatch.setattr(batch, "_copy", lambda pairs: [_Unfinished(f) for f in copy(pairs)])
    held = []
    real = batch._PcmDrain.start

    def start(self, xfer, pcm, places):
        real(self, xfer, pcm, places)
        held.append((self.host_bytes, pcm.nbytes))

    monkeypatch.setattr(batch._PcmDrain, "start", start)
    return held


def _place(entries):
    if entries == 1:
        return dict(device="cpu")
    return dict(mesh=pipeline.make_mesh(devices=[torch.device("cpu")] * entries))


@pytest.mark.parametrize("entries", [1, 4])
@pytest.mark.parametrize("vbr", [False, True])
def test_corpus_results_own_their_pcm(vbr, entries, threaded_placement):
    """Each file's PCM is written once into an output of its own, as its
    batches land, in batches that split one file and join several: every
    result equals ``decode_sea``'s and the JAX package's PCM, is exactly
    its file's frames x channels, and shares memory with no other result.
    The PCM in flight stays within the bound, or one batch past it."""
    encs = _own_pcm_corpus(vbr)
    outs = batch.decode_corpus(encs, device_batch=3, **_place(entries))
    _assert_same(outs, j_batch.decode_corpus(encs))
    for o, e in zip(outs, encs):
        np.testing.assert_array_equal(o.samples, sea_decode(e, device="cpu").samples)
    _assert_own_pcm(outs, encs)
    assert len(threaded_placement) >= 7  # 2-channel rows 4, 3-channel 2, mono 1
    assert all(h <= max(batch._DRAIN_PINNED_BYTES, n) for h, n in threaded_placement)
    assert any(h > n for h, n in threaded_placement)  # batches were in flight together


@pytest.mark.parametrize("entries", [1, 4])
def test_corpus_skip_drops_the_pcm_of_a_bad_size_table(entries, threaded_placement):
    """With ``on_error="skip"``, a VBR file whose size table the card
    refuses gives None, its PCM already placed and then dropped, and every
    other file its exact PCM in an output of its own."""
    base = _encode(2, 400, _st(True))
    bad = _rows_file(base, mutate=lambda r, lay: _set_anchor(r, 6))
    encs = _own_pcm_corpus(True)
    encs.insert(2, bad)
    outs = batch.decode_corpus(encs, device_batch=3, on_error="skip", **_place(entries))
    assert outs[2] is None and sum(o is None for o in outs) == 1
    _assert_same(outs, j_batch.decode_corpus(encs, on_error="skip"))
    for o, e in zip(outs, encs):
        if o is not None:
            np.testing.assert_array_equal(o.samples, sea_decode(e, device="cpu").samples)
    _assert_own_pcm(outs, encs)


def test_oversize_tail_group_takes_the_two_kernel_path(monkeypatch):
    """A tail-only 255-channel CBR file decodes in a group at the full-chunk
    width (~490 KB a row), more than a block's shared memory. The fused CBR
    kernel streams a row by tile, so the default routing keeps the group on
    it; with the fused kernels off the router sends it to the two-kernel
    path."""
    channels = 255
    rng = np.random.default_rng(2)
    pcm = rng.integers(-20000, 20000, 24 * channels).astype(np.int16)
    enc = sea_encode(pcm, TEST_SAMPLE_RATE, channels, EncoderSettings(), device="cpu")
    calls = []
    for mod, name in ((fused_decode, "decode_cbr_fused"), (dequant, "unpack_dequant_cbr")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _real=real, _name=name, **k: (calls.append(_name), _real(*a, **k))[1]
        )
    monkeypatch.delenv("SEA_FUSED_PROLOG", raising=False)
    (out,) = batch.decode_corpus([enc], device="cpu")
    assert calls == ["decode_cbr_fused"]
    calls.clear()
    monkeypatch.setenv("SEA_FUSED_PROLOG", "0")
    (two,) = batch.decode_corpus([enc], device="cpu")
    assert calls == ["unpack_dequant_cbr"]
    np.testing.assert_array_equal(two.samples, out.samples)
    monkeypatch.delenv("SEA_FUSED_PROLOG")
    calls.clear()
    np.testing.assert_array_equal(out.samples, sea_decode(enc, device="cpu").samples)
    assert calls == ["decode_cbr_fused"]  # the tail at its own length fits


def test_merged_tail_rows_match_jax_rows():
    """A tail's row in a full-chunk batch: the port takes the residual
    section as on the wire where the JAX package repacks the codes."""
    for vbr in (False, True):
        enc = _encode(2, 317, _st(vbr))
        _h, _rows, _lay, chunk, fpc = batch._stage_file(enc)
        j_chunk = j_batch._stage_file_parsed(enc)[3]
        got = batch._tail_packed_row(chunk, 2, fpc)
        want = j_batch._tail_packed_row(j_chunk, 2, fpc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_parsed_concat_and_convert_match_jax():
    st = _st(True)
    encs = [_encode(2, 330, st), _encode(2, 40, st), _encode(2, 250, st)]
    header, cfg, arrays = batch.parsed_concat(encs)
    j_header, j_cfg, j_arrays = j_batch.parsed_concat(encs)
    assert (header.channels, cfg.residual_size, cfg.scale_factor_bits) == (
        j_header.channels, j_cfg.residual_size, j_cfg.scale_factor_bits)
    for a, b in zip(arrays, j_arrays):
        np.testing.assert_array_equal(a, b)
    # a JAX-side ParsedBatch through convert into the port's router
    j_b = j_batch.parse_full_chunks(j_batch.split_chunks(encs[0])[1], j_header)
    pcm = decode_chunks_packed(
        *convert.parsed_batch(j_b), sfb=j_b.scale_factor_bits, sff=j_b.scale_factor_frames,
        frames=100, residual_size=j_b.residual_size,
    )
    want = j_batch.decode_sea(encs[0]).samples
    np.testing.assert_array_equal(pcm.numpy().reshape(-1), want[: 300 * 2])
    with pytest.raises(SeaInvalidFrame):
        batch.parsed_concat([encs[1]])


def _rows_file(enc, chunk_size=None, mutate=None):
    """``enc``'s full chunks (it has no tail) in a file whose header
    declares ``chunk_size`` (each row cut to it), with ``mutate(rows,
    layout)`` applied to a writable copy of the rows."""
    header, rect, tail = batch.split_chunks(enc)
    assert not tail
    lay = batch.full_chunk_layout(rect, header)
    rows = np.array(rect[:, : chunk_size or rect.shape[1]])
    if mutate is not None:
        mutate(rows, lay)
    header.chunk_size = rows.shape[1]
    return header.serialize() + rows.tobytes()


def _set_anchor(rows, size):
    rows[:, 1] = (rows[:, 1] & 0xF0) | size


_CORRUPT = {  # case -> (VBR, chunk_size(layout) or None, mutate or None, parse_full_chunks's text)
    "chunk_type": (False, None, lambda r, lay: r.__setitem__((0, 0), 7), "bad chunk type 0x7"),
    "heterogeneous": (True, None, lambda r, lay: r.__setitem__((2, 2), r[2, 2] ^ 1),
                      "heterogeneous chunk configs in one file"),
    "chunk_config": (False, None, lambda r, lay: r.__setitem__((slice(None), 1), r[:, 1] & 0x0F),
                     "bad chunk config"),
    "short_lms": (False, lambda lay: 20, None, "chunk too short for LMS state"),
    "short_scale_factors": (True, lambda lay: lay.sf_end - 1, None, "chunk too short for scale factors"),
    "short_vbr_sizes": (True, lambda lay: lay.res_off - 1, None, "chunk too short for vbr sizes"),
    "short_residuals": (False, lambda lay: lay.res_off + lay.res_width - 1, None, "chunk too short for residuals"),
    # anchor 1 and one row's deltas 0: sizes of 0 in that row
    "vbr_residual_size": (True, None, lambda r, lay: (_set_anchor(r, 1), r[1, lay.sf_end : lay.res_off].fill(0)),
                          "bad vbr residual size"),
    # anchor 6: sizes 5..8, more bits than the rows hold
    "vbr_table_overflow": (True, None, lambda r, lay: _set_anchor(r, 6), "chunk too short for residuals"),
}


@pytest.mark.parametrize("case", sorted(_CORRUPT))
def test_corpus_refuses_corrupt_full_chunks_as_the_host_parse_does(case):
    """A file whose full-chunk rows ``parse_full_chunks`` refuses: the
    corpus decode, which checks them on the host (the header and config) or
    on the card (a VBR size table), raises the same text, and with
    ``on_error="skip"`` gives None for that file and the JAX package's PCM
    for the others, on a device and over a mesh, in batches that mix the
    bad file's rows with the good files'."""
    vbr, size, mutate, text = _CORRUPT[case]
    base = _encode(2, 400, _st(vbr))
    header, rect, _tail = batch.split_chunks(base)
    bad = _rows_file(base, size and size(batch.full_chunk_layout(rect, header)), mutate)
    with pytest.raises(SeaInvalidFrame) as host:
        h, r, _t = batch.split_chunks(bad)
        batch.parse_full_chunks(r, h)
    assert str(host.value) == text
    files = [_encode(2, 437, _st(False)), base, bad, _encode(2, 530, _st(True)), _encode(2, 63, _st(True))]
    with pytest.raises(SeaInvalidFrame) as corpus:
        batch.decode_corpus(files, device_batch=3, device="cpu")
    assert str(corpus.value) == text
    want = j_batch.decode_corpus(files, on_error="skip")
    assert want[2] is None
    _assert_same(batch.decode_corpus(files, device_batch=3, on_error="skip", device="cpu"), want)
    mesh = pipeline.make_mesh(devices=[torch.device("cpu")] * 3)
    _assert_same(batch.decode_corpus(files, device_batch=3, on_error="skip", mesh=mesh), want)


@pytest.mark.parametrize("entries", [1, 4])
def test_corpus_parses_every_full_row_on_the_card(entries, monkeypatch):
    """The corpus decode never parses a full chunk on the host: with
    ``parse_full_chunks`` refusing every call, a CBR and VBR corpus with
    ragged tails, an exact-multiple file and tail-only files decodes to the
    JAX package's PCM on one device and over a 4-entry mesh, and
    ``decode_card_rows_count`` counts every full-chunk row."""
    encs = [_encode(2, 437, _st(False)), _encode(2, 530, _st(True)), _encode(2, 400, _st(False)),
            _encode(2, 63, _st(True)), _encode(2, 37, _st(False)), _encode(2, 700, _st(True))]
    n_rows = sum(r.shape[0] for _h, r, _t in map(batch.split_chunks, encs) if r is not None)
    want = j_batch.decode_corpus(encs)

    def refuse(*_a, **_k):
        raise AssertionError("a full chunk parsed on the host")

    monkeypatch.setattr(batch, "parse_full_chunks", refuse)
    batch.PIPELINE_TIMES = times = StageTimes()
    try:
        got = batch.decode_corpus(encs, device_batch=3, **_place(entries))
    finally:
        batch.PIPELINE_TIMES = None
    _assert_same(got, want)
    assert n_rows == 4 + 5 + 4 + 7
    assert times["decode_card_rows_count"] == n_rows
