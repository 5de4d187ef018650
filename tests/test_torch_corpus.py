"""``decode_range`` and ``decode_corpus`` of the PyTorch port
(``device="cpu"``) against the JAX package's functions: tail-only files, a
ragged mix, several configurations in one corpus, ``on_error="skip"``, the
wave drain, and both routings of the decode. Mirrors the JAX package's
tail-merge and batch tests. Integer codec: exact equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, batch, convert, sea_decode, sea_encode
from sea_codec_torch.ops import dequant, fused_decode
from sea_codec_torch.ops.device_decode import decode_chunks_packed
from sea_codec_torch.utils.errors import SeaInvalidFrame
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
    """A live-bytes bound below one batch drains after every launch."""
    st = _st(vbr)
    encs = [_encode(2, n, st) for n in [330, 250, 99, 401]]
    want = batch.decode_corpus(encs, device_batch=2, device="cpu")
    monkeypatch.setenv("SEA_DECODE_MAX_LIVE_BYTES", "1")
    drains = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: (drains.append(1), real(t, *a, **k))[1])
    got = batch.decode_corpus(encs, device_batch=2, device="cpu")
    monkeypatch.undo()
    _assert_same(got, want)
    assert len(drains) >= 5  # one copy per launched batch


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
        _h, _b, _fr, chunk, fpc = batch._stage_file_parsed(enc)
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
