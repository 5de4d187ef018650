"""``batch.split_chunks`` of the PyTorch port takes views of the caller's
buffer and copies no more than the tail chunk: its full-chunk rows share
memory with the encoded bytes, its answer equals the JAX package's, and
``decode_range``'s host memory does not grow with the file's length."""

from __future__ import annotations

import dataclasses
import tracemalloc

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, batch, sea_encode
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, varied_signal
from sea_codec_tpu import batch as j_batch

torch.set_num_threads(1)

FPC = 100
CHANNELS = 2
# frames of each kind of file, at FPC frames a chunk; "streaming" is the
# ragged file with its header's frame count rewritten to 0 (unknown)
FILES = {"exact-multiple": 300, "ragged-tail": 437, "tail-only": 63, "streaming": 437}
KINDS = list(FILES)


def _encode(frames: int, vbr: bool) -> bytes:
    st = EncoderSettings(residual_bits=2.5 if vbr else 3.0, frames_per_chunk=FPC, vbr=vbr)
    sig = varied_signal(CHANNELS, frames, seed=frames)
    return sea_encode(sig, TEST_SAMPLE_RATE, CHANNELS, st, device="cpu")


def _with_total_frames(encoded: bytes, total: int) -> bytes:
    """The same file with the header's frame count (bytes 14-18) rewritten."""
    return encoded[:14] + total.to_bytes(4, "little") + encoded[18:]


def _file(kind: str, vbr: bool) -> bytes:
    enc = _encode(FILES[kind], vbr)
    return _with_total_frames(enc, 0) if kind == "streaming" else enc


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("vbr", [False, True], ids=["cbr", "vbr"])
def test_split_rect_shares_the_callers_buffer(vbr, kind):
    enc = _file(kind, vbr)
    header, rect, _tail = batch.split_chunks(enc)
    if kind == "tail-only":
        assert rect is None
        return
    assert rect.shape[1] == header.chunk_size
    assert np.shares_memory(rect, np.frombuffer(enc, np.uint8))
    assert not rect.flags.writeable


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("vbr", [False, True], ids=["cbr", "vbr"])
def test_split_tail_is_bytes_and_empty_without_a_tail(vbr, kind):
    enc = _file(kind, vbr)
    header, rect, tail = batch.split_chunks(enc)
    assert type(tail) is bytes
    n_full = rect.shape[0] if rect is not None else 0
    if kind in ("exact-multiple", "streaming"):
        assert tail == b""
    else:
        assert 0 < len(tail) <= header.chunk_size
        assert tail == enc[header.serialized_len + n_full * header.chunk_size:]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("vbr", [False, True], ids=["cbr", "vbr"])
def test_split_matches_jax(vbr, kind):
    enc = _file(kind, vbr)
    header, rect, tail = batch.split_chunks(enc)
    j_header, j_rect, j_tail = j_batch.split_chunks(enc)
    assert dataclasses.asdict(header) == dataclasses.asdict(j_header)
    assert (rect is None) == (j_rect is None)
    if rect is not None:
        assert rect.dtype == j_rect.dtype == np.uint8
        np.testing.assert_array_equal(rect, j_rect)
    assert tail == j_tail


BAD = ["empty", "short-header", "bad-magic", "short-metadata-size", "short-metadata", "no-channels"]


def _bad_input(name: str) -> bytes:
    enc = _encode(300, False)
    meta_size = (1 << 20).to_bytes(4, "little")
    return {
        "empty": b"",
        "short-header": enc[:10],
        "bad-magic": b"XXXX" + enc[4:],
        "short-metadata-size": enc[:20],
        "short-metadata": enc[:18] + meta_size + enc[22:40],
        "no-channels": enc[:5] + b"\0" + enc[6:],
    }[name]


@pytest.mark.parametrize("name", BAD)
def test_split_rejects_what_jax_rejects(name):
    """Each malformed header raises the same error, with the same text."""
    blob = _bad_input(name)
    with pytest.raises(Exception) as got:
        batch.split_chunks(blob)
    with pytest.raises(Exception) as want:
        j_batch.split_chunks(blob)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def _long_file(small: bytes, n_chunks: int) -> bytes:
    """``n_chunks`` full chunks made by repeating ``small``'s (each chunk is
    self-contained: it carries its own LMS entry state)."""
    header, rect, _tail = batch.split_chunks(small)
    reps = -(-n_chunks // rect.shape[0])
    rows = np.tile(rect, (reps, 1))[:n_chunks]
    head = _with_total_frames(small[: header.serialized_len], n_chunks * FPC)
    return head + rows.tobytes()


def _peak_bytes(fn) -> int:
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        fn()
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


@pytest.mark.parametrize("vbr", [False, True], ids=["cbr", "vbr"])
def test_decode_range_memory_does_not_grow_with_the_file(vbr):
    """The same range of a 20-chunk and of a 2,000-chunk file: the host's
    peak allocation differs by far less than one copy of the longer file."""
    small = _encode(20 * FPC, vbr)
    short, long = _long_file(small, 20), _long_file(small, 2000)
    start, count = 3 * FPC + 17, 2 * FPC + 40  # inside a chunk, across three
    want = batch.decode_range(short, start, count, device="cpu")  # warm every cache
    np.testing.assert_array_equal(batch.decode_range(long, start, count, device="cpu"), want)

    peaks = {}
    for name, blob in (("short", short), ("long", long)):
        peaks[name] = _peak_bytes(lambda: batch.decode_range(blob, start, count, device="cpu"))
    growth = len(long) - len(short)
    assert peaks["long"] - peaks["short"] < growth // 10, (peaks, growth)
