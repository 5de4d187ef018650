"""The traffic generator: the same seed gives the same inputs, every seed
the same work, and the benchmark's writer writes files the port reads as
the reference does."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import tiny_cell
from seabench import spec, traffic


def make(cell, seed):
    return traffic.make(cell.config, cell.traffic, seed, "cpu", spec.entry_driver(cell.traffic["entry"]).inputs)


@pytest.mark.parametrize("name", ["cbr3-library-encode", "vbr3-library-decode", "cbr3-seek"])
def test_seed_fixes_inputs_not_work(name):
    cell = tiny_cell(name)
    a, b, c = make(cell, 2**31 + 11), make(cell, 2**31 + 11), make(cell, 2**33 + 5)
    same = lambda x, y: all(np.array_equal(p, q) for p, q in zip(x.pcm, y.pcm)) and x.files == y.files
    assert same(a, b) and not same(a, c)
    assert sorted(a.frames) == sorted(c.frames)
    if a.requests is not None:
        span = cell.traffic["range_frames"]
        assert (a.requests[:, 1] + span <= np.asarray(a.frames)[a.requests[:, 0]]).all()


@pytest.mark.parametrize("vbr", [False, True])
def test_written_files_decode_alike(vbr):
    from sea_codec_torch import batch

    cell = tiny_cell("vbr3-library-decode" if vbr else "cbr3-seek")
    cell.traffic = dict(cell.traffic, entry="decode_corpus", files=3, seconds=[0.05, 0.09])
    tr = make(cell, 12345)
    drv = spec.entry_driver("decode_corpus")(None, tr, "cpu", 12345)
    want = drv.reference_pcm()
    for blob, frames, w in zip(tr.files, tr.frames, want):
        header, _rect, _tail = batch.split_chunks(blob)
        assert header.total_frames == frames and header.chunk_size == tr.layout.chunk_bytes()
        assert np.array_equal(batch.decode_sea(blob, device="cpu").samples, w)
