"""The port's stage hooks on the CPU: the spans inside ``batch.decode_range``
and the corpus encode, the search-launch counter, ``StageTimes.count`` and
``report``, and the profiler ranges each stage opens (none when
``batch.PIPELINE_TIMES`` is None)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sea_codec_torch import EncoderSettings, batch
from sea_codec_torch.ops import window_search as ws
from sea_codec_torch.utils.profiling import StageTimes
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, varied_signal

torch.set_num_threads(1)

RANGE_STAGES = ("range_split", "range_parse", "range_decode")
ENCODE_STAGES = ("encode_search", "encode_pack")
CALL = "test.call"


@pytest.fixture
def installed():
    """Runs a function with a ``StageTimes`` (or the one given) installed in
    ``batch.PIPELINE_TIMES``, put back to None afterwards."""

    def run(fn, times=None):
        batch.PIPELINE_TIMES = times = StageTimes() if times is None else times
        try:
            return fn(), times
        finally:
            batch.PIPELINE_TIMES = None

    yield run
    batch.PIPELINE_TIMES = None


@pytest.fixture
def counting_search(monkeypatch):
    """The plain search counts a launch per call, as the kernel's launcher
    does on the card."""
    plain = ws.window_search_plain

    def counted(*args, **kw):
        ws.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(ws, "window_search_plain", counted)


def _sea(vbr: bool = False, frames: int = 437) -> bytes:
    st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    return batch.encode_sea(varied_signal(2, frames, seed=frames), TEST_SAMPLE_RATE, 2, st, device="cpu")


def _files():
    return [varied_signal(2, n, seed=30 + i) for i, n in enumerate([437, 250, 99, 0])]


def _profiled(fn):
    """``fn()`` under a CPU profiler, inside a range named ``CALL``; returns
    its result and the profiler's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            out = fn()
    return out, prof.events()


def _inside_call(event) -> bool:
    parent = event.cpu_parent
    while parent is not None:
        if parent.name == CALL:
            return True
        parent = parent.cpu_parent
    return False


@pytest.mark.parametrize("vbr", [False, True])
@pytest.mark.parametrize("start,n", [(150, 100), (380, 50), (0, 437)])
def test_decode_range_records_its_stages(vbr, start, n, installed):
    """With a ``StageTimes`` installed, ``decode_range`` records its split,
    parse and decode stages (a range that reaches the tail chunk too), and
    returns the same samples as with none installed."""
    enc = _sea(vbr)
    want = batch.decode_range(enc, start, n, device="cpu")
    got, times = installed(lambda: batch.decode_range(enc, start, n, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert set(times) == set(RANGE_STAGES)
    assert all(times[k] > 0 for k in RANGE_STAGES)


@pytest.mark.parametrize("vbr", [False, True])
def test_encode_corpus_records_search_pack_and_launches(vbr, installed, counting_search):
    """The corpus encode records ``encode_search`` (and for VBR
    ``encode_pack``, the enqueue of each slab's row serializer) with its
    bytes unchanged, ``encode_search_launches_count`` equal to the change in
    the search's launch counter: one launch for CBR, two a chunk index and
    two for the tails for VBR; and for VBR alone
    ``encode_serialize_launches_count``, the row kernel's launches, which
    on the CPU (the plain version) stay at 0."""
    st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    files = _files()
    want = batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu")
    before = ws.launches
    got, times = installed(lambda: batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu"))
    assert got == want
    assert times["encode_search"] > 0
    assert ("encode_pack" in times) == vbr and times.get("encode_pack", 1) > 0
    n = times["encode_search_launches_count"]
    assert type(n) is int and n == ws.launches - before == (2 * 4 + 2 if vbr else 1)
    assert ("encode_serialize_launches_count" in times) == vbr
    if vbr:
        rows = times["encode_serialize_launches_count"]
        assert type(rows) is int and rows == 0


@pytest.mark.parametrize("vbr", [False, True])
def test_encode_corpus_counts_the_lanes_of_each_launch(vbr, installed, monkeypatch):
    """``encode_search_lanes_count`` is the lanes of every search launch of
    the call, summed (CBR: one launch over 4 files x 2 channels; VBR: two a
    chunk index over those 8 lanes, then two over the 3 tails' 6), so that
    over ``encode_search_launches_count`` it reads the lanes a launch
    covers. With ``PIPELINE_TIMES`` at None a call records nothing, and a
    later call's count holds that call's lanes alone."""
    plain = ws.window_search_plain
    lanes = []

    def counted(samples, *args, **kw):
        ws.launches += 1
        ws.lanes += samples.shape[1]
        lanes.append(samples.shape[1])
        return plain(samples, *args, **kw)

    monkeypatch.setattr(ws, "window_search_plain", counted)
    st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    files = _files()
    assert batch.PIPELINE_TIMES is None
    want = batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu")
    assert sum(lanes) > 0
    del lanes[:]
    got, times = installed(lambda: batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu"))
    assert got == want
    assert lanes == ([8] * 8 + [6] * 2 if vbr else [8])
    n = times["encode_search_lanes_count"]
    assert type(n) is int and n == sum(lanes)
    assert times["encode_search_launches_count"] == len(lanes)


def test_launch_count_recorded_when_nothing_launches(installed):
    """On the CPU the kernel's launch counter does not move: the count is
    still recorded, as 0."""
    st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5, vbr=True)
    _out, times = installed(lambda: batch.encode_corpus(_files(), TEST_SAMPLE_RATE, 2, st, device="cpu"))
    assert times["encode_search_launches_count"] == 0
    assert times["encode_search_lanes_count"] == 0


def test_count_does_not_go_through_add(installed, counting_search):
    """A subclass that keeps an interval for each ``add``, as the
    benchmark's does, sees no ``add`` for a count; a count's name must end
    in ``_count``."""

    class Intervals(StageTimes):
        def __init__(self):
            super().__init__()
            self.added = []

        def add(self, name, seconds):
            super().add(name, seconds)
            self.added.append(name)

    st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5, vbr=True)
    _out, times = installed(lambda: batch.encode_corpus(_files(), TEST_SAMPLE_RATE, 2, st, device="cpu"),
                            Intervals())
    times.count("extra_count", 3)
    assert times["encode_search_launches_count"] == 10 and times["extra_count"] == 3
    assert "encode_search" in times.added and "encode_pack" in times.added
    assert not [k for k in times.added if k.endswith("_count")]
    with pytest.raises(ValueError):
        times.count("encode_search", 1)


def test_report_keeps_counts_out_of_the_time_total():
    times = StageTimes()
    times.add("a", 0.25)
    times.add("b", 0.5)
    times.add("x_bytes", 2e6)
    times.count("launches_count", 5000)
    times.count("launches_count", 7)
    report = times.report()
    total = next(line for line in report.splitlines() if line.split(":")[0].strip() == "total")
    assert "750.00 ms" in total
    assert any(line.split() == ["launches_count:", "5007"] for line in report.splitlines())
    assert "( 33.3%)" in report and "2.0 MB" in report


@pytest.mark.parametrize("what", ["range", "encode"])
def test_stages_are_profiler_ranges_inside_the_call(what, installed, counting_search):
    """Under a CPU profiler, each stage is an event of its own name nested
    inside the caller's range, and the events of a name last as long as
    the stage's seconds, to within 1 ms plus 20%."""
    if what == "range":
        enc = _sea(True)
        fn, names = (lambda: batch.decode_range(enc, 380, 50, device="cpu")), RANGE_STAGES
    else:
        st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5, vbr=True)
        files = _files()
        fn, names = (lambda: batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu")), ENCODE_STAGES
    (_out, events), times = installed(lambda: _profiled(fn))
    for name in names:
        mine = [e for e in events if e.name == name]
        assert mine, name
        assert all(_inside_call(e) for e in mine), name
        seconds = sum(e.time_range.elapsed_us() for e in mine) / 1e6
        assert abs(seconds - times[name]) <= 1e-3 + 0.2 * times[name], (name, seconds, times[name])


@pytest.mark.parametrize("what", ["range", "encode"])
def test_no_ranges_without_stage_times(what, counting_search):
    """With ``PIPELINE_TIMES`` at None, the port opens no profiler range
    and records nothing."""
    assert batch.PIPELINE_TIMES is None
    if what == "range":
        enc = _sea(True)
        fn = lambda: batch.decode_range(enc, 380, 50, device="cpu")  # noqa: E731
    else:
        st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5, vbr=True)
        files = _files()
        fn = lambda: batch.encode_corpus(files, TEST_SAMPLE_RATE, 2, st, device="cpu")  # noqa: E731
    _out, events = _profiled(fn)
    stages = set(RANGE_STAGES + ENCODE_STAGES) | {"encode_stage", "encode_put", "encode_fetch", "encode_assemble"}
    assert not [e.name for e in events if e.name in stages]
    assert any(e.name == CALL for e in events)
