"""The per-cell tests of ``test_bench_harness.py`` on the encode cells that
came after its list, at their cut CPU sizes: the 64-channel CBR and VBR
encodes (``cbr3-mc64-multitrack-encode``, ``vbr3-mc64-multitrack-encode``);
and the VBR chunk loop's ranking stage that ``encode_corpus.rank_ms.vbr``
reads.

``conftest.tiny_cell`` cuts a cell to two files of 0.05-0.08 s, shorter
than the 0.63 s by which the traffic delays the last of 64 channels (10 ms
a channel), so a cell of more than two channels is cut here to two files
of 0.65 and 0.67 s, at a tenth of its sample rate so that they hold as
few frames as the CPU runs in seconds (3,120 and 3,216: 15 and 16 chunks
of 200 frames and a tail each)."""

from __future__ import annotations

import json
import time

import pytest

import test_bench_harness as harness_tests
from conftest import ROOT, tiny_cell

ADDED = ["cbr3-mc64-multitrack-encode", "vbr3-mc64-multitrack-encode"]


def run_cut(name: str, seed: int = 2**31 + 7, traced: bool = False, control: bool = False, seconds=0.3, **cell):
    """``conftest.run_tiny``, with the cut above for many channels."""
    from seabench import harness, spec

    config = cell.get("config") or spec.load_cell(name).config["name"]
    c = tiny_cell(name, **cell)
    if spec.load_json(ROOT / "benchmark" / "configs" / f"{config}.json")["channels"] > 2:
        c.config["sample_rate"] //= 10
        c.traffic["seconds"] = [0.64, 0.68]
    quiet = lambda *a, **k: None  # noqa: E731
    return harness.run_cell(c, seed, seconds, traced, "cpu", time.perf_counter(), control=control, log=quiet)


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def cut(monkeypatch):
    monkeypatch.setattr(harness_tests, "run_tiny", run_cut)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", ADDED)
def test_result_line(name, traced, bench, cut):
    harness_tests.test_result_line(name, traced, bench)


@pytest.mark.parametrize("name", ADDED)
def test_a_new_cell_needs_data_only(name, bench):
    """Each added cell's pair of configuration and mix runs and is checked
    from its files alone, in another cell's place."""
    w = {w["name"]: w for w in bench["workloads"]}[name]
    out = run_cut("cbr3-seek", config=w["config"], traffic=w["traffic"])
    assert out["correct"] is True and out["attempted"] > 0, out["checks"]


@pytest.mark.parametrize("name", ADDED)
def test_check_refuses_the_control(name, cut):
    harness_tests.test_check_refuses_the_control(name)


def test_vbr_encode_reads_the_rank_stage():
    """The 64-channel VBR cell reads the ranking's host time a call; the
    CBR one reports no such metric."""
    rank = run_cut("vbr3-mc64-multitrack-encode", traced=True)["metrics"]["encode_corpus.rank_ms.vbr"]
    assert rank["unit"] == "ms" and rank["value"] > 0
    assert "encode_corpus.rank_ms.vbr" not in run_cut("cbr3-mc64-multitrack-encode", traced=True)["metrics"]
