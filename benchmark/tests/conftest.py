"""Tests of the benchmark harness (``benchmark/``). Run from the checkout's
root: ``python -m pytest benchmark/tests -q``. Tests marked ``card`` need an
NVIDIA card and skip without one; the rest run on the CPU at tiny sizes."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def tiny_cell(name: str, fpc: int = 200, config: str | None = None, traffic: str | None = None,
              chips: int | None = None):
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds:
    chunks of ``fpc`` frames, two short files. ``config``, ``traffic`` and
    ``chips`` put another configuration file, mix file or card count in
    the cell's place, as a cell that a later entry in BENCHMARK.json adds."""
    from seabench import spec

    cell = spec.load_cell(name)
    if config is not None:
        cell.config = dict(spec.load_json(BENCH / "configs" / f"{config}.json"), name=config)
    if traffic is not None:
        cell.traffic = dict(spec.load_json(BENCH / "traffic" / f"{traffic}.json"), name=traffic)
    if chips is not None:
        cell.chips = chips
    cell.config = copy.deepcopy(cell.config)
    cell.config["settings"]["frames_per_chunk"] = fpc
    t = dict(cell.traffic)
    if t["entry"] == "decode_range":
        t.update(files=2, seconds=[0.1, 0.1], range_frames=500)
    else:
        t.update(files=2, seconds=[0.05, 0.08])
    cell.traffic = t
    return cell


def run_tiny(name: str, seed: int = 2**31 + 7, traced: bool = False, control: bool = False, seconds=0.3,
             **cell):
    from seabench import harness

    quiet = lambda *a, **k: None
    return harness.run_cell(tiny_cell(name, **cell), seed, seconds, traced, "cpu", time.perf_counter(),
                            control=control, log=quiet)
