"""``BENCHMARK.json`` and the files it names."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # benchmark/
ROOT = BENCH_DIR.parent  # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json, with "name"
    traffic: dict  # traffic/<traffic>.json, with "name"
    chips: int
    end_to_end: list  # the metrics of BENCHMARK.json's end_to_end this cell reports
    per_layer: list  # likewise of per_layer


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` with its configuration and traffic files read."""
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file.name}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(ROOT / configs[w["config"]]["file"]), name=w["config"])
    traffic = dict(load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"), name=w["traffic"])
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _load(folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module."""
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py for {name!r}")
    mod_name = f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_driver(entry: str):
    """The driver class (``Entry``) of ``benchmark/entries/<entry>.py``."""
    return _load("entries", entry).Entry


def metric_reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read``: of the run's driver for an
    end-to-end metric, of the traced window (``trace.Context``) for a
    per-layer one."""
    return _load("metrics", name).read
