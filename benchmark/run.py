#!/usr/bin/env python3
"""Run one cell of the benchmark of ``sea_codec_torch`` and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the ``sea_codec_torch`` package, on a machine with the NVIDIA cards the
cell asks for. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown`` (that run profiles the first 10 s of its
window), and last ``checks``: each number the
correctness check compared, with its limit (also the last lines on standard
error). Exits 2 without the cards, 3 without the package and 4 if JAX or
the JAX package was loaded, printing no result.

The kernels build (``nvcc``) into ``build/sea_codec_torch`` inside the
checkout on its first run and load from there afterwards.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def process_start_perf() -> float:
    """This process's start on the ``perf_counter`` clock (Linux), so that
    set-up counts the interpreter's start and the imports."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def cache_env(root: Path) -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths."""
    build = root / "build"
    os.environ["SEA_TORCH_CACHE"] = str(build / "sea_codec_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    t_start = process_start_perf()
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_env(ROOT)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import json

    import torch

    from seabench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import sea_codec_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 3
    from seabench import harness

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, log=print)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"{name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
