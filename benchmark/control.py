#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference in the
program's place, in the lower precision that the check must refuse.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--seconds 10]

For each seed, in one process: the cell's set-up and a short window of the
program at the cell's own load (so that the check reads as many answers as
a run does), then the check with the answers it reads replaced by the
reference's, computed with a float32 LMS prediction (and, in the encoder's
search, a float32 division and rank; ``reference.codec``). Prints each
seed's compared numbers and whether the check refused it: every seed must
read ``correct`` false. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import run

    run.cache_env(ROOT)
    import torch

    from seabench import harness, spec

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    refused = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(), control=True)
        refused.append(not out["correct"])
        print(json.dumps({"workload": cell.name, "seed": seed, "control_refused": not out["correct"],
                          "checks": out["checks"]}), flush=True)
    print(f"control refused on {sum(refused)} of {len(refused)} seeds")
    return 0 if all(refused) else 1


if __name__ == "__main__":
    sys.exit(main())
