"""Constant-time seeking: decode an arbitrary frame range in O(range).

The PyTorch port of ``examples/seek.py``. Every ``.sea`` chunk carries its
own LMS entry state (reference ``README.md:88-121``, ``chunk.rs:95-103``),
so decode can start at any chunk boundary without touching earlier bytes.
``decode_range`` reads only the chunks overlapping the requested range.

Runs on the CUDA card (``--device cuda``, the default; without a card it
exits with an error) or on the CPU with the kernels' plain versions
(``--device cpu``).

Usage:
    python examples/torch/seek.py [--frames 200000] [--start 123450] [--count 1000]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import sea_codec_torch as sea  # noqa: E402
from sea_codec_torch.batch import decode_range  # noqa: E402
from sea_codec_torch.utils.device import resolve_device  # noqa: E402
from sea_codec_torch.utils.signal import gen_test_signal  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=200000)
    p.add_argument("--start", type=int, default=123450)
    p.add_argument("--count", type=int, default=1000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    device = resolve_device(args.device)  # no card: raises, never falls back to the CPU

    channels, sample_rate = 2, 44100
    samples = gen_test_signal(channels, args.frames)
    encoded = sea.sea_encode(samples, sample_rate, channels, device=device)

    window = decode_range(encoded, args.start, args.count, device=device)

    # cross-check against the full decode
    full = sea.sea_decode(encoded, device=device).samples
    ref = full[args.start * channels : (args.start + args.count) * channels]
    assert np.array_equal(window, ref), "seek window != full-decode slice"
    print(f"decoded frames [{args.start}, {args.start + args.count}) of "
          f"{args.frames}: {window.size} samples, identical to the "
          f"full-decode slice, on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
