"""Metadata: store and read UTF-8 key=value pairs in the .sea header.

The PyTorch port of ``examples/metadata.py``. The format reserves
``metadata_size`` + bytes in the header (reference ``README.md:71-84``,
``file.rs:40-93``). Note the compatibility quirk documented in
``container.py``: the reference's *parser* never consumes the metadata
bytes (``file.rs:53-55``), so reference-produced files always carry empty
metadata; this implementation follows the written spec and round-trips it.

Runs on the CUDA card (``--device cuda``, the default; without a card it
exits with an error) or on the CPU with the kernels' plain versions
(``--device cpu``).

Usage:
    python examples/torch/metadata.py [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import sea_codec_torch as sea  # noqa: E402
from sea_codec_torch.container import SeaFileHeader  # noqa: E402
from sea_codec_torch.utils.device import resolve_device  # noqa: E402
from sea_codec_torch.utils.signal import gen_test_signal  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    device = resolve_device(args.device)  # no card: raises, never falls back to the CPU

    channels, sample_rate = 2, 44100
    samples = gen_test_signal(channels, 8000)

    # the structured helpers enforce the spec's key rules (README.md:73-77)
    meta = sea.format_metadata({"title": "Example", "artist": "sea-codec-tpu"})
    settings = sea.EncoderSettings(metadata=meta)
    encoded = sea.sea_encode(samples, sample_rate, channels, settings, device=device)

    header = SeaFileHeader.from_reader(io.BytesIO(encoded))
    assert header.metadata == meta
    pairs = sea.parse_metadata(header.metadata)
    assert sea.lookup_metadata(pairs, "ARTIST") == "sea-codec-tpu"  # keys fold
    print(f"header metadata ({len(meta)} bytes): {pairs}")

    decoded = sea.sea_decode(encoded, device=device)
    assert decoded.samples.size == samples.size
    print(f"decode still sample-exact alongside metadata: "
          f"{decoded.samples.size} samples on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
