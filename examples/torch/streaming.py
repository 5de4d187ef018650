"""Streaming sessions: encode and decode concurrently over a byte pipe.

The PyTorch port of ``examples/streaming.py``. Every chunk is
self-contained, so the decoder can consume the stream as it is produced --
the reference proves the same property with its interleaved
encoder/decoder test (``tests/streaming.rs:51-97``); the
session APIs mirror ``src/encoder.rs:50-159`` / ``src/decoder.rs:22-72``.

Streaming mode: passing ``total_frames=None`` records 0 ("unknown") in the
header and the decoder reads until EOF. (Passing an explicit ``0`` instead
writes the header upfront before the first chunk is sized -- a
write-side-only mode, reference ``encoder.rs:70-77``.)

Runs on the CUDA card (``--device cuda``, the default; without a card it
exits with an error) or on the CPU with the kernels' plain versions
(``--device cpu``).

Usage:
    python examples/torch/streaming.py [--frames 50000] [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sea_codec_torch import (  # noqa: E402
    EncoderSettings,
    SeaDecoder,
    SeaEncoder,
    SeaError,
    sea_decode,
    sea_encode,
)
from sea_codec_torch.utils.device import resolve_device  # noqa: E402
from sea_codec_torch.utils.signal import gen_test_signal  # noqa: E402


class Pipe:
    """Writes append; reads drain from the front (streaming.rs:18-49)."""

    def __init__(self):
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf += data
        return len(data)

    def read(self, n: int) -> bytes:
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def flush(self):
        pass


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=50000)
    p.add_argument("--fpc", type=int, default=5120)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    device = resolve_device(args.device)  # no card: raises, never falls back to the CPU

    channels, sample_rate = 2, 44100
    samples = gen_test_signal(channels, args.frames)
    settings = EncoderSettings(residual_bits=3.0, frames_per_chunk=args.fpc)

    pipe = Pipe()
    pcm_out = io.BytesIO()
    source = io.BytesIO(samples.astype("<i2").tobytes())

    enc = SeaEncoder(channels, sample_rate, None, settings, source, pipe, device)
    chunks = 0
    assert enc.encode_frame()  # header + first chunk are now in the pipe
    dec = SeaDecoder(pipe, pcm_out, device)
    more = True
    while more:
        more = enc.encode_frame()
        dec.decode_frame()
        chunks += 1
    enc.finalize()
    # drain remaining full chunks; a short final chunk cannot be sized in
    # streaming mode (reference chunk.rs:76-79) and ends the stream
    while True:
        try:
            if not dec.decode_frame():
                break
        except SeaError:
            break
    dec.finalize()

    streamed = np.frombuffer(pcm_out.getvalue(), dtype="<i2")
    batch = sea_decode(
        sea_encode(samples, sample_rate, channels, settings, device=device), device=device
    ).samples
    n = min(streamed.size, batch.size)
    assert np.array_equal(streamed[:n], batch[:n]), "streamed != batch decode"
    print(f"streamed {chunks} chunks, {streamed.size} samples on {device}; "
          f"prefix identical to the batch round trip")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
