"""One-shot transcode: WAV -> .sea -> WAV, with quality metrics.

The PyTorch port of ``examples/transcode.py``. Library-level analog of the
reference CLI example (seaconv, ``examples/seaconv.rs:151-225`` in the
reference): the installed CLI (``python -m sea_codec_torch in.wav out.sea
-b 3``) wraps exactly this flow.

Runs on the CUDA card (``--device cuda``, the default; without a card it
exits with an error) or on the CPU with the kernels' plain versions
(``--device cpu``).

Usage:
    python examples/torch/transcode.py [input.wav] [--bitrate 3] [--vbr] [--out out.wav]
        [--device cuda]

Without an input file, a synthetic multi-tone test signal is generated
(the reference's test strategy, ``tests/helpers.rs:79-93``). Without
``--out``, the decoded WAV goes to a new temporary file.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import sea_codec_torch as sea  # noqa: E402
from sea_codec_torch.utils.device import resolve_device  # noqa: E402
from sea_codec_torch.utils.signal import audio_quality, gen_test_signal  # noqa: E402
from sea_codec_torch.utils.wav import read_wav, write_wav  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", nargs="?", help="input WAV (default: synthetic signal)")
    p.add_argument("--bitrate", "-b", type=float, default=3.0)
    p.add_argument("--vbr", action="store_true")
    p.add_argument("--out", default=None, help="output WAV (default: a new temporary file)")
    p.add_argument("--frames", type=int, default=44100, help="synthetic length")
    p.add_argument("--fpc", type=int, default=5120, help="frames per chunk")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    device = resolve_device(args.device)  # no card: raises, never falls back to the CPU

    if args.input:
        wave = read_wav(args.input)
        samples, sample_rate, channels = wave.samples, wave.sample_rate, wave.channels
    else:
        sample_rate, channels = 44100, 2
        samples = gen_test_signal(channels, args.frames)

    settings = sea.EncoderSettings(
        residual_bits=args.bitrate, vbr=args.vbr, frames_per_chunk=args.fpc
    )
    encoded = sea.sea_encode(samples, sample_rate, channels, settings, device=device)
    decoded = sea.sea_decode(encoded, device=device)

    raw_bytes = samples.size * 2
    rms, psnr = audio_quality(samples, decoded.samples)
    print(f"input:   {samples.size} samples ({channels} ch @ {sample_rate} Hz)")
    print(f"encoded: {len(encoded)} bytes ({raw_bytes / len(encoded):.2f}x compression) on {device}")
    print(f"quality: rms {rms * 100:.3f}%  psnr {psnr:.1f} dB (lower is better)")

    out = args.out
    if out is None:
        fd, out = tempfile.mkstemp(prefix="transcode_out_", suffix=".wav")
        os.close(fd)
    write_wav(decoded.samples, decoded.channels, decoded.sample_rate, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
