"""``seaconv``-compatible CLI on the PyTorch port (reference
``examples/seaconv.rs``).

Converts between ``.wav`` and ``.sea`` with the same flags, defaults,
validation ranges, error messages and exit codes as the reference binary
and the JAX package's ``seaconv``:

    python -m sea_codec_torch input.wav output.sea [-c N] [-b BITRATE] [-s BITS] [-d DIST] [-v]
    python -m sea_codec_torch input.sea output.wav

Extensions beyond the reference, as in the JAX package: ``--metadata
key=value`` (repeatable) embeds metadata in the header, and ``--stats``
prints per-file statistics.

Two flags differ from the JAX package's CLI:

- ``--device {cuda,cpu}`` (default ``cuda``) stands where the JAX package
  reads ``JAX_PLATFORMS``. Without a card the CLI exits with an error
  unless given ``--device cpu``; it never falls back to the CPU on its own.
- ``--backend {auto,torch,native}``: ``auto`` and ``torch`` run the port's
  pipeline (encode through ``batch.encode_sea``, the corpus encode of one
  file, decode through ``batch.decode_sea``) on ``--device``; ``native``
  runs the C++ host codec (``native.native_encode``/``native_decode``) on
  the host, as the JAX package's ``native`` does, and ``--device`` does
  not apply to it. The JAX package's ``jax`` backend is not offered.
"""

from __future__ import annotations

import argparse
import sys


def _die(msg: str) -> None:
    print(f"Error: {msg}", file=sys.stderr)
    sys.exit(1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="seaconv", description="Converts between .wav and .sea files"
    )
    p.add_argument("input", help="The input file in LPCM LE .wav or .sea format")
    p.add_argument("output", help="The output file to save the conversion result (.sea or .wav)")
    p.add_argument("-c", "--chunk-size", default="5120", help="Sets the number of frames within a chunk")
    p.add_argument("-b", "--bitrate", default="3", help="Sets the bitrate for the conversion")
    p.add_argument("-s", "--scalefactor-bits", default="4", help="Sets the bitrate for scale factors")
    p.add_argument("-d", "--scalefactor-distance", default="20", help="Sets the distance between scale factors in frames")
    p.add_argument("-v", "--vbr", action="store_true", help="Enables Variable Bit Rate (VBR)")
    p.add_argument("--metadata", action="append", default=[], metavar="KEY=VALUE", help="Embed a metadata key=value pair (repeatable)")
    p.add_argument("--stats", action="store_true", help="Print encode/decode statistics")
    p.add_argument("--backend", choices=["auto", "torch", "native"], default="auto",
                   help="Codec backend: the PyTorch pipeline, or the native C++ host codec")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Run the PyTorch pipeline on the CUDA card (default) or, when asked, on "
                        "the CPU; the native backend runs on the host")
    return p


def get_encoder_settings(args) -> "EncoderSettings":
    """Validation identical to the reference (seaconv.rs:13-92)."""
    from .encoder import EncoderSettings

    try:
        frames_per_chunk = int(args.chunk_size)
    except ValueError:
        _die("Failed to parse chunk size")
    if frames_per_chunk < 200 or frames_per_chunk > 32000:
        _die("Chunk size must be between 200 and 32000")

    try:
        scale_factor_bits = int(args.scalefactor_bits)
    except ValueError:
        _die("Failed to parse scale factor bits")
    if scale_factor_bits < 3 or scale_factor_bits > 5:
        _die("Scale factor bits must be between 3 and 5")

    try:
        scale_factor_frames = int(args.scalefactor_distance)
        if not 0 <= scale_factor_frames <= 255:  # reference parses a u8
            raise ValueError
    except ValueError:
        _die("Failed to parse scale factor frames")
    if scale_factor_frames < 1 or frames_per_chunk % scale_factor_frames != 0:
        _die("Scale factor frames must be a divisor of chunk size")

    try:
        residual_bits = float(args.bitrate)
    except ValueError:
        _die("Failed to parse residual bits")
    if residual_bits < 1.0 or residual_bits > 8.0:
        _die("Bitrate must be between 1.0 and 8.0")

    if args.vbr:
        if not (1.5 <= residual_bits <= 8.0):
            _die("With VBR, bitrate must be between 1.5 and 8.0")
    else:
        if residual_bits != int(residual_bits) or not (1 <= int(residual_bits) <= 8):
            _die("Without VBR, bitrate must be an integer between 1 and 8")

    from .utils.errors import SeaError
    from .utils.metadata import format_metadata

    pairs: dict[str, str] = {}
    folded: set[str] = set()
    for pair in args.metadata:
        key, sep, value = pair.partition("=")
        if not sep:
            _die(f"Invalid metadata pair (expected key=value): {pair}")
        # exact duplicates would collapse in the dict and case-differing ones
        # die inside format_metadata: report both here, the same way
        if key.casefold() in folded:
            _die(f"Duplicate metadata key: {key} (keys compare case-insensitively)")
        folded.add(key.casefold())
        pairs[key] = value
    try:
        metadata = format_metadata(pairs)
    except SeaError as e:
        _die(str(e))

    return EncoderSettings(
        scale_factor_bits=scale_factor_bits,
        scale_factor_frames=scale_factor_frames,
        residual_bits=residual_bits,
        vbr=args.vbr,
        frames_per_chunk=frames_per_chunk,
        metadata=metadata,
    )


def get_device(args):
    """``args.device`` resolved by ``utils.device.resolve_device``; dies
    with its message when the card is asked for and there is none."""
    from .utils.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        _die(str(e))


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    settings = get_encoder_settings(args)

    in_ext = args.input.rsplit(".", 1)[-1].lower() if "." in args.input else ""
    out_ext = args.output.rsplit(".", 1)[-1].lower() if "." in args.output else ""
    if (in_ext, out_ext) not in (("wav", "sea"), ("sea", "wav")):
        _die(
            "Invalid file extensions. Supported conversions are .wav to .sea and .sea to .wav"
        )
    native = args.backend == "native"
    device = None if native else get_device(args)

    import time

    if in_ext == "wav":
        from .batch import encode_sea
        from .utils.wav import read_wav

        try:
            wave = read_wav(args.input)
        except (OSError, ValueError):
            _die("Failed to decode .wav file")
        t0 = time.perf_counter()
        if native:
            from .native import native_encode

            encoded = native_encode(
                wave.samples, wave.sample_rate, wave.channels,
                scale_factor_bits=settings.scale_factor_bits,
                scale_factor_frames=settings.scale_factor_frames,
                residual_bits=settings.residual_bits,
                frames_per_chunk=settings.frames_per_chunk,
                vbr=settings.vbr, metadata=settings.metadata,
            )
        else:
            encoded = encode_sea(wave.samples, wave.sample_rate, wave.channels, settings, device=device)
        elapsed = time.perf_counter() - t0
        try:
            with open(args.output, "wb") as f:
                f.write(encoded)
        except OSError:
            _die("Failed to create output file")
        out_size = len(encoded)
        if args.stats:
            n = wave.samples.shape[0]
            print(
                f"encoded {n} samples -> {out_size} bytes "
                f"({2 * n / max(out_size, 1):.2f}x, {8 * out_size / max(n, 1):.2f} bps) "
                f"in {elapsed * 1e3:.1f} ms ({n / max(elapsed, 1e-9) / 1e6:.1f} Msamples/s)"
            )
    else:
        import io

        from .batch import decode_sea
        from .container import SeaFileHeader
        from .utils.errors import SeaError
        from .utils.wav import write_wav

        try:
            with open(args.input, "rb") as f:
                data = f.read()
        except OSError:
            _die("Failed to open input file")
        t0 = time.perf_counter()
        if native:
            from .native import native_decode

            try:
                samples, sample_rate, channels = native_decode(data)
            except ValueError:
                _die("Failed to decode frame")
        else:
            try:
                info = decode_sea(data, device=device)
            except SeaError:
                _die("Failed to decode frame")
            samples, sample_rate, channels = info.samples, info.sample_rate, info.channels
        elapsed = time.perf_counter() - t0
        header = SeaFileHeader.from_reader(io.BytesIO(data))
        write_wav(samples, channels, sample_rate, args.output)
        if args.stats:
            n = samples.shape[0]
            print(
                f"decoded {n} samples in {elapsed * 1e3:.1f} ms "
                f"({n / max(elapsed, 1e-9) / 1e6:.1f} Msamples/s)"
            )
            if header.metadata:
                from .utils.metadata import parse_metadata

                pairs = parse_metadata(header.metadata)
                n_lines = sum(1 for ln in header.metadata.split("\n") if ln)
                for k, v in pairs.items():
                    print(f"metadata: {k}={v}")
                if len(pairs) < n_lines:
                    # the lenient parse dropped malformed or duplicate lines
                    # (or the writer was unstructured): show the raw bytes
                    # too, so that nothing is hidden
                    print(f"metadata (raw): {header.metadata!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
