"""Corpus batch transcoder on the PyTorch port: many WAV -> .sea (or .sea
-> WAV) in one run.

    python -m sea_codec_torch.batch_cli 'audio/*.wav' out/ -b 3 [-v] [flags]
    python -m sea_codec_torch.batch_cli 'encoded/*.sea' out/

Files are encoded through the lane-packed corpus encode (channels of many
files share the search's launches, ``batch.encode_corpus``) and decoded
through the batched corpus decode (``batch.decode_corpus``). Per-file
failures are reported and skipped. The flags are ``cli``'s, ``--device``
included, plus:

- ``--mesh``: spread the corpus over a mesh of every local CUDA device
  (``parallel.pipeline.make_mesh``); with ``--device cpu`` the mesh has one
  entry, the CPU;
- ``--distributed``: a multi-process run: join the process group
  (``parallel.distributed.initialize``, from torchrun's environment or from
  ``--coordinator HOST:PORT --num-processes N --process-id I``), take this
  process's share of the files (``shard_files_across_hosts``), and spread
  it over a mesh of the local devices.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from .cli import build_parser, get_device, get_encoder_settings


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    parser.prog = "sea-batch"
    parser.usage = "%(prog)s INPUT_GLOB OUTPUT_DIR [options]"
    parser.add_argument(
        "--mesh",
        action="store_true",
        help="shard the corpus over all local devices (parallel.pipeline.Mesh)",
    )
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="multi-process run: join the torch.distributed process group, "
        "shard files across processes, mesh over local devices",
    )
    parser.add_argument(
        "--coordinator",
        default=None,
        metavar="HOST:PORT",
        help="with --distributed: the address of process 0, for a cluster "
        "not described by torchrun's environment (requires --num-processes "
        "and --process-id)",
    )
    parser.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    settings = get_encoder_settings(args)
    device = get_device(args)

    paths = sorted(glob.glob(args.input))
    if not paths:
        print(f"Error: no files match {args.input!r}", file=sys.stderr)
        return 1

    mesh = None
    if args.distributed or args.mesh:
        from .parallel.pipeline import make_mesh

        if args.distributed:
            from .parallel.distributed import initialize, shard_files_across_hosts

            initialize(args.coordinator, args.num_processes, args.process_id)
            mine = shard_files_across_hosts(len(paths))
            paths = [paths[i] for i in mine]
        mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
        device = None
    outdir = args.output
    os.makedirs(outdir, exist_ok=True)

    from .batch import _pt

    exts = {os.path.splitext(p)[1].lower() for p in paths}
    if exts == {".wav"}:
        from .batch import encode_corpus
        from .utils.wav import read_wav

        waves, names = [], []
        by_config: dict[tuple[int, int], list[int]] = {}
        with _pt("wav_read"):
            for p in paths:
                try:
                    w = read_wav(p)
                except (OSError, ValueError) as e:
                    print(f"skip {p}: {e}", file=sys.stderr)
                    continue
                by_config.setdefault((w.channels, w.sample_rate), []).append(len(waves))
                waves.append(w)
                names.append(os.path.splitext(os.path.basename(p))[0])
        t0 = time.perf_counter()
        total = 0
        for (channels, rate), idxs in by_config.items():
            with _pt("encode_wall"):
                encoded = encode_corpus(
                    [waves[i].samples for i in idxs], rate, channels, settings,
                    device=device, mesh=mesh,
                )
            with _pt("sea_write"):
                for i, enc in zip(idxs, encoded):
                    with open(os.path.join(outdir, names[i] + ".sea"), "wb") as f:
                        f.write(enc)
                    total += waves[i].samples.shape[0]
        dt = time.perf_counter() - t0
        print(
            f"encoded {len(waves)} files / {total} samples in {dt:.2f}s "
            f"({total / max(dt, 1e-9) / 1e6:.1f} Msamples/s)"
        )
    elif exts == {".sea"}:
        from .batch import decode_corpus
        from .utils.wav import write_wav

        blobs = []
        with _pt("sea_read"):
            for p in paths:
                with open(p, "rb") as f:
                    blobs.append(f.read())
        t0 = time.perf_counter()
        with _pt("decode_wall"):
            results = decode_corpus(blobs, on_error="skip", device=device, mesh=mesh)
        dt = time.perf_counter() - t0
        total = 0
        with _pt("wav_write"):
            for p, info in zip(paths, results):
                if info is None:
                    print(f"skip {p}: undecodable", file=sys.stderr)
                    continue
                name = os.path.splitext(os.path.basename(p))[0] + ".wav"
                write_wav(info.samples, info.channels, info.sample_rate, os.path.join(outdir, name))
                total += info.samples.shape[0]
        print(
            f"decoded {sum(r is not None for r in results)} files / {total} samples "
            f"in {dt:.2f}s ({total / max(dt, 1e-9) / 1e6:.1f} Msamples/s)"
        )
    else:
        print("Error: input glob must match all .wav or all .sea files", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
