"""Corpus transcoding: many files encoded/decoded in batched device calls.

The PyTorch port of ``examples/corpus.py``. The reference is strictly
one-file-at-a-time; batch scale is this framework's extension (derived
from the format's structure: chunks are self-contained, so decode is
embarrassingly parallel across chunks x files, SURVEY.md section 2).
``encode_corpus`` packs the channel streams of many files into the lanes of
one window-search launch (one lane per file's channel); ``decode_corpus``
batch-parses and decodes all full chunks in a few fused-decode launches.
Outputs are byte-identical to the per-file APIs.

Pass ``--mesh`` to deal the files over a mesh (``parallel.pipeline.make_mesh``)
of every local CUDA device, each entry on its own stream; with ``--device
cpu`` the mesh has 4 CPU entries, the counterpart of the JAX example's
virtual CPU devices. The CLI front end for this flow is
``python -m sea_codec_torch.batch_cli`` (``--distributed`` adds the
multi-process run of ``examples/torch/distributed.py``).

Runs on the CUDA card (``--device cuda``, the default; without a card it
exits with an error) or on the CPU with the kernels' plain versions
(``--device cpu``; pass ``--fpc 1000 --frames 4000`` for a quick run).

Usage:
    python examples/torch/corpus.py [--files 16] [--frames 30000] [--mesh] [--vbr]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sea_codec_torch import EncoderSettings, sea_decode, sea_encode  # noqa: E402
from sea_codec_torch.batch import decode_corpus, encode_corpus  # noqa: E402
from sea_codec_torch.parallel.pipeline import make_mesh  # noqa: E402
from sea_codec_torch.utils.device import resolve_device  # noqa: E402
from sea_codec_torch.utils.signal import varied_signal  # noqa: E402

CPU_MESH_ENTRIES = 4


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--files", type=int, default=16)
    p.add_argument("--frames", type=int, default=30000)
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--vbr", action="store_true")
    p.add_argument("--fpc", type=int, default=5120, help="frames per chunk")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    device = resolve_device(args.device)  # no card: raises, never falls back to the CPU

    channels, sample_rate = 2, 44100
    rng = np.random.default_rng(7)
    files = [
        varied_signal(channels, args.frames + int(rng.integers(0, 997)), seed=i)
        for i in range(args.files)
    ]
    settings = EncoderSettings(
        residual_bits=2.5 if args.vbr else 3.0, vbr=args.vbr,
        frames_per_chunk=args.fpc,
    )

    # the corpus calls take a mesh or a device, not both
    where = {"device": device}
    if args.mesh:
        if device.type == "cuda":
            mesh = make_mesh()
        else:
            mesh = make_mesh(devices=[device] * CPU_MESH_ENTRIES)
        where = {"mesh": mesh}
        print(f"mesh over {mesh.size} devices: {[str(d) for d in mesh.flat]}")

    n_samples = sum(f.size for f in files)
    t0 = time.perf_counter()
    blobs = encode_corpus(files, sample_rate, channels, settings, **where)
    t_enc = time.perf_counter() - t0

    # byte-identity with the one-file-at-a-time API (spot check)
    assert blobs[0] == sea_encode(files[0], sample_rate, channels, settings, device=device)

    t0 = time.perf_counter()
    infos = decode_corpus(blobs, **where)
    t_dec = time.perf_counter() - t0
    for f, info in zip(files, infos):
        assert info.samples.size == f.size
    # sample-identity with the one-file-at-a-time API (spot check)
    assert np.array_equal(infos[0].samples, sea_decode(blobs[0], device=device).samples)

    total_bytes = sum(len(b) for b in blobs)
    print(f"{args.files} files, {n_samples / 1e6:.1f} Msamples on {device}")
    print(f"encode: {t_enc:.2f}s ({n_samples / t_enc / 1e6:.1f} Msps)  "
          f"decode: {t_dec:.2f}s ({n_samples / t_dec / 1e6:.1f} Msps)")
    print(f"compression: {n_samples * 2 / total_bytes:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
