"""Multi-process corpus encode: a real 2-process torch.distributed group on
one machine.

The PyTorch port of ``examples/distributed.py``. The reference is
single-process (SURVEY.md §2 "parallelism — explicit statement");
multi-process scale is this framework's extension. The distributed design
is pure data parallelism derived from the format: files shard across
processes, each process's shard encodes over a mesh of its local devices,
and no collective ever touches the compute path -- so multi-process output
is byte-identical to single-process output. The process group (gloo)
carries only the control plane.

This example demonstrates the launch pattern end-to-end by spawning TWO
worker processes of itself, the same shape as ``python -m
sea_codec_torch.batch_cli IN OUT --distributed --coordinator HOST:PORT
--num-processes N --process-id I`` on a real cluster. Each worker:

1. joins the group through ``parallel.distributed.initialize``,
2. proves it with a ``torch.distributed.all_reduce`` over every process's
   mesh entries,
3. takes its file shard via ``shard_files_across_hosts`` and encodes it
   with ``encode_corpus(..., mesh=<local-device mesh>)``: every local CUDA
   device with ``--device cuda`` (on one card both workers share it), 4 CPU
   entries with ``--device cpu``.

The parent then checks every file's bytes against a single-process encode.

Usage:
    python examples/torch/distributed.py [--files 6] [--frames 500] [--fpc 200]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sea_codec_torch import EncoderSettings  # noqa: E402
from sea_codec_torch.batch import encode_corpus  # noqa: E402
from sea_codec_torch.utils.device import resolve_device  # noqa: E402
from sea_codec_torch.utils.signal import varied_signal  # noqa: E402

CPU_MESH_ENTRIES = 4
WORKER_TIMEOUT_S = 540


def make_files(n_files: int, frames: int, channels: int):
    return [
        varied_signal(channels, frames + 17 * i, seed=700 + i)
        for i in range(n_files)
    ]


def worker(args, device) -> int:
    # each worker is one "host": its own process, its own local devices
    import torch
    import torch.distributed as dist

    from sea_codec_torch.parallel.distributed import (
        initialize,
        shard_files_across_hosts,
    )
    from sea_codec_torch.parallel.pipeline import make_mesh

    initialize(args.coordinator, num_processes=2, process_id=args.process_id)
    me, procs = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda":
        local_mesh = make_mesh()
    else:
        local_mesh = make_mesh(devices=[device] * CPU_MESH_ENTRIES)
    k = local_mesh.size
    nd = procs * k
    print(f"worker {me}: {k} local / {nd} global mesh entries")

    # group proof: one collective spanning both processes' entries (gloo
    # reduces host tensors)
    total = torch.arange(me * k, (me + 1) * k, dtype=torch.float64).sum()
    dist.all_reduce(total)
    assert float(total) == nd * (nd - 1) / 2, float(total)
    print(f"worker {me}: cross-process all_reduce ok ({float(total):.0f})")

    files = make_files(args.files, args.frames, 2)
    mine = shard_files_across_hosts(len(files))
    st = EncoderSettings(frames_per_chunk=args.fpc, scale_factor_frames=10)
    t0 = time.perf_counter()
    encoded = encode_corpus([files[i] for i in mine], 44100, 2, st, mesh=local_mesh)
    dt = time.perf_counter() - t0
    outdir = Path(args.outdir)
    for i, blob in zip(mine, encoded):
        (outdir / f"file_{i}.sea").write_bytes(blob)
    print(f"worker {me}: encoded files {list(mine)} on {[str(d) for d in local_mesh.flat]} in {dt:.2f}s")
    dist.destroy_process_group()
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--files", type=int, default=6)
    p.add_argument("--frames", type=int, default=500)
    p.add_argument("--fpc", type=int, default=200)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--outdir", default=None)
    args = p.parse_args()
    device = resolve_device(args.device)  # no card: raises, never falls back to the CPU
    if args.process_id is not None:
        return worker(args, device)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as outdir:
        procs = [
            subprocess.Popen(
                [
                    sys.executable, __file__,
                    "--files", str(args.files),
                    "--frames", str(args.frames),
                    "--fpc", str(args.fpc),
                    "--device", args.device,
                    "--process-id", str(pid),
                    "--coordinator", f"localhost:{port}",
                    "--outdir", outdir,
                ],
            )
            for pid in range(2)
        ]
        try:
            rcs = [q.wait(timeout=WORKER_TIMEOUT_S) for q in procs]
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        assert rcs == [0, 0], f"worker exit codes {rcs}"

        # byte-identity against a single-process encode of the same corpus
        files = make_files(args.files, args.frames, 2)
        st = EncoderSettings(frames_per_chunk=args.fpc, scale_factor_frames=10)
        want = encode_corpus(files, 44100, 2, st, device=device)
        for i in range(args.files):
            got = (Path(outdir) / f"file_{i}.sea").read_bytes()
            assert got == want[i], f"file {i}: multi-process bytes diverge"
    print(f"multi-process == single-process: {args.files} files byte-identical on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
