"""Multi-process runs of the PyTorch port: a 2-process ``torch.distributed``
cluster (gloo, on the CPU) formed by ``parallel.distributed.initialize``,
each process encoding its share of a corpus (``shard_files_across_hosts``)
over a mesh of its local devices; and two ``batch_cli --distributed``
processes. The union of the processes' outputs must equal the
single-process bytes.

The worker is this file's ``__main__`` block:

    python tests/test_torch_multihost.py <process_id> <port> <outdir>
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
N_FILES, CHANNELS, RATE = 6, 2, 44100
# a failure of the cluster's rendezvous, not of the codec: retried once on
# a fresh port
INFRA = ("Address already in use", "Connection refused", "ECONNREFUSED", "bind", "EADDRINUSE")


def _corpus():
    from sea_codec_torch.utils.signal import varied_signal

    return [varied_signal(CHANNELS, 300 + 17 * i, seed=100 + i) for i in range(N_FILES)]


def _settings(vbr: bool):
    from sea_codec_torch import EncoderSettings

    if vbr:
        return EncoderSettings(frames_per_chunk=100, scale_factor_frames=10, residual_bits=2.5, vbr=True)
    return EncoderSettings(frames_per_chunk=100, scale_factor_frames=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO))


def _run_pair(argv_of):
    """Start two processes (``argv_of(pid, port)``) on a fresh port; on a
    rendezvous failure, once more on another. Returns their outputs."""
    for attempt in range(2):
        port = _free_port()
        procs = [
            subprocess.Popen(argv_of(pid, port), cwd=str(REPO), env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for pid in range(2)
        ]
        try:
            outs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = "\n".join(o[-4000:] for o in outs)
        if not any(p.returncode for p in procs):
            return text
        if attempt or not any(m in text for m in INFRA):
            pytest.fail(f"exit codes {[p.returncode for p in procs]}:\n{text}")
    raise AssertionError("unreachable")


def test_shard_files_across_hosts_partition(monkeypatch):
    """Every file exactly once, in contiguous ranges, for any process count;
    one process (no group) takes all."""
    import torch.distributed as dist

    from sea_codec_torch.parallel import distributed as d

    assert not dist.is_initialized()
    assert d.shard_files_across_hosts(5) == range(5)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    for procs in (1, 2, 3, 4, 7):
        for n in (0, 1, 6, 10):
            seen = []
            for me in range(procs):
                monkeypatch.setattr(dist, "get_world_size", lambda: procs)
                monkeypatch.setattr(dist, "get_rank", lambda: me)
                r = d.shard_files_across_hosts(n)
                assert r.step == 1
                seen.extend(r)
            assert seen == list(range(n)), (procs, n, seen)


def test_initialize_is_a_no_op_without_a_cluster(monkeypatch):
    """One process, or no cluster described: nothing is initialized. An
    explicit coordinator without its process count is refused."""
    import torch.distributed as dist

    from sea_codec_torch.parallel.distributed import initialize

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize()
    initialize("localhost:1", num_processes=1, process_id=0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    initialize()
    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize("localhost:1")
    assert not dist.is_initialized()


def test_two_process_cluster_corpus_encode(tmp_path):
    """Two processes form a gloo cluster through ``initialize``, prove it
    with an ``all_reduce``, and each encodes (CBR and VBR) and decodes its
    file share over a 2-entry mesh of its local CPU: the union equals the
    single-process bytes and PCM."""
    from sea_codec_torch import batch, sea_decode

    text = _run_pair(lambda pid, port: [sys.executable, __file__, str(pid), str(port), str(tmp_path)])
    assert "worker 0: files [0, 1, 2]" in text and "worker 1: files [3, 4, 5]" in text
    files = _corpus()
    for vbr, suffix in ((False, "sea"), (True, "vbr.sea")):
        want = batch.encode_corpus(files, RATE, CHANNELS, _settings(vbr), device="cpu")
        for i in range(N_FILES):
            assert (tmp_path / f"file_{i}.{suffix}").read_bytes() == want[i], (vbr, i)
            if not vbr:
                np.testing.assert_array_equal(
                    np.load(tmp_path / f"file_{i}.pcm.npy"), sea_decode(want[i], device="cpu").samples
                )


def test_batch_cli_distributed_two_processes(tmp_path):
    """Two ``batch_cli --distributed --coordinator ... --device cpu``
    processes split a wav corpus and together write exactly the
    single-process bytes."""
    from sea_codec_torch import batch
    from sea_codec_torch.utils.wav import write_wav

    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    files = _corpus()[:4]
    for i, s in enumerate(files):
        write_wav(s, CHANNELS, RATE, str(indir / f"f{i}.wav"))
    _run_pair(lambda pid, port: [
        sys.executable, "-m", "sea_codec_torch.batch_cli", str(indir / "*.wav"), str(outdir),
        "-c", "200", "-d", "10", "--device", "cpu", "--distributed",
        "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id", str(pid),
    ])
    from sea_codec_torch import EncoderSettings

    want = batch.encode_corpus(files, RATE, CHANNELS, EncoderSettings(frames_per_chunk=200,
                                                                      scale_factor_frames=10), device="cpu")
    for i in range(len(files)):
        assert (outdir / f"f{i}.sea").read_bytes() == want[i], f"f{i}.sea"


def _worker(pid: int, port: int, outdir: Path) -> None:
    import torch.distributed as dist

    from sea_codec_torch import batch
    from sea_codec_torch.parallel.distributed import initialize, shard_files_across_hosts
    from sea_codec_torch.parallel.pipeline import make_mesh

    torch.set_num_threads(1)
    initialize(f"localhost:{port}", num_processes=2, process_id=pid)
    assert dist.is_initialized() and dist.get_world_size() == 2 and dist.get_rank() == pid
    x = torch.tensor([float(pid + 1)])
    dist.all_reduce(x)  # the cluster is real: 1 + 2
    assert x.item() == 3.0, x
    mine = shard_files_across_hosts(N_FILES)
    files = [_corpus()[i] for i in mine]
    mesh = make_mesh(devices=["cpu", "cpu"])
    for vbr, suffix in ((False, "sea"), (True, "vbr.sea")):
        encoded = batch.encode_corpus(files, RATE, CHANNELS, _settings(vbr), mesh=mesh)
        for i, blob in zip(mine, encoded):
            (outdir / f"file_{i}.{suffix}").write_bytes(blob)
        if not vbr:
            for i, d in zip(mine, batch.decode_corpus(encoded, mesh=mesh)):
                np.save(outdir / f"file_{i}.pcm.npy", d.samples)
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {pid}: files {list(mine)}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
