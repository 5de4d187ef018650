"""Corpus transcoding over a mesh of devices.

The reference is single-threaded end to end; the parallelism here comes
from the format's structure, as in the JAX package
(``sea_codec_tpu/parallel/pipeline.py``):

- **decode** is embarrassingly parallel across chunks (each chunk carries
  its own LMS entry state), so a chunk batch is split into one contiguous
  row range per mesh entry, with no communication between them;
- **encode** is sequential across the windows of a file (the LMS and
  previous-scale-factor carry) but independent across files and channels,
  so files are dealt to the entries and each entry searches its files'
  lanes; the chunk-entry LMS states the container needs come out of the
  same search (``ops.window_search``).

A mesh entry is a device; each entry at work (``Shard``) has its own
stream, so the entries' kernels are enqueued in turn by one host thread and
run concurrently. Entries may repeat a device: each repeat is a shard with
its own streams. That is how the sharded code runs on the CPU (``[cpu] *
4``) and on one card (``[cuda:0] * 2``); repeats on one card share its
SMs and give no speedup.

Where the JAX package places global arrays sharded over the mesh
(``NamedSharding``) and lets one SPMD program run on every device, the port
keeps a list of per-entry tensors and launches each entry's kernels itself.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.device_decode import decode_chunks
from ..ops.lms import initial_history, initial_weights
from ..ops.window_search import window_search
from ..utils.device import resolve_device


class Mesh:
    """A 2-D grid of devices (``devices``: a numpy object array of
    ``torch.device``) with named axes, by default ``("files", "chunks")``.
    ``flat`` lists the entries in row-major order; ``size`` counts them."""

    def __init__(self, devices: np.ndarray, axis_names=("files", "chunks")):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D grid needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list[torch.device]:
        return list(self.devices.reshape(-1))


def make_mesh(n_devices: int | None = None, axis_names=("files", "chunks"), devices=None) -> Mesh:
    """A 2-D mesh (files x chunks) over the first ``n_devices`` of
    ``devices``, in the most square a x b factorization. ``devices``
    defaults to every local CUDA device (and raises without a card); it may
    repeat a device."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices must be in 1..{len(devices)}, got {n_devices}")
    a = int(np.floor(np.sqrt(n_devices)))
    while n_devices % a:
        a -= 1
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(a, n_devices // a), axis_names)


class Shard:
    """One mesh entry at work: its device and, on a card, a stream of its
    own. Work enqueued under ``on()`` goes to that stream (the kernel
    wrappers launch on the current stream of their tensors' device). With
    ``own_stream=False`` (one device, no mesh) ``on()`` leaves the current
    stream as it is."""

    def __init__(self, device: torch.device, own_stream: bool = True):
        self.device = device
        self.stream = torch.cuda.Stream(device) if own_stream and device.type == "cuda" else None

    def on(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def shards(mesh: Mesh) -> list[Shard]:
    """A ``Shard`` for each entry of ``mesh``, in its flat order."""
    return [Shard(d) for d in mesh.flat]


def row_ranges(n: int, k: int) -> list[tuple[int, int]]:
    """``n`` rows in ``k`` contiguous ranges [lo, hi) in order, the first
    ``n % k`` one row longer (as ``numpy.array_split``)."""
    q, r = divmod(n, k)
    starts = [i * q + min(i, r) for i in range(k + 1)]
    return list(zip(starts[:-1], starts[1:]))


def shard_chunk_batch(mesh: Mesh, *arrays):
    """Split chunk-batch arrays (numpy or tensors, chunks on the leading
    axis) into one contiguous row range per mesh entry (``row_ranges``),
    each moved to its entry's device: a list with one tuple of tensors per
    entry, in the mesh's flat order. The JAX package returns global arrays
    sharded over the mesh instead; the port returns the shards."""
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("arrays must share their leading (chunk) axis")
    tensors = [a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [
        tuple(t[lo:hi].to(dev) for t in tensors)
        for dev, (lo, hi) in zip(mesh.flat, row_ranges(n, mesh.size))
    ]


def decode_chunk_batch_sharded(mesh: Mesh, codes, sf, rs, hist, wts,
                               scale_factor_bits: int, scale_factor_frames: int) -> np.ndarray:
    """Chunk-parallel decode of unpacked chunks over the mesh: ``codes``
    uint8[N, F, C], ``sf`` and ``rs`` uint8[N, W, C] (the per-window sizes
    are read), ``hist``/``wts`` int32[N, C, 4] (as ``batch.parse_file``
    gives them). Each entry decodes its row range (``shard_chunk_batch``)
    with ``ops.device_decode.decode_chunks``: the ``lms_decode`` kernel on a
    card, its plain version on the CPU. Returns int16[N, F, C] on the host.

    The inputs may be numpy arrays or tensors on any device. A tensor on a
    card must be ready on that card's current stream (PyTorch's rule for a
    tensor handed over): each entry's stream waits for its device's current
    stream, which is where ``shard_chunk_batch`` moved its rows, and where a
    tensor already on the entry's device was made."""
    parts = shard_chunk_batch(mesh, codes, sf, rs, hist, wts)
    outs = []
    for shard, args in zip(shards(mesh), parts):
        if not len(args[0]):
            continue
        if shard.stream is not None:
            # the rows were moved, or made, on the current stream; the
            # shard's stream reads them, so it waits, and the allocator
            # keeps them until it has read them
            shard.stream.wait_stream(torch.cuda.current_stream(shard.device))
            for a in args:
                a.record_stream(shard.stream)
        with shard.on():
            outs.append((shard, decode_chunks(*args, sfb=scale_factor_bits, sff=scale_factor_frames)))
    pcm = []
    for shard, out in outs:
        with shard.on():
            pcm.append(out.cpu().numpy())
    if not pcm:
        return np.zeros((0, *codes.shape[1:]), dtype=np.int16)
    return np.concatenate(pcm)


def corpus_transcode_step(
    mesh: Mesh,
    samples,  # int32[n_files, n_chunks, fpc, C], int16 values
    residual_size: int,
    scale_factor_bits: int,
    scale_factor_frames: int,
):
    """One encode + decode step over a corpus of equal-length files, CBR at
    ``residual_size``, every chunk full (``fpc`` a multiple of
    ``scale_factor_frames``).

    Files are dealt to the mesh entries in contiguous ranges; each entry
    runs one ``window_search`` launch over its files' lanes (file x
    channel), every chunk as ``wpc`` windows, which also gives each chunk's
    entry LMS state. The resulting chunks are then dealt across all entries
    (files x chunks, the reshard of the JAX package's step) and decoded with
    ``decode_chunks``. On a card these are the kernels, never their plain
    versions. Returns (pcm int16[n_files, n_chunks, fpc, C], codes
    uint8[n_files, n_chunks, fpc, C]) on the host; the PCM equals the
    per-file ``sea_encode`` then ``sea_decode`` of the same samples."""
    x = np.asarray(samples)
    if x.ndim != 4:
        raise ValueError(f"samples must be [n_files, n_chunks, fpc, C], got {x.shape}")
    nf, nc, fpc, c = x.shape
    sff = scale_factor_frames
    if fpc % sff:
        raise ValueError(f"fpc {fpc} must be a multiple of scale_factor_frames {sff}")
    if x.size and (x.min() < -32768 or x.max() > 32767):
        raise ValueError("samples must hold int16 values")
    wpc = fpc // sff
    kw = dict(sfb=scale_factor_bits, sff=sff)
    sh = shards(mesh)

    # encode: each entry's files as the lanes of one search launch;
    # chunk rows come out file-major (row = file * nc + chunk)
    enc = []
    for shard, (lo, hi) in zip(sh, row_ranges(nf, len(sh))):
        if lo == hi:
            continue
        k = hi - lo
        lanes = x[lo:hi].transpose(1, 2, 0, 3).reshape(nc * fpc, k * c).astype(np.int16)
        dev = shard.device
        with shard.on():
            xd = torch.from_numpy(lanes).to(dev)
            h0 = initial_history(c, dev).repeat(k, 1)
            w0 = initial_weights(c, dev).repeat(k, 1)
            p0 = torch.zeros(k * c, dtype=torch.int32, device=dev)
            sf, codes, _ranks, ehist, ewts, _h, _w, _p = window_search(
                xd, None, h0, w0, p0, rs=residual_size, wpc=wpc, **kw
            )
            rows = (
                codes.view(nc, fpc, k, c).permute(2, 0, 1, 3).reshape(k * nc, fpc, c),
                sf.view(nc, wpc, k, c).permute(2, 0, 1, 3).reshape(k * nc, wpc, c),
                ehist.view(nc, k, c, 4).permute(1, 0, 2, 3).reshape(k * nc, c, 4),
                ewts.view(nc, k, c, 4).permute(1, 0, 2, 3).reshape(k * nc, c, 4),
            )
        enc.append((shard, lo * nc, hi * nc, rows))

    # reshard: the chunk rows dealt over every entry, each entry's stream
    # waiting for the encodes it reads; the encode outputs stay referenced
    # until every download below has finished
    dec = []
    for shard, (lo, hi) in zip(sh, row_ranges(nf * nc, len(sh))):
        if lo == hi:
            continue
        with shard.on():
            parts = []
            for src, a, b, rows in enc:
                s, e = max(lo, a), min(hi, b)
                if s >= e:
                    continue
                if shard.stream is not None and src.stream is not shard.stream:
                    shard.stream.wait_stream(src.stream)
                parts.append([t[s - a : e - a].to(shard.device) for t in rows])
            codes_r, sf_r, eh_r, ew_r = (torch.cat(p) for p in zip(*parts))
            dec.append((shard, decode_chunks(codes_r, sf_r, None, eh_r, ew_r, static_rs=residual_size, **kw)))

    def fetch(pairs):
        out = []
        for shard, t in pairs:
            with shard.on():
                out.append(t.cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, fpc, c), dtype=np.int16)

    pcm = fetch(dec)
    codes = fetch([(shard, rows[0]) for shard, _a, _b, rows in enc]).astype(np.uint8)
    return pcm.reshape(nf, nc, fpc, c), codes.reshape(nf, nc, fpc, c)


def deal_files(frames: list[int], n: int) -> list[list[int]]:
    """Corpus file indices dealt to ``n`` entries: longest file first, each
    to the entry with the least work so far (its files' frames: the files
    of one call share their channel count; the lowest entry on a tie).
    Returns each entry's file indices in dealing order. ``batch.encode_corpus``
    deals its files so, to a mesh's entries or to one device.

    The JAX package's sharded encode takes 128-lane blocks padded to a
    whole number of shards, for one SPMD program; here each slab is its own
    launch, so neither the blocks nor the padding are carried over."""
    load = [0] * n
    out: list[list[int]] = [[] for _ in range(n)]
    for i in sorted(range(len(frames)), key=lambda i: -frames[i]):
        e = load.index(min(load))
        out[e].append(i)
        load[e] += frames[i]
    return out

