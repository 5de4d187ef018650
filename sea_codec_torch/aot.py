"""Ahead-of-time export of the device decoder (serving artifacts).

``torch.export`` serializes the rows decoder for one stream geometry --
``uint8[N, chunk_size]`` full container rows -> ``int16[N, frames, C]``
PCM, the parse included (``ops/parse_device.py``) -- to bytes that a
serving process loads and runs without tracing this package's codec code:
the program holds the parse's tensor operations and calls of the decode
kernels' custom ops (``ops/custom_ops.py``). Shapes are static per artifact,
as in the JAX package: a serving tier exports one artifact per stream
geometry it accepts (the chunk geometry is in the file header, so dispatch
is a dict lookup).

The kernels are not inside the artifact, as a Pallas kernel is inside the
JAX package's StableHLO: a loaded program's CUDA kernels load their
libraries from the kernel build cache (``utils/cache.py``), so a host
without the CUDA toolkit serves from a warm cache (``SEA_TORCH_CACHE``).
The route is fixed at export, as the JAX export fixes it at trace time: the
fused kernel, or with ``SEA_FUSED_PROLOG=0`` set when exporting the
two-kernel path (a dequant op, then ``lms_decode``).

Example::

    blob = export_rows_decoder(n_chunks=256, channels=2)
    Path("decoder_cbr3_stereo.pt2").write_bytes(blob)
    # ... in the serving process:
    decode = load_rows_decoder(blob)
    pcm = decode(rows)  # uint8 tensor on the card (or numpy) in, int16 tensor out

Not carried over from the JAX package: ``use_pallas`` and ``max_code_bits``
(the router picks the kernel, as ``ops/parse_device.py`` says), and
``platforms``, replaced by ``device``: an artifact runs on the device it
was exported for.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from .utils.device import resolve_device


class _RowsDecoder(torch.nn.Module):
    """``decode(rows, *geometry)`` as a module, for ``torch.export``."""

    def __init__(self, decode, geometry: tuple):
        super().__init__()
        self.decode = decode
        self.geometry = geometry

    def forward(self, rows):
        return self.decode(rows, *self.geometry)


def export_rows_decoder(
    n_chunks: int,
    channels: int,
    frames_per_chunk: int = 5120,
    scale_factor_frames: int = 20,
    scale_factor_bits: int = 4,
    residual_size: int = 3,
    vbr: bool = False,
    chunk_size: int | None = None,
    device=None,
) -> bytes:
    """Serialize a rows->PCM decoder for one stream geometry.

    ``residual_size``: the CBR constant width, or (``vbr=True``) the chunk
    header's base size. ``chunk_size``: the header's chunk byte length,
    computed for CBR when omitted and REQUIRED for VBR (the per-chunk size
    multiset is constant per stream geometry and target, so it lives in the
    file header, not in a closed form here). ``device``: where the artifact
    runs (default the CUDA card; ``"cpu"`` runs the kernels' plain
    versions)."""
    from .ops.parse_device import decode_rows_vbr_device, transcode_chunks_cbr_device
    from .ops.serialize_device import cbr_chunk_size

    if vbr:
        if chunk_size is None:
            raise ValueError("VBR export requires the header's chunk_size")
        decode = decode_rows_vbr_device
    else:
        if chunk_size is None:
            chunk_size = cbr_chunk_size(
                channels, frames_per_chunk, scale_factor_bits, scale_factor_frames, residual_size,
            )
        decode = transcode_chunks_cbr_device
    dev = resolve_device(device)
    module = _RowsDecoder(decode, (channels, scale_factor_bits, scale_factor_frames, residual_size,
                                   frames_per_chunk))
    rows = torch.zeros((n_chunks, chunk_size), dtype=torch.uint8, device=dev)
    program = torch.export.export(module, (rows,))
    program.example_inputs = None  # the artifact carries no example rows
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_rows_decoder(blob: bytes):
    """Deserialize an exported decoder into a callable (rows -> PCM). It
    takes a uint8 tensor on the artifact's device, or a numpy array, which
    it moves there; rows of another shape or on another device raise (the
    program's own guards)."""
    from .ops import custom_ops  # noqa: F401 (registers the ops the program calls)

    program = torch.export.load(io.BytesIO(blob))
    rows_spec = next(n for n in program.graph.nodes if n.op == "placeholder").meta["val"]
    device = rows_spec.device
    module = program.module()

    def decode(rows):
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.require(rows, requirements=("C", "W"))).to(device)
        return module(rows)

    return decode
