"""sea_codec_torch: the SEA audio codec on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of ``sea_codec_tpu`` (JAX/Pallas), which stays the reference: the
same ``.sea`` bytes and the same decoded PCM, bit for bit. This package
imports neither JAX nor anything of ``sea_codec_tpu``.

- ``ops/``    -- tables, bit packing, the LMS predictor, the decode and
                 encode pipelines, and the seven CUDA kernels with their
                 plain PyTorch versions (``fused_decode``,
                 ``fused_decode_vbr``, ``window_search``, ``lms_decode``,
                 the two of ``dequant``, and the VBR row serializer of
                 ``serialize_device``; sources in ``csrc/``, built by
                 ``ops/cuda_build.py``); the five decode kernels are
                 ``torch.library`` custom ops (``ops/custom_ops.py``), so
                 that ``torch.export`` traces through them.
                 ``device_decode.decode_chunks_packed``
                 routes packed chunks to the fused kernels, or to the
                 two-kernel path (a dequant kernel, then ``lms_decode``)
                 with ``fused=False`` or ``SEA_FUSED_PROLOG=0``.
- ``models/`` -- the CBR and VBR chunk encoders and the chunk decoder.
- ``container.py`` -- the ``.sea`` file/chunk framing (host-side bytes).
- ``encoder.py``/``decoder.py`` -- settings and the streaming sessions
                 (``SeaEncoder``, ``SeaDecoder``), a chunk per call.
- ``batch.py``/``api.py`` -- ``encode_corpus`` (``encode_sea`` is its
                 one-file case), whole-file decode, ``decode_range``,
                 ``decode_corpus``, the one-shot API with both engines.
- ``convert.py`` -- carries state, settings, parsed batches and dq streams
                 over from the JAX package's numpy arrays.
- ``parallel/`` -- ``pipeline``: the mesh of devices (``make_mesh``), the
                 sharded chunk decode, ``corpus_transcode_step`` and
                 ``deal_files``, which deals the corpus encode's files to
                 a mesh's entries (the ``mesh`` argument of
                 ``encode_corpus``/``decode_corpus``);
                 ``distributed``: the process group and the files of each
                 process.
- ``cli.py``/``__main__.py`` -- the ``seaconv`` CLI (``python -m
                 sea_codec_torch``); ``batch_cli.py`` -- the corpus CLI,
                 with ``--mesh`` and ``--distributed``.
- ``aot.py``  -- serving artifacts: ``export_rows_decoder`` serializes a
                 rows -> PCM decoder for one stream geometry
                 (``torch.export``), ``load_rows_decoder`` runs one without
                 tracing the codec's Python. Not imported with the package.
- ``utils/cache.py`` -- the kernel build cache (``SEA_TORCH_CACHE``):
                 where the nvcc builds go and are loaded from.
- ``native/`` -- the C++ host codec (``sea_native.cpp``, built by the host
                 compiler into the same cache): the host VBR row pack of
                 ``batch.serialize_full_chunks`` (the encoders pack the
                 rows of chunks on a card there, by the row kernel) and
                 ``seaconv --backend native``.

Entry points run on the CUDA card unless ``device`` says otherwise.
"""

from .api import SeaDecodeInfo, sea_decode, sea_encode
from .decoder import SeaDecoder
from .encoder import EncoderSettings, SeaEncoder
from .utils.errors import SeaError
from .utils.metadata import format_metadata, lookup_metadata, parse_metadata

__version__ = "0.1.0"

__all__ = [
    "sea_encode",
    "sea_decode",
    "SeaDecodeInfo",
    "EncoderSettings",
    "SeaEncoder",
    "SeaDecoder",
    "SeaError",
    "format_metadata",
    "parse_metadata",
    "lookup_metadata",
    "__version__",
]
