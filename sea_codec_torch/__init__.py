"""sea_codec_torch: the SEA audio codec on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of ``sea_codec_tpu`` (JAX/Pallas), which stays the reference: the
same ``.sea`` bytes and the same decoded PCM, bit for bit. This package
imports neither JAX nor anything of ``sea_codec_tpu``.

- ``ops/``    -- tables, bit packing, the LMS predictor, the decode and
                 encode pipelines, and the six CUDA kernels with their
                 plain PyTorch versions (``fused_decode``,
                 ``fused_decode_vbr``, ``window_search``, ``lms_decode``,
                 and the two of ``dequant``; sources in ``csrc/``, built by
                 ``ops/cuda_build.py``). ``device_decode.decode_chunks_packed``
                 routes packed chunks to the fused kernels, or to the
                 two-kernel path (a dequant kernel, then ``lms_decode``)
                 with ``fused=False`` or ``SEA_FUSED_PROLOG=0``.
- ``models/`` -- the CBR and VBR chunk encoders and the chunk decoder.
- ``container.py`` -- the ``.sea`` file/chunk framing (host-side bytes).
- ``encoder.py``/``decoder.py`` -- settings and the streaming sessions
                 (``SeaEncoder``, ``SeaDecoder``), a chunk per call.
- ``batch.py``/``api.py`` -- whole-file encode/decode, ``decode_range``,
                 ``decode_corpus``, the one-shot API with both engines.
- ``convert.py`` -- carries state, settings, parsed batches and dq streams
                 over from the JAX package's numpy arrays.

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
