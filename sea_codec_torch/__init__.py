"""sea_codec_torch: the SEA audio codec on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of ``sea_codec_tpu`` (JAX/Pallas), which stays the reference: the
same ``.sea`` bytes and the same decoded PCM, bit for bit. This package
imports neither JAX nor anything of ``sea_codec_tpu``.

- ``ops/``    -- tables, bit packing, the LMS predictor, the decode and
                 encode pipelines, and the three CUDA kernels with their
                 plain PyTorch versions (``fused_decode``,
                 ``fused_decode_vbr``, ``window_search``; sources in
                 ``csrc/``, built by ``ops/cuda_build.py``).
- ``models/`` -- the CBR and VBR tail-chunk encoders and the chunk decoder.
- ``container.py`` -- the ``.sea`` file/chunk framing (host-side bytes).
- ``batch.py``/``api.py`` -- whole-file encode/decode, one-shot API.
- ``convert.py`` -- carries encoder/LMS state and settings over from the
                 JAX package's numpy arrays.

Entry points run on the CUDA card unless ``device`` says otherwise.
"""

from .api import SeaDecodeInfo, sea_decode, sea_encode
from .encoder import EncoderSettings
from .utils.errors import SeaError
from .utils.metadata import format_metadata, lookup_metadata, parse_metadata

__version__ = "0.1.0"

__all__ = [
    "sea_encode",
    "sea_decode",
    "SeaDecodeInfo",
    "EncoderSettings",
    "SeaError",
    "format_metadata",
    "parse_metadata",
    "lookup_metadata",
    "__version__",
]
