"""The five decode kernels as ``torch.library`` custom ops.

Each op, under the namespace ``sea_codec_torch``, has a fake implementation
(its output's shape and dtype, all that tracing needs), a CUDA kernel (the
launch through ``ctypes``, kept in the wrapper's module beside its launcher
and its ``launches`` count) and a CPU kernel (the plain PyTorch version).
The dispatcher picks the kernel by the tensors' device, so ``torch.export``
traces a decode down to one graph node per kernel (``aot.py``) and a loaded
program calls the same kernels as an eager call:

==================  ===============================  ============================
op                  inputs -> output                 kernels (CUDA; CPU)
==================  ===============================  ============================
fused_decode_cbr    res_bytes, sf, hist0, wts0,      ``fused_decode._launch``;
                    sfb, rs, sff, frames             ``decode_cbr_plain``
                    -> int16[N, frames, C]
fused_decode_vbr    res_bytes, sf, rs, hist0, wts0,  ``fused_decode_vbr._launch``;
                    sfb, sff, frames                 ``decode_vbr_plain``
                    -> int16[N, frames, C]
dequant_cbr         res_bytes, sf, sfb, rs, sff,     ``dequant._launch_cbr``;
                    frames -> int16[frames, N, C]    ``unpack_dequant_cbr_plain``
dequant_vbr         res_bytes, sf, rs, sfb, sff,     ``dequant._launch_vbr``;
                    frames -> int16[frames, N, C]    ``unpack_dequant_vbr_plain``
lms_decode          dq int16[F, N, C], hist0, wts0   ``lms_decode._launch``;
                    -> int16[N, F, C]                ``lms_decode_plain``
==================  ===============================  ============================

The public wrappers (``fused_decode.decode_cbr_fused``,
``fused_decode_vbr.decode_vbr_fused``, ``dequant.unpack_dequant_cbr``,
``dequant.unpack_dequant_vbr``, ``lms_decode.lms_decode``) check shapes,
dtypes and devices, which tracing sees too, then call the op. The CUDA
kernels fetch their tables (``tables.dq_table``) themselves, and the fake
implementations touch none: no table is an input of an op or a constant of
an exported graph, and nothing fills the tables' caches while tracing (a
fake tensor cached there would be handed to every later eager call).

``window_search`` stays on its direct ``ctypes`` launch: nothing exports
the encode (the JAX package exports no encoder), and its outputs fit no op
schema without changing its callers (``codes`` is None in the ranks-only
form, and the state tensors it returns are clones of its inputs).
"""

# No ``from __future__ import annotations``: ``custom_op`` reads the schema
# from the annotations as types.

import torch
from torch import Tensor

_NS = "sea_codec_torch"


def _no_kernel(t: Tensor):
    raise ValueError(f"unsupported device {t.device}")


@torch.library.custom_op(f"{_NS}::fused_decode_cbr", mutates_args=())
def fused_decode_cbr(res_bytes: Tensor, sf: Tensor, hist0: Tensor, wts0: Tensor,
                     sfb: int, rs: int, sff: int, frames: int) -> Tensor:
    """N full-size CBR chunks -> int16[N, frames, C] (``ops.fused_decode``)."""
    _no_kernel(sf)


@fused_decode_cbr.register_kernel("cuda")
def _(res_bytes, sf, hist0, wts0, sfb, rs, sff, frames):
    from . import fused_decode

    return fused_decode._launch(res_bytes, sf, hist0, wts0, sfb, rs, sff, frames)


@fused_decode_cbr.register_kernel("cpu")
def _(res_bytes, sf, hist0, wts0, sfb, rs, sff, frames):
    from .fused_decode import decode_cbr_plain

    return decode_cbr_plain(res_bytes, sf, hist0, wts0, sfb=sfb, rs=rs, sff=sff, frames=frames)


@fused_decode_cbr.register_fake
def _(res_bytes, sf, hist0, wts0, sfb, rs, sff, frames):
    return sf.new_empty((sf.shape[0], frames, sf.shape[2]), dtype=torch.int16)


@torch.library.custom_op(f"{_NS}::fused_decode_vbr", mutates_args=())
def fused_decode_vbr(res_bytes: Tensor, sf: Tensor, rs: Tensor, hist0: Tensor, wts0: Tensor,
                     sfb: int, sff: int, frames: int) -> Tensor:
    """N VBR chunks -> int16[N, frames, C] (``ops.fused_decode_vbr``)."""
    _no_kernel(sf)


@fused_decode_vbr.register_kernel("cuda")
def _(res_bytes, sf, rs, hist0, wts0, sfb, sff, frames):
    from . import fused_decode_vbr

    return fused_decode_vbr._launch(res_bytes, sf, rs, hist0, wts0, sfb, sff, frames)


@fused_decode_vbr.register_kernel("cpu")
def _(res_bytes, sf, rs, hist0, wts0, sfb, sff, frames):
    from .fused_decode_vbr import decode_vbr_plain

    return decode_vbr_plain(res_bytes, sf, rs, hist0, wts0, sfb=sfb, sff=sff, frames=frames)


@fused_decode_vbr.register_fake
def _(res_bytes, sf, rs, hist0, wts0, sfb, sff, frames):
    return sf.new_empty((sf.shape[0], frames, sf.shape[2]), dtype=torch.int16)


@torch.library.custom_op(f"{_NS}::dequant_cbr", mutates_args=())
def dequant_cbr(res_bytes: Tensor, sf: Tensor, sfb: int, rs: int, sff: int, frames: int) -> Tensor:
    """CBR rows -> the dq stream int16[frames, N, C] (``ops.dequant``)."""
    _no_kernel(sf)


@dequant_cbr.register_kernel("cuda")
def _(res_bytes, sf, sfb, rs, sff, frames):
    from . import dequant

    return dequant._launch_cbr(res_bytes, sf, sfb, rs, sff, frames)


@dequant_cbr.register_kernel("cpu")
def _(res_bytes, sf, sfb, rs, sff, frames):
    from .dequant import unpack_dequant_cbr_plain

    return unpack_dequant_cbr_plain(res_bytes, sf, sfb=sfb, rs=rs, sff=sff, frames=frames)


@dequant_cbr.register_fake
def _(res_bytes, sf, sfb, rs, sff, frames):
    return sf.new_empty((frames, sf.shape[0], sf.shape[2]), dtype=torch.int16)


@torch.library.custom_op(f"{_NS}::dequant_vbr", mutates_args=())
def dequant_vbr(res_bytes: Tensor, sf: Tensor, rs: Tensor, sfb: int, sff: int, frames: int) -> Tensor:
    """VBR rows -> the dq stream int16[frames, N, C] (``ops.dequant``)."""
    _no_kernel(sf)


@dequant_vbr.register_kernel("cuda")
def _(res_bytes, sf, rs, sfb, sff, frames):
    from . import dequant

    return dequant._launch_vbr(res_bytes, sf, rs, sfb, sff, frames)


@dequant_vbr.register_kernel("cpu")
def _(res_bytes, sf, rs, sfb, sff, frames):
    from .dequant import unpack_dequant_vbr_plain

    return unpack_dequant_vbr_plain(res_bytes, sf, rs, sfb=sfb, sff=sff, frames=frames)


@dequant_vbr.register_fake
def _(res_bytes, sf, rs, sfb, sff, frames):
    return sf.new_empty((frames, sf.shape[0], sf.shape[2]), dtype=torch.int16)


@torch.library.custom_op(f"{_NS}::lms_decode", mutates_args=())
def lms_decode(dq: Tensor, hist0: Tensor, wts0: Tensor) -> Tensor:
    """The LMS recurrence over dq int16[F, N, C] -> int16[N, F, C]
    (``ops.lms_decode``)."""
    _no_kernel(dq)


@lms_decode.register_kernel("cuda")
def _(dq, hist0, wts0):
    from . import lms_decode as module

    return module._launch(dq, hist0, wts0)


@lms_decode.register_kernel("cpu")
def _(dq, hist0, wts0):
    from .lms_decode import lms_decode_plain

    return lms_decode_plain(dq, hist0, wts0)


@lms_decode.register_fake
def _(dq, hist0, wts0):
    return dq.new_empty((dq.shape[1], dq.shape[0], dq.shape[2]))
