"""The native C++ host codec (``sea_native.cpp``, built on demand into the
build cache): the host VBR row pack of ``batch.serialize_full_chunks`` and
``seaconv --backend native``. The counters ``builds`` (compiler runs) and
``pack_calls`` live in ``native.binding``."""

from .binding import (
    available,
    native_decode,
    native_dump_dqt,
    native_dump_reciprocals,
    native_encode,
    native_pack_rows,
)

__all__ = [
    "available",
    "native_encode",
    "native_decode",
    "native_dump_dqt",
    "native_dump_reciprocals",
    "native_pack_rows",
]
