"""ctypes binding for the native C++ host codec (``sea_native.cpp``).

The port's counterpart of ``sea_codec_tpu/native/binding.py``: the same
six functions with the same signatures and semantics. Three things differ:

- **Where the library goes.** The host C++ compiler (``g++``, then ``c++``,
  then ``clang++``) builds it into the build cache
  (``utils.cache.cache_dir()``, where the CUDA kernels go too) as
  ``sea_native-<hash>.so``, named by a hash of the source: an edited source
  is rebuilt and a stale build is never loaded. It is compiled to a temporary
  file and moved into place, so a process never loads a half-written one.
- **A library already there is loaded without looking for a compiler**, as
  ``ops/cuda_build.load`` does; ``builds`` counts the compiler runs of this
  process. ``SEA_TORCH_CACHE=0`` builds into a temporary directory removed
  at exit.
- **No silent fallback.** ``available()`` is False only when no compiler is
  found. A compiler that runs and fails raises with its log.

``pack_calls`` counts the calls of ``native_pack_rows``:
``batch.serialize_full_chunks``, the host's VBR row pack, packs through it
when ``available()``. The encoders pack the full VBR chunks of a card on
the card (``ops.serialize_device.corpus_rows_vbr_device``), so on a card
this counter does not move.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.cache import cache_dir

SRC = Path(__file__).resolve().parent / "sea_native.cpp"
COMPILERS = ("g++", "c++", "clang++")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_checked = False
_lock = threading.Lock()
builds = 0
pack_calls = 0

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "sea_native_encode": (ctypes.c_int, [
        _i16p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(_u8p), _u64p,
    ]),
    "sea_native_decode": (ctypes.c_int, [_u8p, ctypes.c_uint64, _i16p, _u32p, _u32p, _u64p]),
    "sea_native_free": (None, [ctypes.c_void_p]),
    "sea_native_dump_dqt": (None, [ctypes.c_int, ctypes.c_int, _i32p]),
    "sea_native_dump_reciprocals": (None, [ctypes.c_int, ctypes.c_int, _i32p]),
    "sea_native_pack_rows": (None, [
        _u8p, _u8p, ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_long, _u8p,
    ]),
}


def lib_path() -> Path:
    """Where the library of this source lies in the build cache."""
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return cache_dir() / f"sea_native-{digest}.so"


def compiler() -> str | None:
    """The first host C++ compiler on ``PATH``, or None."""
    for cxx in COMPILERS:
        found = shutil.which(cxx)
        if found:
            return found
    return None


def _build(out: Path, cxx: str) -> None:
    global builds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    builds += 1
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        log = (proc.stdout + proc.stderr).decode(errors="replace")
        raise RuntimeError(f"{cxx} failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def _get():
    """The loaded library (building it if needed), or None without a
    compiler."""
    global _lib, _checked
    with _lock:
        if _checked:
            return _lib
        path = lib_path()
        if not path.exists():
            cxx = compiler()
            if cxx is None:
                _checked = True
                return None
            _build(path, cxx)
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib, _checked = lib, True
        return lib


def available() -> bool:
    """Whether the library is loaded or can be built (a compiler is found;
    one that fails raises)."""
    return _get() is not None


def _require():
    lib = _get()
    if lib is None:
        raise RuntimeError(f"the native host codec needs a C++ compiler ({', '.join(COMPILERS)})")
    return lib


def native_encode(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    scale_factor_bits: int = 4,
    scale_factor_frames: int = 20,
    residual_bits: float = 3.0,
    frames_per_chunk: int = 5120,
    vbr: bool = False,
    metadata: str = "",
) -> bytes:
    """Interleaved int16 samples -> ``.sea`` bytes, on the host."""
    lib = _require()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    out = _u8p()
    out_len = ctypes.c_uint64()
    meta = metadata.encode("utf-8")
    rc = lib.sea_native_encode(
        samples.ctypes.data_as(_i16p), samples.shape[0], channels, sample_rate,
        scale_factor_bits, scale_factor_frames, residual_bits, frames_per_chunk,
        1 if vbr else 0, meta, len(meta), ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise ValueError(f"native encode failed: {rc}")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.sea_native_free(out)


def native_decode(encoded: bytes) -> tuple[np.ndarray, int, int]:
    """``.sea`` bytes -> (samples int16[], sample_rate, channels), on the
    host. Raises ValueError on a stream it cannot decode."""
    lib = _require()
    buf = np.frombuffer(encoded, dtype=np.uint8)
    channels = ctypes.c_uint32()
    rate = ctypes.c_uint32()
    frames = ctypes.c_uint64()

    def call(out):
        return lib.sea_native_decode(
            buf.ctypes.data_as(_u8p), len(encoded), out,
            ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(frames),
        )

    rc = call(None)
    if rc != 0:
        raise ValueError(f"native decode probe failed: {rc}")
    # format bound: residuals are >= 1 bit/sample, so decoded bytes can never
    # exceed 16x the stream bytes; a corrupt header that probes bigger must
    # not drive the allocation
    if frames.value * channels.value * 2 > 16 * len(encoded) + 4096:
        raise ValueError("native decode probe: implausible decoded size")
    out = np.zeros(frames.value * channels.value, dtype=np.int16)
    rc = call(out.ctypes.data_as(_i16p))
    if rc != 0:
        raise ValueError(f"native decode failed: {rc}")
    return out, rate.value, channels.value


def native_dump_dqt(scale_factor_bits: int, residual_bits: int) -> np.ndarray:
    """The library's dequant table, int32[2^sfb, 2^rb]."""
    lib = _require()
    out = np.zeros((1 << scale_factor_bits) * (1 << residual_bits), dtype=np.int32)
    lib.sea_native_dump_dqt(scale_factor_bits, residual_bits, out.ctypes.data_as(_i32p))
    return out.reshape(1 << scale_factor_bits, 1 << residual_bits)


def native_dump_reciprocals(scale_factor_bits: int, residual_bits: int) -> np.ndarray:
    """The library's quantizer reciprocals, int32[2^sfb]."""
    lib = _require()
    out = np.zeros(1 << scale_factor_bits, dtype=np.int32)
    lib.sea_native_dump_reciprocals(scale_factor_bits, residual_bits, out.ctypes.data_as(_i32p))
    return out


def native_pack_rows(
    values: np.ndarray,  # uint8[N, count]
    widths,  # int (constant) or uint8[N, count] per-item widths
    row_bytes: int,
    n_threads: int = 4,
) -> np.ndarray:
    """Row-batched MSB-first bitpack through the C++ codec -> uint8[N, row_bytes].

    The C call releases the GIL, so independent row blocks pack on a small
    thread pool (one block below 64 rows). Semantics identical to
    ``ops.bitpack.pack_bits_rows``. A row whose widths exceed 8 bits an item
    or ``row_bytes`` in all raises ValueError instead of reaching the C
    loop, which would write past its row."""
    global pack_calls
    lib = _require()
    values = np.ascontiguousarray(values, dtype=np.uint8)
    n, count = values.shape
    out = np.zeros((n, row_bytes), dtype=np.uint8)
    if np.isscalar(widths) or np.ndim(widths) == 0:
        const_w = int(widths)
        warr = None
        if not 0 <= const_w <= 8 or const_w * count > 8 * row_bytes:
            raise ValueError(f"{count} items of {const_w} bits do not fit {row_bytes} bytes")
    else:
        const_w = 0
        warr = np.ascontiguousarray(widths, dtype=np.uint8)
        if warr.shape != (n, count):
            raise ValueError(f"widths {warr.shape} != values {values.shape}")
    pack_calls += 1
    if n == 0 or count == 0:
        return out

    def pack_block(r0: int, r1: int) -> None:
        w = None
        if warr is not None:
            w = warr[r0:r1]
            if w.max() > 8 or w.sum(axis=1, dtype=np.int64).max() > 8 * row_bytes:
                raise ValueError(f"a row's widths exceed 8 bits an item or {row_bytes} bytes")
        lib.sea_native_pack_rows(
            values[r0:r1].ctypes.data_as(_u8p),
            w.ctypes.data_as(_u8p) if w is not None else None,
            const_w, r1 - r0, count, row_bytes,
            out[r0:r1].ctypes.data_as(_u8p),
        )

    if n < 64 or n_threads <= 1:
        pack_block(0, n)
    else:
        from concurrent.futures import ThreadPoolExecutor

        step = -(-n // n_threads)
        bounds = [(r, min(r + step, n)) for r in range(0, n, step)]
        with ThreadPoolExecutor(len(bounds)) as ex:
            list(ex.map(lambda b: pack_block(*b), bounds))
    return out
