"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled by
``nvcc`` for Hopper (``sm_90a``) into the kernel build cache
(``utils.cache.cache_dir()``: by default ``build/sea_codec_torch/`` beside
the package) at first use, then loaded with ``ctypes``. The library file
name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited kernel or header is rebuilt and a stale build
is never loaded; a library already there is loaded without looking for
``nvcc``. ``build_all`` starts one ``nvcc`` per source at once; ``builds``
counts the ``nvcc`` runs started.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils.cache import cache_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNEL_SOURCES = (
    "fused_decode_cbr", "fused_decode_vbr", "window_search",
    "lms_decode", "dequant_cbr", "dequant_vbr",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on Hopper

_LIBS: dict[str, ctypes.CDLL] = {}
builds = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    digest = h.hexdigest()[:12]
    return cache_dir() / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    (process, temp path, final path) or None."""
    global builds
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    builds += 1
    return proc, tmp, out


def _finish_build(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every named kernel source in parallel (one nvcc each)."""
    jobs = [job for job in (_start_build(n) for n in names) if job is not None]
    for job in jobs:
        _finish_build(job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")
