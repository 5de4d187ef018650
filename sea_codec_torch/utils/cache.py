"""The kernel build cache: where ``ops/cuda_build.py`` keeps its builds.

The port's counterpart of ``sea_codec_tpu/utils/cache.py`` (JAX's persistent
compilation cache), with the same three names. What it caches are the
shared libraries that ``nvcc`` builds from ``csrc/``, one per kernel source,
each named ``lib<kernel>-<hash>.so`` by a hash of its source and the shared
headers. A process that finds a kernel's library there loads it and runs no
``nvcc``, so a host without the CUDA toolkit (a serving host that loads an
artifact of ``aot.py``) runs the kernels from a warm directory.

Directory resolution, in order, on first use (then memoized):

1. ``SEA_TORCH_CACHE=<dir>``. ``0`` disables the cache: each process builds
   into a temporary directory of its own, removed at exit.
2. ``build/sea_codec_torch/`` beside the checkout, when it can be created
   and written.
3. ``~/.cache/sea_codec_torch/kernels``.

What differs from the JAX module: no backend probe (the libraries are the
same on every host), and no pre-populated cache in the repository. A warm
directory is what an earlier build on an ``sm_90a`` card left; a host with
another toolkit or card loads it as it is, since the names hash only the
sources.
"""

from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile
from pathlib import Path

_REPO_DIR = Path(__file__).resolve().parents[2] / "build" / "sea_codec_torch"


def _writable(d: Path) -> bool:
    try:
        d.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=d):
            pass
    except OSError:
        return False
    return True


@functools.cache
def _resolve() -> tuple[Path, bool]:
    """(directory, whether builds there outlive the process)."""
    setting = os.environ.get("SEA_TORCH_CACHE", "")
    if setting == "0":
        d = Path(tempfile.mkdtemp(prefix="sea_codec_torch_kernels_"))
        atexit.register(shutil.rmtree, d, ignore_errors=True)
        return d, False
    if setting not in ("", "1"):
        return Path(setting), True
    if _writable(_REPO_DIR):
        return _REPO_DIR, True
    return Path.home() / ".cache" / "sea_codec_torch" / "kernels", True


def cache_dir() -> Path:
    """The directory the kernels are built into and loaded from."""
    return _resolve()[0]


def cache_entries() -> int:
    """Number of kernel libraries (``lib*.so``) in the cache directory (0
    if it is absent)."""
    d = cache_dir()
    return len(list(d.glob("lib*.so"))) if d.is_dir() else 0


def enable_compilation_cache() -> bool:
    """Whether builds persist beyond this process (False with
    ``SEA_TORCH_CACHE=0``). The JAX package switches its cache on here; the
    build cache needs no switch: it is always in use."""
    return _resolve()[1]
