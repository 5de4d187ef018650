"""The kernel build cache (``sea_codec_torch.utils.cache``) and how
``ops/cuda_build.py`` uses it, on the CPU (no ``nvcc`` needed): the
directory's resolution order, the count of its libraries, the libraries'
names under it, and a library already there loaded without looking for
``nvcc`` (what a serving host without the CUDA toolkit relies on)."""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from sea_codec_torch.ops import cuda_build
from sea_codec_torch.utils import cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_resolution():
    """Each test resolves the directory anew, and leaves no memo behind."""
    cache._resolve.cache_clear()
    yield
    cache._resolve.cache_clear()


def test_env_names_the_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path / "warm"))
    assert cache.cache_dir() == tmp_path / "warm"
    assert cache.enable_compilation_cache() is True
    assert cache.cache_entries() == 0  # absent until a build makes it


@pytest.mark.parametrize("setting", [None, "", "1"])
def test_default_is_the_repo_local_build_directory(setting, monkeypatch):
    if setting is None:
        monkeypatch.delenv("SEA_TORCH_CACHE", raising=False)
    else:
        monkeypatch.setenv("SEA_TORCH_CACHE", setting)
    assert cache.cache_dir() == REPO / "build" / "sea_codec_torch"
    assert cache.cache_dir().is_dir()
    assert cache.enable_compilation_cache() is True


def test_user_directory_when_the_checkout_is_not_writable(tmp_path, monkeypatch):
    """``build/`` cannot be made (here a file stands where a directory
    would): the cache goes to ``~/.cache``."""
    blocker = tmp_path / "checkout" / "build"
    blocker.parent.mkdir()
    blocker.write_text("not a directory")
    monkeypatch.setattr(cache, "_REPO_DIR", blocker / "sea_codec_torch")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("SEA_TORCH_CACHE", raising=False)
    assert cache.cache_dir() == tmp_path / "home" / ".cache" / "sea_codec_torch" / "kernels"
    assert cache.enable_compilation_cache() is True


def test_memoized(tmp_path, monkeypatch):
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path / "a"))
    first = cache.cache_dir()
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path / "b"))
    assert cache.cache_dir() == first


CHILD = """
from sea_codec_torch.utils import cache
d = cache.cache_dir()
(d / "libfused_decode_cbr-000000000000.so").write_bytes(b"")
print(d, d.is_dir(), cache.enable_compilation_cache(), cache.cache_entries())
"""


def test_zero_disables_persistence(tmp_path):
    """``SEA_TORCH_CACHE=0``: the process builds into a temporary directory
    of its own, removed when it exits."""
    env = dict(os.environ, PYTHONPATH=str(REPO), SEA_TORCH_CACHE="0", TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path, is_dir, persists, entries = out.stdout.split()
    assert Path(path).parent == tmp_path and Path(path).name.startswith("sea_codec_torch_kernels_")
    assert (is_dir, persists, entries) == ("True", "False", "1")
    assert not Path(path).exists()


def test_cache_entries_counts_kernel_libraries(tmp_path, monkeypatch):
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path))
    for name in ("liblms_decode-0123456789ab.so", "libdequant_cbr-ba9876543210.so", "other.so",
                 "liblms_decode-0123456789ab.123.tmp", "libfused_decode_cbr.so.txt", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert cache.cache_entries() == 2


@pytest.mark.parametrize("name", cuda_build.KERNEL_SOURCES)
def test_libraries_lie_under_the_cache_with_source_hash_names(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path))
    h = hashlib.sha1((cuda_build.CSRC / f"{name}.cu").read_bytes())
    for header in sorted(cuda_build.CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    path = cuda_build._lib_path(name)
    assert path == tmp_path / f"lib{name}-{h.hexdigest()[:12]}.so"
    assert re.fullmatch(rf"lib{name}-[0-9a-f]{{12}}\.so", path.name)


def _no_toolkit(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))


def test_present_library_builds_nothing(tmp_path, monkeypatch):
    """With every library in the cache, no ``nvcc`` is looked for (there is
    none) and none runs."""
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path / "warm"))
    _no_toolkit(tmp_path, monkeypatch)
    (tmp_path / "warm").mkdir()
    for name in cuda_build.KERNEL_SOURCES:
        cuda_build._lib_path(name).write_bytes(b"")
    before = cuda_build.builds
    assert all(cuda_build._start_build(name) is None for name in cuda_build.KERNEL_SOURCES)
    cuda_build.build_all()
    assert cuda_build.builds == before


def test_missing_library_without_nvcc_raises(tmp_path, monkeypatch):
    """An empty cache and no toolkit: the build raises, and counts no
    build."""
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path / "empty"))
    _no_toolkit(tmp_path, monkeypatch)
    before = cuda_build.builds
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all(("lms_decode",))
    assert cuda_build.builds == before
