"""The PyTorch port stands alone: importing ``sea_codec_torch`` loads
neither JAX nor the JAX package, no source file imports them, and the entry
points run on the CUDA card by default instead of falling back to the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sea_codec_torch")
FORBIDDEN = ("jax", "jaxlib", "sea_codec_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    code = (
        "import pkgutil, sys, sea_codec_torch\n"
        "for m in pkgutil.walk_packages(sea_codec_torch.__path__, 'sea_codec_torch.'):\n"
        "    __import__(m.name)\n"
        "print(','.join(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_sources_import_no_jax():
    bad = []
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    if _forbidden(node.module or ""):
                        bad.append((path, node.module))
    assert bad == []


def test_smoke_script_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert [n for n in names if _forbidden(n)] == []


@pytest.mark.parametrize(
    "module",
    ["decoder", "encoder", "ops.lms_decode", "ops.dequant", "utils.io", "utils.wav", "utils.signal"],
)
def test_new_modules_import_alone(module):
    """Each module of the two-kernel decode and the sessions imports in a
    fresh interpreter without pulling in JAX or the JAX package."""
    code = (
        f"import sys, sea_codec_torch.{module}\n"
        f"print([m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}])\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_fused_gates_decide_from_the_geometry():
    """The router's gates are pure arithmetic on the chunk geometry against
    the shared memory one block may use: no GPU needed to see the decision."""
    from sea_codec_torch.ops.cuda_build import SMEM_LIMIT
    from sea_codec_torch.ops.fused_decode import fused_cbr_supported
    from sea_codec_torch.ops.fused_decode_vbr import fused_vbr_supported

    from sea_codec_torch.ops import fused_decode

    assert fused_cbr_supported(4, 3, 5120, 2)
    assert fused_cbr_supported(8, 8, 5120, 6)  # a 30 KB row
    # the CBR kernel streams a row tile by tile: no row is too long for it
    assert fused_cbr_supported(4, 3, 5120, 255)  # ~490 KB: a padded tail-only file
    assert fused_cbr_supported(4, 8, 65535, 1) and fused_cbr_supported(8, 8, 65535, 255)
    assert not fused_cbr_supported(4, 3, 5120, 256) and not fused_cbr_supported(9, 3, 5120, 2)
    # its rings: two slots of dq and two of PCM, a warp of streams to a block
    assert [fused_decode.chunks_per_block(c) for c in (1, 2, 3, 16, 17, 255)] == [32, 16, 10, 2, 1, 1]
    assert [fused_decode.tile_frames(c) for c in (1, 2, 8, 32, 255)] == [256, 256, 128, 32, 32]
    assert fused_decode._smem_bytes(4, 2) == 4 * 16 * (256 * 2 + 4) * 2 + 64 + 64
    assert max(fused_decode._smem_bytes(8, c) for c in range(1, 256)) <= SMEM_LIMIT
    assert fused_vbr_supported(4, 256, 2, 3203)
    assert fused_vbr_supported(4, 256, 255, 65535)
    assert not fused_vbr_supported(4, 256, 255, 490_000)
    fixed = 4 * (9 * 16 + 36) + 7 * 3 + 2
    assert fused_vbr_supported(4, 7, 3, SMEM_LIMIT - fixed)
    assert not fused_vbr_supported(4, 7, 3, SMEM_LIMIT - fixed + 1)


def test_fused_wrappers_refuse_oversize_rows():
    """A row wider than shared memory is refused by the VBR wrapper itself,
    on any device, instead of reaching a launch that would fail. The CBR
    kernel stages no row and takes it; what its wrapper refuses is a channel
    count past the format's 255."""
    from sea_codec_torch.ops.fused_decode import decode_cbr_fused
    from sea_codec_torch.ops.fused_decode_vbr import decode_vbr_fused

    frames, c = 1000, 255
    sf = torch.zeros((1, 50, c), dtype=torch.uint8)
    st = torch.zeros((1, c, 4), dtype=torch.int32)
    res = torch.zeros((1, frames * c), dtype=torch.uint8)
    out = decode_cbr_fused(res, sf, st, st, sfb=4, rs=8, sff=20, frames=frames)
    assert out.shape == (1, frames, c) and out.dtype == torch.int16
    wide = torch.zeros((1, 50, 256), dtype=torch.uint8)
    st_wide = torch.zeros((1, 256, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="bad decode config"):
        decode_cbr_fused(res, wide, st_wide, st_wide, sfb=4, rs=8, sff=20, frames=frames)
    with pytest.raises(ValueError, match="exceeds shared memory"):
        decode_vbr_fused(res, sf, torch.full_like(sf, 8), st, st, sfb=4, sff=20, frames=frames)


@pytest.mark.parametrize("entry", ["decode_range", "decode_corpus", "decode_chunks_packed", "decode_chunks"])
def test_decode_entries_default_to_cuda(entry):
    """The file-level entries resolve ``device=None`` to the card and raise
    without one; the tensor-level entries run where their tensors lie and
    launch kernels only for CUDA tensors (on the CPU: their plain versions,
    counting no launch)."""
    from sea_codec_torch import EncoderSettings, batch, sea_encode
    from sea_codec_torch.ops import dequant, device_decode, fused_decode, lms_decode

    st = EncoderSettings(frames_per_chunk=40, scale_factor_frames=20)
    encoded = sea_encode(np.arange(100, dtype=np.int16), 8000, 1, st, device="cpu")
    if entry in ("decode_range", "decode_corpus"):
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="no CUDA device"):
            if entry == "decode_range":
                batch.decode_range(encoded, 0, 10)
            else:
                batch.decode_corpus([encoded])
        return
    b = batch.parse_full_chunks(batch.split_chunks(encoded)[1], batch.split_chunks(encoded)[0])
    res, sf, rs, hist, wts = (torch.from_numpy(np.ascontiguousarray(a)) for a in b.arrays)
    before = (fused_decode.launches, dequant.cbr_launches, lms_decode.launches)
    if entry == "decode_chunks_packed":
        out = device_decode.decode_chunks_packed(
            res, sf, None, hist, wts, sfb=4, sff=20, frames=40, residual_size=3, fused=False)
    else:
        codes = device_decode.unpack_const(res, 3, 40).reshape(2, 40, 1)
        out = device_decode.decode_chunks(codes, sf, rs, hist, wts, sfb=4, sff=20, static_rs=3)
    assert out.device.type == "cpu" and out.shape == (2, 40, 1)
    assert (fused_decode.launches, dequant.cbr_launches, lms_decode.launches) == before


@pytest.mark.parametrize("entry", ["encode", "decode"])
def test_entry_points_default_to_cuda(entry):
    """Without ``device=`` the entry points target the card: on a host with
    no GPU they raise rather than run on the CPU."""
    from sea_codec_torch import EncoderSettings, sea_decode, sea_encode
    from sea_codec_torch.utils.device import resolve_device

    assert resolve_device(None).type == "cuda" if torch.cuda.is_available() else True
    if torch.cuda.is_available():
        return
    pcm = np.zeros(64, np.int16)
    st = EncoderSettings(frames_per_chunk=32, scale_factor_frames=8)
    encoded = sea_encode(pcm, 8000, 1, st, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "encode":
            sea_encode(pcm, 8000, 1, st)
        else:
            sea_decode(encoded)
