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
    """Every module of the package, and ``python -m sea_codec_torch`` (run
    to its ``--help``), loads no JAX."""
    code = (
        "import pkgutil, runpy, sys, sea_codec_torch\n"
        "for m in pkgutil.walk_packages(sea_codec_torch.__path__, 'sea_codec_torch.'):\n"
        "    if not m.name.endswith('.__main__'):\n"
        "        __import__(m.name)\n"
        "sys.argv = ['sea_codec_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('sea_codec_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print('loaded:' + ','.join(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "usage: seaconv" in out.stdout
    assert out.stdout.splitlines()[-1] == "loaded:"


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
    ["decoder", "encoder", "ops.lms_decode", "ops.dequant", "utils.io", "utils.wav", "utils.signal",
     "ops.parse_device", "utils.profiling", "ops.encode_file", "cli", "batch_cli",
     "parallel.pipeline", "parallel.distributed", "native"],
)
def test_new_modules_import_alone(module):
    """Each module of the two-kernel decode, the sessions, the corpus encode,
    the device parse, the front ends, the mesh and multi-process
    pipelines and the native host codec imports in a fresh interpreter
    without pulling in JAX or the JAX package."""
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


def test_mesh_pipeline_does_not_load_batch():
    """``parallel.pipeline`` stands below ``batch``: ``batch.encode_corpus``
    and ``decode_corpus`` use the mesh, and the mesh imports nothing of
    them, not even inside a function, so importing it alone leaves
    ``batch`` unloaded."""
    path = os.path.join(REPO, "sea_codec_torch", "parallel", "pipeline.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            named += [(node.module or "").split(".")] + [[a.name] for a in node.names]
        elif isinstance(node, ast.Import):
            named += [a.name.split(".") for a in node.names]
    assert not [n for n in named if "batch" in n]
    code = (
        "import sys, sea_codec_torch.parallel.pipeline\n"
        "print('sea_codec_torch.batch' in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_fused_gates_decide_from_the_geometry():
    """The router's gates are pure arithmetic on the chunk geometry against
    the shared memory one block may use: no GPU needed to see the decision."""
    from sea_codec_torch.ops.cuda_build import SMEM_LIMIT
    from sea_codec_torch.ops.fused_decode import fused_cbr_supported
    from sea_codec_torch.ops.fused_decode_vbr import fused_vbr_supported

    from sea_codec_torch.ops import fused_decode

    # the CBR kernel streams a row tile by tile: no row is too long for it,
    # so its gate reads (sfb, C) alone
    assert all(fused_cbr_supported(sfb, c) for sfb in range(1, 9) for c in range(1, 256))
    assert not fused_cbr_supported(4, 256) and not fused_cbr_supported(9, 2)
    assert not fused_cbr_supported(0, 2) and not fused_cbr_supported(4, 0)
    # its rings: two slots of dq and two of PCM, a warp of streams to a block
    assert [fused_decode.chunks_per_block(c) for c in (1, 2, 3, 16, 17, 255)] == [32, 16, 10, 2, 1, 1]
    assert [fused_decode.tile_frames(c) for c in (1, 2, 8, 32, 255)] == [256, 256, 128, 32, 32]
    assert fused_decode._smem_bytes(2) == 4 * 16 * (256 * 2 + 4) * 2 + 64
    assert max(fused_decode._smem_bytes(c) for c in range(1, 256)) <= SMEM_LIMIT
    # the VBR kernel streams a row too and builds each tile's window tables:
    # its gate reads (sfb, sff, C) alone and is open for every legal one
    assert all(fused_vbr_supported(sfb, sff, c)
               for sfb in range(1, 9) for sff in (1, 2, 20, 255) for c in range(1, 256))
    assert not fused_vbr_supported(4, 20, 256) and not fused_vbr_supported(9, 20, 2)
    assert not fused_vbr_supported(4, 0, 2) and not fused_vbr_supported(4, 256, 2)


def test_fused_vbr_tables_fit_shared_memory():
    """The VBR kernel's shared memory (``_smem_bytes``, the launcher's sum)
    stays within one block's for every sfb, sff 1..255 and C 1..255 (the
    kernels use no static shared memory), and sizes a tile's window tables
    for the most windows a tile can touch."""
    from sea_codec_torch.ops import decode_ring, fused_decode_vbr
    from sea_codec_torch.ops.cuda_build import SMEM_LIMIT

    worst = max(fused_decode_vbr._smem_bytes(sff, c) for sff in range(1, 256) for c in range(1, 256))
    assert worst <= SMEM_LIMIT
    assert fused_decode_vbr._smem_bytes(1, 1) == worst  # 32 chunks, a window per frame
    # stereo at the defaults: barriers, rings 4 x 16 x (256*2 + 4) int16, 14 windows, cursors
    assert fused_decode_vbr._smem_bytes(20, 2) == 64 + 4 * 16 * 516 * 2 + 8 * 16 * 14 * 3 + 64
    for c in (1, 2, 3, 17, 33, 255):
        tile = decode_ring.tile_frames(c)
        for sff in (1, 2, 7, 20, 255):
            most = max((f0 + tile - 1) // sff - f0 // sff + 1 for f0 in range(0, 2 * sff * tile, tile))
            assert fused_decode_vbr.windows_per_tile(sff, c) >= most
            assert fused_decode_vbr.windows_per_tile(sff, c) <= most + 1


@pytest.mark.parametrize("n", [1, 17, 1550])
@pytest.mark.parametrize("c", [1, 2, 17, 33, 255])
@pytest.mark.parametrize("sff", [1, 20, 255])
@pytest.mark.parametrize("sfb", [1, 8])
def test_dequant_launches_fit_and_cover_every_chunk(sfb, sff, c, n):
    """The dequant wrappers' mirrors of their launchers (``_cbr_launch``,
    ``_vbr_launch``): the shared memory fits one block's, the blocks take
    every chunk (and for CBR every tile of frames) once, the VBR tables hold
    the most windows a tile can touch, and the dq table the kernels read
    holds every (size, scale factor, code) of the configuration."""
    from sea_codec_torch.ops import dequant, tables
    from sea_codec_torch.ops.cuda_build import SMEM_LIMIT

    frames = 5120
    cbr = dequant._cbr_launch(n, c, frames)
    vbr = dequant._vbr_launch(n, c, sff, frames)
    for geo in (cbr, vbr):
        assert geo["smem"] <= SMEM_LIMIT
        assert geo["threads"] % 32 == 0 and 32 <= geo["threads"] <= 512
        assert geo["group"] <= geo["threads"]  # a thread zeroes each chunk's bit cursor
        assert geo["tile"] % 32 == 0
        gx, group = geo["grid"][0], geo["group"]
        assert (gx - 1) * group < n <= gx * group
    gy, tile = cbr["grid"][1], cbr["tile"]
    assert (gy - 1) * tile < frames <= gy * tile and gy <= 65535
    tile = vbr["tile"]
    most = max((f0 + tile - 1) // sff - f0 // sff + 1 for f0 in range(0, frames, tile))
    assert most <= vbr["nwmax"] <= most + 1
    # the slot holds a tile of every chunk, the tables every window's entries
    assert vbr["smem"] >= vbr["group"] * (tile * c * 2 + 8 * vbr["nwmax"] * (1 + c))
    flat = tables.dq_table(sfb, "cpu")
    assert flat.dtype == torch.int16
    assert flat.numel() == tables.dq_table_offset(8, sfb) + (1 << (sfb + 8))
    for rs in (1, 3, 8):
        at = tables.dq_table_offset(rs, sfb)
        want = tables.dqt(rs, sfb)
        got = flat[at : at + want.size].reshape(want.shape).numpy()
        assert (got == want).all()


def test_dequant_kernels_share_the_fused_producers():
    """Each dequant prolog is the fused decode's producer without the
    recurrence: the CBR pair and the VBR pair include one producer header and
    build the same producer (one dequant path, the reference table), and the
    dequant kernels stay out of the recurrence ring."""
    from sea_codec_torch.ops import cuda_build

    src = {n: (cuda_build.CSRC / f"{n}.cu").read_text() for n in cuda_build.KERNEL_SOURCES}
    for mode, producer in (("cbr", "CbrProducer p{"), ("vbr", "VbrProducer p{")):
        include = f'#include "producer_{mode}.cuh"'
        assert include in src[f"fused_decode_{mode}"] and include in src[f"dequant_{mode}"]
        assert "decode_ring.cuh" not in src[f"dequant_{mode}"]
        assert producer in src[f"fused_decode_{mode}"] and producer in src[f"dequant_{mode}"]
        header = (cuda_build.CSRC / f"producer_{mode}.cuh").read_text()
        assert "template" not in header and "__ldg(dqt" in header


@pytest.mark.parametrize("name", ["fused_decode_cbr", "fused_decode_vbr", "window_search",
                                  "lms_decode", "dequant_cbr", "dequant_vbr", "serialize_vbr"])
def test_launchers_ask_for_shared_memory_once(name):
    """Every launcher asks for more than the default shared memory through
    ``launch.cuh``'s ``allow_smem`` (once per kernel, device and size, and
    only above 48 KB), never through ``cudaFuncSetAttribute`` on every
    launch, and returns its error."""
    from sea_codec_torch.ops import cuda_build

    assert name in cuda_build.KERNEL_SOURCES
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    assert '#include "launch.cuh"' in src
    assert "cudaFuncSetAttribute" not in src
    assert src.count("sea_launch::allow_smem(") == 1
    assert "if (err != cudaSuccess) return static_cast<int>(err);" in src
    header = (cuda_build.CSRC / "launch.cuh").read_text()
    assert header.count("cudaFuncSetAttribute(") == 1 and "48 * 1024" in header


def test_kernel_library_names_hash_the_shared_headers(tmp_path, monkeypatch):
    """A library's name carries the hash of its source and of the shared
    headers: editing ``decode_ring.cuh`` renames every decode kernel's
    library (a build kept from before is never loaded), editing one kernel
    renames only its own."""
    import shutil

    from sea_codec_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    names = cuda_build.KERNEL_SOURCES
    before = {n: cuda_build._lib_path(n) for n in names}
    users = [n for n in names if '#include "decode_ring.cuh"' in (csrc / f"{n}.cu").read_text()]
    assert sorted(users) == ["fused_decode_cbr", "fused_decode_vbr", "lms_decode"]
    header = csrc / "decode_ring.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._lib_path(n) for n in names}
    assert all(after[n] != before[n] for n in users)
    src = csrc / "lms_decode.cu"
    src.write_text(src.read_text() + "\n")
    again = {n: cuda_build._lib_path(n) for n in names}
    assert [n for n in names if again[n] != after[n]] == ["lms_decode"]


def test_fused_wrappers_refuse_oversize_rows():
    """Neither fused kernel stages a row, so both wrappers take a row wider
    than shared memory; what they refuse, on any device, is a geometry past
    the format's (256 channels), instead of reaching a launch that would
    fail."""
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
    out = decode_vbr_fused(res, sf, torch.full_like(sf, 8), st, st, sfb=4, sff=20, frames=frames)
    assert out.shape == (1, frames, c) and out.dtype == torch.int16
    with pytest.raises(ValueError, match="bad decode config"):
        decode_vbr_fused(res, wide, torch.full_like(wide, 8), st_wide, st_wide, sfb=4, sff=20, frames=frames)


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


@pytest.mark.parametrize(
    "entry", ["encode", "decode", "encode_corpus", "transcode_chunks_cbr_device", "decode_rows_vbr_device",
              "cli.main", "batch_cli.main", "make_mesh"]
)
def test_entry_points_default_to_cuda(entry, tmp_path, capsys):
    """Without ``device=`` (``--device`` for the CLIs) the entry points
    target the card: on a host with no GPU they raise, or the CLIs exit
    non-zero with the same error, rather than run on the CPU. The device
    decoders of ``parse_device`` take rows already on a device and decode
    there: given CPU rows (the caller's choice) they run the plain versions
    and count no kernel launch."""
    from sea_codec_torch import EncoderSettings, batch, sea_decode, sea_encode
    from sea_codec_torch.ops import fused_decode, fused_decode_vbr, parse_device
    from sea_codec_torch.utils.device import resolve_device

    assert resolve_device(None).type == "cuda" if torch.cuda.is_available() else True
    pcm = np.arange(64, dtype=np.int16)
    st = EncoderSettings(frames_per_chunk=32, scale_factor_frames=8, vbr=entry == "decode_rows_vbr_device")
    encoded = sea_encode(pcm, 8000, 1, st, device="cpu")
    if entry.endswith("_device"):
        header, rect, _tail = batch.split_chunks(encoded)
        before = (fused_decode.launches, fused_decode_vbr.launches)
        out = getattr(parse_device, entry)(torch.from_numpy(rect.copy()), 1, 4, 8, int(rect[0, 1]) & 15, 32)
        assert out.device.type == "cpu" and out.shape == (2, 32, 1)
        np.testing.assert_array_equal(out.reshape(-1).numpy(), sea_decode(encoded, device="cpu").samples)
        assert (fused_decode.launches, fused_decode_vbr.launches) == before
        return
    if torch.cuda.is_available():
        return
    if entry.endswith(".main"):
        from sea_codec_torch import batch_cli, cli
        from sea_codec_torch.utils.wav import write_wav

        write_wav(pcm, 1, 8000, str(tmp_path / "in.wav"))
        main = cli.main if entry == "cli.main" else batch_cli.main
        with pytest.raises(SystemExit) as e:
            main([str(tmp_path / "in.wav"), str(tmp_path / "out.sea"), "-c", "200"])
        assert e.value.code == 1 and "no CUDA device" in capsys.readouterr().err
        assert sorted(os.listdir(tmp_path)) == ["in.wav"]
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "make_mesh":
            from sea_codec_torch.parallel.pipeline import make_mesh

            make_mesh()
        elif entry == "encode":
            sea_encode(pcm, 8000, 1, st)
        elif entry == "encode_corpus":
            batch.encode_corpus([pcm, pcm[:10]], 8000, 1, st)
        else:
            sea_decode(encoded)
