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
