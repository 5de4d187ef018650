"""The port's serving artifacts (``sea_codec_torch.aot``) against the JAX
package's (``sea_codec_tpu.aot``), on the CPU: the same streams as
``tests/test_aot.py``, exported by both, saved, reloaded and run. The
port's PCM equals the JAX artifact's and ``sea_decode``'s (integer codec:
exact), on the fused route and on the two-kernel route
(``SEA_FUSED_PROLOG=0`` at export)."""

from __future__ import annotations

import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sea_codec_torch.aot import export_rows_decoder, load_rows_decoder
from sea_codec_torch.ops import device_decode, parse_device
from sea_codec_tpu import EncoderSettings, sea_decode, sea_encode
from sea_codec_tpu import aot as j_aot
from sea_codec_tpu.batch import split_chunks
from sea_codec_tpu.utils.signal import TEST_SAMPLE_RATE, varied_signal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(2, False, 3.0), (1, False, 1.0), (2, True, 2.5)]


@functools.cache
def _stream(channels, vbr, target, fpc=200, n_chunks=4):
    """(header, full-chunk rows, sea_decode's PCM of them, the JAX
    artifact's PCM) of the stream ``tests/test_aot.py`` uses."""
    sig = varied_signal(channels, n_chunks * fpc, seed=77)
    st = EncoderSettings(frames_per_chunk=fpc, residual_bits=target, vbr=vbr)
    encoded = sea_encode(sig, TEST_SAMPLE_RATE, channels, st)
    header, rect, tail = split_chunks(encoded)
    assert not tail
    want = np.asarray(sea_decode(encoded).samples).reshape(rect.shape[0], fpc, channels)
    blob = j_aot.export_rows_decoder(
        n_chunks=rect.shape[0], channels=channels, frames_per_chunk=fpc, residual_size=int(target),
        vbr=vbr, max_code_bits=min(8, int(target) + 2), chunk_size=header.chunk_size if vbr else None,
    )
    jax_pcm = np.asarray(j_aot.load_rows_decoder(blob)(rect))
    return header, rect, want, jax_pcm


def _export(channels, vbr, target, header, rect):
    # the header's anchor is the VBR base size the test of the JAX export passes
    assert int(rect[0, 1]) & 15 == int(target)
    return export_rows_decoder(
        n_chunks=rect.shape[0], channels=channels, frames_per_chunk=header.frames_per_chunk,
        residual_size=int(target), vbr=vbr, chunk_size=header.chunk_size if vbr else None, device="cpu",
    )


def _op_calls(blob):
    """The names of the package's ops the exported program calls, in order."""
    program = torch.export.load(io.BytesIO(blob))
    return [str(n.target).split(".")[1] for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("sea_codec_torch.")]


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("channels,vbr,target", CASES)
def test_export_matches_jax(channels, vbr, target, fused, monkeypatch):
    """Saved to bytes and reloaded, the port's rows decoder gives the JAX
    artifact's PCM and ``sea_decode``'s; the route is fixed at export: one
    fused op by default, a dequant op then ``lms_decode`` with
    ``SEA_FUSED_PROLOG=0``."""
    header, rect, want, jax_pcm = _stream(channels, vbr, target)
    np.testing.assert_array_equal(jax_pcm, want)
    monkeypatch.setenv("SEA_FUSED_PROLOG", fused)
    blob = _export(channels, vbr, target, header, rect)
    assert isinstance(blob, bytes) and len(blob) > 1000
    mode = "vbr" if vbr else "cbr"
    assert _op_calls(blob) == ([f"fused_decode_{mode}"] if fused == "1" else [f"dequant_{mode}", "lms_decode"])
    monkeypatch.delenv("SEA_FUSED_PROLOG")  # the route is the artifact's, not the loader's
    decode = load_rows_decoder(blob)
    out = decode(rect)
    assert out.dtype == torch.int16 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), jax_pcm)
    np.testing.assert_array_equal(decode(torch.from_numpy(rect.copy())).numpy(), want)


def test_artifact_size_does_not_grow_with_the_rows():
    """The artifact holds the program, not the example rows it was traced
    on: a hundred times the chunks adds no bytes beyond the shapes'
    digits."""
    sizes = [len(export_rows_decoder(n_chunks=n, channels=2, frames_per_chunk=200, device="cpu"))
             for n in (4, 400)]
    assert sizes[0] > 1000 and abs(sizes[1] - sizes[0]) < 1000, sizes


def test_vbr_export_requires_chunk_size():
    with pytest.raises(ValueError, match="chunk_size"):
        export_rows_decoder(n_chunks=4, channels=2, vbr=True, device="cpu")


def test_rows_of_another_shape_or_device_raise():
    """The program's own guards: the static row count and width, and the
    device it was exported for."""
    header, rect, _want, _jax = _stream(2, False, 3.0)
    decode = load_rows_decoder(_export(2, False, 3.0, header, rect))
    # the guard's wording differs between torch versions: "rows.size()[0] == 4"
    # or "input at *args[0].shape[0] to be equal to 4"
    with pytest.raises((AssertionError, RuntimeError), match=r"size\(\)\[0\]|shape\[0\]"):
        decode(rect[:-1])
    with pytest.raises((AssertionError, RuntimeError), match=r"size\(\)\[1\]|shape\[1\]"):
        decode(np.pad(rect, ((0, 0), (0, 1))))
    with pytest.raises(RuntimeError, match="device"):
        decode(torch.from_numpy(rect.copy()).to("meta"))


def test_loaded_artifact_traces_no_codec_python(monkeypatch):
    """After the export, the parse and the router raise if called: the
    loaded program decodes all the same, since it runs only its graph and
    the ops' kernels."""
    header, rect, want, _jax = _stream(2, True, 2.5)
    blob = _export(2, True, 2.5, header, rect)

    def traced(*_a, **_k):
        raise AssertionError("codec Python ran")

    for module, name in ((parse_device, "parse_chunks_vbr_device"), (parse_device, "parse_chunks_cbr_device"),
                         (parse_device, "decode_chunks_packed"), (device_decode, "decode_chunks_packed")):
        monkeypatch.setattr(module, name, traced)
    np.testing.assert_array_equal(load_rows_decoder(blob)(rect).numpy(), want)


CHILD = """
import sys
import numpy as np
from sea_codec_torch.aot import load_rows_decoder
blob_path, rows_path, out_path = sys.argv[1:]
with open(blob_path, "rb") as f:
    decode = load_rows_decoder(f.read())
np.save(out_path, decode(np.load(rows_path)).numpy())
"""


def test_load_in_a_child_process(tmp_path):
    """A fresh process loads the artifact from a file and decodes with
    nothing of the export in memory."""
    header, rect, want, _jax = _stream(2, False, 3.0)
    (tmp_path / "decoder.pt2").write_bytes(_export(2, False, 3.0, header, rect))
    np.save(tmp_path / "rows.npy", rect)
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp_path / "decoder.pt2"), str(tmp_path / "rows.npy"),
         str(tmp_path / "pcm.npy")],
        capture_output=True, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=180,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "pcm.npy"), want)


def test_export_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        export_rows_decoder(n_chunks=4, channels=2)
