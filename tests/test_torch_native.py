"""The port's native C++ host codec (``sea_codec_torch.native``) on the CPU:
its tables against the port's, its row packer against ``bitpack``, its
encode and decode against the JAX package's native codec and the port's
pipeline, ``batch.serialize_full_chunks`` under both packers against the JAX
package's, ``seaconv --backend native`` against the JAX CLI's, and its
build: a warm library loaded with no compiler on ``PATH``, a compiler that
fails raising. Needs a host C++ compiler."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, batch, cli, sea_encode
from sea_codec_torch.native import binding
from sea_codec_torch.ops import bitpack, tables
from sea_codec_torch.utils import cache
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, gen_test_signal
from sea_codec_torch.utils.wav import write_wav
from sea_codec_tpu import batch as j_batch
from sea_codec_tpu import cli as j_cli
from sea_codec_tpu import native as j_native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(binding.compiler() is None, reason="no host C++ compiler")


@pytest.mark.parametrize("rb", range(1, 9))
@pytest.mark.parametrize("sfb", range(1, 9))
def test_tables_match_the_port(sfb, rb):
    np.testing.assert_array_equal(binding.native_dump_dqt(sfb, rb), tables.dqt(rb, sfb))
    np.testing.assert_array_equal(binding.native_dump_reciprocals(sfb, rb), tables.reciprocals(rb, sfb))


def _values(rng, widths, shape):
    return (rng.integers(0, 256, size=shape) % (1 << np.asarray(widths, dtype=np.int64))).astype(np.uint8)


@pytest.mark.parametrize("n,count", [(0, 5), (5, 0), (1, 1), (7, 13), (63, 399), (64, 8), (65, 399), (200, 1024)])
@pytest.mark.parametrize("kind", ["constant", "per_item"])
def test_pack_rows_matches_bitpack(kind, n, count):
    """One block below 64 rows, four threads' blocks above; N = 0 and
    count 0 give empty rows."""
    rng = np.random.default_rng(n * 1000 + count)
    if kind == "constant":
        widths = int(rng.integers(1, 9))
        vals = _values(rng, widths, (n, count))
    else:
        widths = np.repeat(rng.integers(1, 9, size=(1, count)), n, axis=0).astype(np.uint8)
        for r in range(n):  # same total a row, widths in another order
            widths[r] = rng.permutation(widths[r])
        vals = _values(rng, widths, (n, count))
    want = bitpack.pack_bits_rows(vals, widths) if n else np.zeros((0, 0), np.uint8)
    row_bytes = bitpack.packed_byte_len(widths[0] if kind == "per_item" and n else widths, count)
    got = binding.native_pack_rows(vals, widths, row_bytes)
    assert got.shape == (n, row_bytes) and got.dtype == np.uint8
    if n:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(binding.native_pack_rows(vals, widths, row_bytes, n_threads=1), got)


def test_pack_rows_takes_lane_slices():
    """The corpus encode passes a file's lanes out of a group's arrays:
    non-contiguous views pack as their contiguous copies do."""
    rng = np.random.default_rng(3)
    n, w, lanes, sff = 70, 16, 7, 20
    sizes = rng.integers(1, 9, size=(1, w, lanes)).repeat(n, axis=0).astype(np.uint8)
    codes = _values(rng, np.repeat(sizes, sff, axis=1), (n, w * sff, lanes))
    part = slice(2, 5)
    wv = np.repeat(sizes[:, :, part], sff, axis=1)
    view = codes[:, :, part].transpose(0, 2, 1)[:, 0, :]  # one lane, strided
    assert not view.flags.c_contiguous
    for vals, widths in ((view, wv[:, :, 0]), (codes[:, :, 1], 3), (codes[:, ::2, 4], wv[:, ::2, 1])):
        want = bitpack.pack_bits_rows(np.ascontiguousarray(vals), widths)
        np.testing.assert_array_equal(binding.native_pack_rows(vals, widths, want.shape[1]), want)


@pytest.mark.parametrize("widths,row_bytes", [(9, 100), (3, 2), ("wide", 1000), ("long", 10)])
def test_pack_rows_refuses_rows_past_their_bytes(widths, row_bytes):
    """Widths above 8 bits, or more bits than ``row_bytes``, raise before
    the C loop could write past a row."""
    vals = np.zeros((70, 10), np.uint8)
    if widths == "wide":
        widths = np.full((70, 10), 8, np.uint8)
        widths[69, 0] = 9
    elif widths == "long":
        widths = np.full((70, 10), 8, np.uint8)
        widths[0, 0] = 0  # row 0 fits 9 bytes, the others do not
        row_bytes = 9
    with pytest.raises(ValueError):
        binding.native_pack_rows(vals, widths, row_bytes)


def _settings(vbr, metadata=""):
    return EncoderSettings(frames_per_chunk=1000, residual_bits=2.5 if vbr else 3.0, vbr=vbr,
                           metadata=metadata)


def _native_kw(st):
    return dict(scale_factor_bits=st.scale_factor_bits, scale_factor_frames=st.scale_factor_frames,
                residual_bits=st.residual_bits, frames_per_chunk=st.frames_per_chunk, vbr=st.vbr,
                metadata=st.metadata)


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("vbr", [False, True])
def test_encode_matches_jax_native_and_the_port(vbr, channels):
    """Two full chunks and a tail: the port's C++ encoder gives the JAX
    package's native bytes and the port's ``sea_encode`` on the CPU."""
    samples = gen_test_signal(channels, 2300)
    st = _settings(vbr, metadata="k=v")
    ours = binding.native_encode(samples, TEST_SAMPLE_RATE, channels, **_native_kw(st))
    assert ours == j_native.native_encode(samples, TEST_SAMPLE_RATE, channels, **_native_kw(st))
    assert ours == sea_encode(samples, TEST_SAMPLE_RATE, channels, st, device="cpu")


@pytest.mark.parametrize("vbr", [False, True])
def test_decode_matches_jax_native(vbr):
    samples = gen_test_signal(2, 20000)
    encoded = j_native.native_encode(samples, TEST_SAMPLE_RATE, 2, **_native_kw(_settings(vbr)))
    got, rate, ch = binding.native_decode(encoded)
    want, j_rate, j_ch = j_native.native_decode(encoded)
    assert (rate, ch) == (j_rate, j_ch) == (TEST_SAMPLE_RATE, 2)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def _outcome(fn, data):
    try:
        out, rate, ch = fn(data)
    except ValueError as e:
        return ("ValueError", str(e))
    return (out.tobytes(), rate, ch)


def test_decode_of_corrupt_streams_matches_jax_native():
    """Corrupt chunk-config bytes (sfb 0 among them) and random bit flips:
    the same samples or the same ValueError as the JAX package's binding,
    never a crash."""
    samples = gen_test_signal(1, 3000)
    valid = j_native.native_encode(samples, TEST_SAMPLE_RATE, 1, frames_per_chunk=1000)
    cases = []
    for byte_val in (0x01, 0x00, 0x0F, 0xF0, 0xFF, 0x91, 0x19):
        b = bytearray(valid)
        b[22 + 1] = byte_val
        cases.append(bytes(b))
    b = bytearray(valid)
    b[22 + 2] = 0  # zero scale_factor_frames
    cases.append(bytes(b))
    rng = np.random.default_rng(7)
    for _ in range(20):
        b = bytearray(valid)
        for _ in range(6):
            b[rng.integers(0, len(b))] ^= 1 << rng.integers(0, 8)
        cases.append(bytes(b))
    for data in cases:
        assert _outcome(binding.native_decode, data) == _outcome(j_native.native_decode, data)


def test_decode_header_bounds_match_jax_native():
    """A corrupt total_frames cannot drive the allocation past the format's
    bound; a metadata_size past the end is rejected."""
    samples = gen_test_signal(1, 3000)
    valid = j_native.native_encode(samples, TEST_SAMPLE_RATE, 1, frames_per_chunk=1000)
    b = bytearray(valid)
    b[14:18] = (0xFFFFFFFF).to_bytes(4, "little")
    got = _outcome(binding.native_decode, bytes(b))
    assert got == _outcome(j_native.native_decode, bytes(b))
    assert got[0] == "ValueError" or len(got[0]) // 2 <= len(valid) * 8
    b = bytearray(valid)
    b[18:22] = (0xFFFFFF00).to_bytes(4, "little")
    with pytest.raises(ValueError):
        binding.native_decode(bytes(b))
    assert _outcome(j_native.native_decode, bytes(b))[0] == "ValueError"


def _vbr_rows(rng, nc, w, lanes, sff, sfb, residual_size):
    """Random full-chunk search outputs whose rows share their residual
    bits on any set of lanes (the serializer's invariant): each row's sizes
    of a lane a permutation of the first row's."""
    first = np.clip(rng.integers(residual_size - 1, residual_size + 3, size=(w, lanes)), 1, 8)
    sizes = np.stack([rng.permuted(first, axis=0) for _ in range(nc)]).astype(np.uint8)
    sf = rng.integers(0, 1 << sfb, size=(nc, w, lanes)).astype(np.uint8)
    codes = _values(rng, np.repeat(sizes, sff, axis=1), (nc, w * sff, lanes))
    ehist = rng.integers(-(1 << 15), 1 << 15, size=(nc, lanes, 4)).astype(np.int32)
    ewts = rng.integers(-(1 << 15), 1 << 15, size=(nc, lanes, 4)).astype(np.int32)
    return sf, codes, sizes, ehist, ewts


@pytest.mark.parametrize("nc,c,sff,sfb,rs", [(3, 1, 20, 4, 2), (70, 2, 20, 4, 3), (130, 3, 7, 5, 1), (65, 2, 1, 3, 7)])
def test_serialize_full_chunks_same_bytes_with_both_packers(nc, c, sff, sfb, rs, monkeypatch):
    """The native pack (one call a section, threaded rows) and the numpy
    pack (64-row blocks) give the JAX package's bytes, also on a file's
    lanes sliced out of a wider group as ``encode_corpus`` passes them."""
    rng = np.random.default_rng(nc * 31 + c)
    arrays = _vbr_rows(rng, nc, 12, c + 2, sff, sfb, rs)
    lanes = slice(1, 1 + c)
    args = [a[:, :, lanes] for a in arrays[:3]] + [a[:, lanes] for a in arrays[3:]]
    want = j_batch.serialize_full_chunks(*args, sfb, sff, rs)
    before = binding.pack_calls
    native = batch.serialize_full_chunks(*args, sfb, sff, rs)
    assert binding.pack_calls == before + 3
    monkeypatch.setattr(batch.native, "available", lambda: False)
    numpy = batch.serialize_full_chunks(*args, sfb, sff, rs)
    assert binding.pack_calls == before + 3
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(numpy, want)


@pytest.fixture
def fresh_binding(monkeypatch, tmp_path):
    """The binding as in a new process, with the build cache in
    ``tmp_path``; the memo of the process comes back afterwards."""
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_checked", False)
    monkeypatch.setenv("SEA_TORCH_CACHE", str(tmp_path / "cache"))
    cache._resolve.cache_clear()
    yield tmp_path / "cache"
    cache._resolve.cache_clear()


def test_a_failing_compiler_raises_with_its_log(fresh_binding, tmp_path, monkeypatch):
    """No silent fallback to numpy: a compiler that runs and fails raises,
    and leaves no library (or temporary file) behind."""
    bad = tmp_path / "sea_native.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(binding, "SRC", bad)
    builds = binding.builds
    with pytest.raises(RuntimeError, match=r"failed for sea_native-[0-9a-f]{12}\.so:\n(.|\n)*error"):
        binding.available()
    assert binding.builds == builds + 1
    assert list(fresh_binding.iterdir()) == []


def test_library_named_by_source_hash_in_the_cache(fresh_binding, tmp_path, monkeypatch):
    """The build goes into the cache under the source's hash, is loaded
    from there by the next process, and an edited source gets a new name."""
    builds = binding.builds
    assert binding.available()
    assert binding.builds == builds + 1
    path = binding.lib_path()
    assert path.parent == fresh_binding and path.exists()
    assert [p.name for p in fresh_binding.iterdir()] == [path.name]
    assert cache.cache_entries() == 0  # the kernels' count: lib*.so only
    edited = tmp_path / "sea_native.cpp"
    edited.write_text(binding.SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(binding, "SRC", edited)
    assert binding.lib_path() != path and binding.lib_path().parent == fresh_binding


WARM_CHILD = """
import os, sys
import numpy as np
from sea_codec_torch.native import binding
from sea_codec_torch.utils import cache
cold = binding.available()
binding._checked = False
cache._resolve.cache_clear()
os.environ["SEA_TORCH_CACHE"] = sys.argv[1]
warm = binding.available()
enc = binding.native_encode(np.arange(3000, dtype=np.int16), 8000, 1, frames_per_chunk=1000)
print(cold, warm, binding.builds, binding.compiler(), len(enc))
"""


def test_warm_cache_loads_without_a_compiler(fresh_binding, tmp_path):
    """A child with an empty ``PATH``: with an empty cache there is nothing
    to build with (``available()`` False); with the cache this process
    built into it loads the library and encodes, building nothing."""
    assert binding.available()
    warm = fresh_binding
    env = dict(os.environ, PYTHONPATH=REPO, PATH="", SEA_TORCH_CACHE=str(tmp_path / "empty"))
    out = subprocess.run([sys.executable, "-c", WARM_CHILD, str(warm)], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    cold, warm_ok, builds, found, n = out.stdout.split()
    assert (cold, warm_ok, builds, found) == ("False", "True", "0", "None") and int(n) > 0


def _call(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("flags", [["-b", "3"], ["-v", "-b", "2.5"]], ids=["cbr", "vbr"])
def test_cli_native_backend_matches_jax_cli(flags, tmp_path, capsys):
    """``--backend native`` on both CLIs: the same ``.sea`` bytes and the
    same ``.wav`` back; the port's is given no ``--device`` (the native
    backend never asks for the card)."""
    wav = tmp_path / "in.wav"
    write_wav(gen_test_signal(2, 3000), 2, TEST_SAMPLE_RATE, str(wav))
    outs = {}
    for name, main in (("j", j_cli.main), ("t", cli.main)):
        sea, back = tmp_path / f"{name}.sea", tmp_path / f"{name}.wav"
        rc, _o, err = _call(main, [str(wav), str(sea), "-c", "1000", *flags, "--backend", "native"], capsys)
        assert rc == 0, err
        rc, _o, err = _call(main, [str(sea), str(back), "--backend", "native"], capsys)
        assert rc == 0, err
        outs[name] = (sea.read_bytes(), back.read_bytes())
    assert outs["t"] == outs["j"]


def test_cli_native_backend_refuses_a_corrupt_stream(tmp_path, capsys):
    bad = tmp_path / "bad.sea"
    bad.write_bytes(b"SEAC" + bytes(40))
    got = _call(cli.main, [str(bad), str(tmp_path / "t.wav"), "--backend", "native"], capsys)
    want = _call(j_cli.main, [str(bad), str(tmp_path / "j.wav"), "--backend", "native"], capsys)
    assert got == want
    assert got[0] == 1 and "Failed to decode frame" in got[2]
