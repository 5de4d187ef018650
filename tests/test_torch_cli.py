"""The PyTorch port's front ends against the JAX package's: ``seaconv``
(``sea_codec_torch.cli``, ``python -m sea_codec_torch``) and the batch CLI
(``sea_codec_torch.batch_cli``), on the CPU (``--device cpu``). Both CLIs
run in-process with the same arguments: the same exit codes, the same
error text, and byte-identical ``.sea`` and ``.wav`` files."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from sea_codec_torch import batch_cli, cli
from sea_codec_torch.utils.device import resolve_device
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, gen_test_signal
from sea_codec_torch.utils.wav import write_wav
from sea_codec_tpu import batch_cli as j_batch_cli
from sea_codec_tpu import cli as j_cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _call(main, argv, capsys):
    """(exit code, stdout, stderr) of an in-process CLI call."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.wav"
    write_wav(gen_test_signal(2, 3000), 2, TEST_SAMPLE_RATE, str(path))
    return str(path)


@pytest.fixture(scope="module")
def short_wav(tmp_path_factory):
    """Two 200-frame chunks and a tail: for the tests of the surface."""
    path = tmp_path_factory.mktemp("cli") / "short.wav"
    write_wav(gen_test_signal(2, 1100), 2, TEST_SAMPLE_RATE, str(path))
    return str(path)


@pytest.mark.parametrize(
    "args,msg",
    [
        (["-c", "100"], "Chunk size must be between 200 and 32000"),
        (["-c", "64000"], "Chunk size must be between 200 and 32000"),
        (["-s", "2"], "Scale factor bits must be between 3 and 5"),
        (["-s", "6"], "Scale factor bits must be between 3 and 5"),
        (["-d", "13"], "Scale factor frames must be a divisor of chunk size"),
        (["-b", "9"], "Bitrate must be between 1.0 and 8.0"),
        (["-b", "2.5"], "Without VBR, bitrate must be an integer between 1 and 8"),
        (["-b", "1.2", "-v"], "With VBR, bitrate must be between 1.5 and 8.0"),
        (["-b", "x"], "Failed to parse residual bits"),
    ],
)
def test_validation_matches_jax(wav_file, tmp_path, capsys, args, msg):
    """Every validation case of the JAX CLI's tests: the same exit code
    and the same stderr, message for message; no file written."""
    out = str(tmp_path / "o.sea")
    want = _call(j_cli.main, [wav_file, out, *args], capsys)
    got = _call(cli.main, [wav_file, out, *args, *CPU], capsys)
    assert got == want
    assert got[0] == 1 and got[2] == f"Error: {msg}\n"
    assert not os.path.exists(out)


@pytest.mark.parametrize("mode", ["cbr", "vbr"])
def test_encode_decode_bytes_match_jax(wav_file, tmp_path, capsys, mode):
    """``.wav`` -> ``.sea`` -> ``.wav`` at ``-c 200``: the port's files are
    byte-identical to the JAX CLI's, CBR and VBR."""
    flags = ["-c", "200"] + (["-v", "-b", "2.5"] if mode == "vbr" else [])
    names = {k: str(tmp_path / k) for k in ("j.sea", "t.sea", "j.wav", "t.wav")}
    assert _call(j_cli.main, [wav_file, names["j.sea"], *flags], capsys)[0] == 0
    assert _call(cli.main, [wav_file, names["t.sea"], *flags, *CPU], capsys)[0] == 0
    with open(names["j.sea"], "rb") as f, open(names["t.sea"], "rb") as g:
        assert f.read() == g.read()
    assert _call(j_cli.main, [names["j.sea"], names["j.wav"]], capsys)[0] == 0
    assert _call(cli.main, [names["t.sea"], names["t.wav"], *CPU], capsys)[0] == 0
    with open(names["j.wav"], "rb") as f, open(names["t.wav"], "rb") as g:
        assert f.read() == g.read()


def test_metadata_matches_jax(short_wav, tmp_path, capsys):
    """``--metadata`` pairs give the JAX CLI's header bytes; duplicate and
    case-folded keys and a pair without ``=`` die with its message."""
    flags = ["-c", "200", "--metadata", "artist=x", "--metadata", "title=y"]
    j_out, t_out = str(tmp_path / "j.sea"), str(tmp_path / "t.sea")
    assert _call(j_cli.main, [short_wav, j_out, *flags], capsys)[0] == 0
    assert _call(cli.main, [short_wav, t_out, *flags, *CPU], capsys)[0] == 0
    with open(j_out, "rb") as f, open(t_out, "rb") as g:
        assert f.read() == g.read()
    for bad in (["--metadata", "a=1", "--metadata", "a=2"],
                ["--metadata", "A=1", "--metadata", "a=2"],
                ["--metadata", "novalue"]):
        out = str(tmp_path / "d.sea")
        want = _call(j_cli.main, [short_wav, out, *bad], capsys)
        got = _call(cli.main, [short_wav, out, *bad, *CPU], capsys)
        assert got == want and got[0] == 1 and got[2].startswith("Error: ")


def test_stats_show_raw_metadata_as_jax(tmp_path, capsys):
    """``--stats`` on a file whose metadata the lenient parse only partly
    reads: the parsed pairs and the raw line, as the JAX CLI prints them."""
    from sea_codec_tpu import EncoderSettings, sea_encode

    enc = sea_encode(
        gen_test_signal(1, 2000), TEST_SAMPLE_RATE, 1,
        EncoderSettings(frames_per_chunk=1000, metadata="good=1\nmalformed line\n"),
    )
    sea = tmp_path / "raw.sea"
    sea.write_bytes(enc)
    j_rc, j_out, _ = _call(j_cli.main, [str(sea), str(tmp_path / "j.wav"), "--stats"], capsys)
    t_rc, t_out, _ = _call(cli.main, [str(sea), str(tmp_path / "t.wav"), "--stats", *CPU], capsys)
    assert j_rc == t_rc == 0
    meta = lambda text: [ln for ln in text.splitlines() if ln.startswith("metadata")]
    assert meta(t_out) == meta(j_out) == ["metadata: good=1", "metadata (raw): 'good=1\\nmalformed line\\n'"]
    assert t_out.splitlines()[0].startswith("decoded 2000 samples in ")
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()


def test_bad_extensions_match_jax(capsys):
    """Unsupported extensions die as in the JAX CLI, before any device is
    needed."""
    want = _call(j_cli.main, ["a.mp3", "b.ogg"], capsys)
    got = _call(cli.main, ["a.mp3", "b.ogg"], capsys)
    assert got == want
    assert got[0] == 1 and "Invalid file extensions" in got[2]


@pytest.mark.parametrize("backend", ["native", "jax", "torch"])
def test_backends(short_wav, tmp_path, capsys, backend):
    """``torch`` and ``native`` (the C++ host codec) are offered and write
    the bytes of ``auto``; argparse refuses the JAX package's ``jax``."""
    out = tmp_path / "o.sea"
    rc, _out, err = _call(cli.main, [short_wav, str(out), "-c", "200", "--backend", backend, *CPU], capsys)
    if backend == "jax":
        assert rc == 2 and f"invalid choice: '{backend}'" in err and not out.exists()
    else:
        assert rc == 0, err
        auto = tmp_path / "auto.sea"
        assert _call(cli.main, [short_wav, str(auto), "-c", "200", *CPU], capsys)[0] == 0
        assert out.read_bytes() == auto.read_bytes() and out.stat().st_size > 0


@pytest.mark.parametrize("main", [cli.main, batch_cli.main], ids=["cli", "batch_cli"])
def test_cuda_by_default_without_fallback(short_wav, tmp_path, capsys, main):
    """Without ``--device cpu`` both CLIs ask for the card; with none they
    exit non-zero with ``resolve_device``'s error and write nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError) as e:
        resolve_device("cuda")
    out = tmp_path / "out"
    target = str(out) if main is batch_cli.main else str(out) + ".sea"
    rc, _o, err = _call(main, [short_wav, target, "-c", "200"], capsys)
    assert rc == 1 and err == f"Error: {e.value}\n"
    assert not os.path.exists(target)


def test_python_m_subprocess(short_wav, tmp_path, capsys):
    """``python -m sea_codec_torch`` in a fresh interpreter writes the same
    bytes as the in-process call."""
    sub, here = str(tmp_path / "sub.sea"), str(tmp_path / "here.sea")
    r = subprocess.run(
        [sys.executable, "-m", "sea_codec_torch", short_wav, sub, "-c", "200", *CPU],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert _call(cli.main, [short_wav, here, "-c", "200", *CPU], capsys)[0] == 0
    with open(sub, "rb") as f, open(here, "rb") as g:
        assert f.read() == g.read()


def test_batch_cli_round_trip_matches_jax(tmp_path, capsys):
    """The batch CLI on two stereo files: ``.sea`` bytes equal to the JAX
    batch CLI's, then back to ``.wav`` equal to its too; the summary lines
    name the same counts."""
    indir = tmp_path / "wavs"
    indir.mkdir()
    for i, frames in enumerate((3000, 5000)):
        write_wav(gen_test_signal(2, frames), 2, TEST_SAMPLE_RATE, str(indir / f"f{i}.wav"))
    j_sea, t_sea, j_wav, t_wav = (tmp_path / d for d in ("j_sea", "t_sea", "j_wav", "t_wav"))
    rc, j_text, _ = _call(j_batch_cli.main, [str(indir / "*.wav"), str(j_sea), "-c", "200"], capsys)
    assert rc == 0
    rc, t_text, _ = _call(batch_cli.main, [str(indir / "*.wav"), str(t_sea), "-c", "200", *CPU], capsys)
    assert rc == 0
    assert t_text.split(" in ")[0] == j_text.split(" in ")[0]
    for i in range(2):
        assert (t_sea / f"f{i}.sea").read_bytes() == (j_sea / f"f{i}.sea").read_bytes()
    assert _call(j_batch_cli.main, [str(j_sea / "*.sea"), str(j_wav)], capsys)[0] == 0
    assert _call(batch_cli.main, [str(t_sea / "*.sea"), str(t_wav), *CPU], capsys)[0] == 0
    for i in range(2):
        assert (t_wav / f"f{i}.wav").read_bytes() == (j_wav / f"f{i}.wav").read_bytes()


def test_batch_cli_mesh_and_errors(tmp_path, capsys):
    """``--mesh --device cpu`` (a mesh of one entry: the CPU) writes the
    same bytes as the plain run; an empty glob and mixed extensions exit 1
    with the JAX batch CLI's messages."""
    indir = tmp_path / "in"
    indir.mkdir()
    sigs = [gen_test_signal(2, 700 + 100 * i) for i in range(3)]
    for i, s in enumerate(sigs):
        write_wav(s, 2, TEST_SAMPLE_RATE, str(indir / f"f{i}.wav"))
    a, b = tmp_path / "a", tmp_path / "b"
    assert _call(batch_cli.main, [str(indir / "*.wav"), str(a), "-c", "200", "--mesh", *CPU], capsys)[0] == 0
    assert _call(batch_cli.main, [str(indir / "*.wav"), str(b), "-c", "200", *CPU], capsys)[0] == 0
    for i in range(3):
        assert (a / f"f{i}.sea").read_bytes() == (b / f"f{i}.sea").read_bytes()
    (indir / "x.sea").write_bytes((a / "f0.sea").read_bytes())
    for pattern in (str(tmp_path / "none" / "*.wav"), str(indir / "*")):
        want = _call(j_batch_cli.main, [pattern, str(tmp_path / "j")], capsys)
        got = _call(batch_cli.main, [pattern, str(tmp_path / "t"), *CPU], capsys)
        assert got == want and got[0] == 1
