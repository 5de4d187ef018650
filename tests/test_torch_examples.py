"""Smoke-run every script in examples/torch/ (the PyTorch port's
walkthroughs) on the CPU at tiny shapes, and hold the port's transcode
example to the JAX package's.

Each example asserts its own correctness property internally (byte/sample
identity, metadata round trip). The children of this file start together
(``children``) and each test waits for its own: one subprocess a script,
single-threaded (``OMP_NUM_THREADS=1``), so the file costs about its
slowest child in wall time. Integer codec: the two transcodes' WAV files
must be byte-identical."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (ROOT / "examples" / "torch").glob("*.py"))
JAX_EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*.py"))

# tests/test_examples.py's tiny shapes, on the CPU
ARGS = {
    "transcode.py": ["--frames", "12000", "--fpc", "1000", "--device", "cpu"],
    "streaming.py": ["--frames", "12000", "--fpc", "1000", "--device", "cpu"],
    "seek.py": ["--frames", "30000", "--start", "12345", "--count", "500", "--device", "cpu"],
    "corpus.py": ["--files", "3", "--frames", "3000", "--fpc", "1000", "--mesh", "--device", "cpu"],
    "distributed.py": ["--files", "4", "--frames", "300", "--fpc", "200", "--device", "cpu"],
    "metadata.py": ["--device", "cpu"],
}
TRANSCODE = ["--frames", "12000", "--fpc", "1000"]
TIMEOUT_S = 600
# a failure of the distributed example's rendezvous, not of the codec:
# retried once (its port is picked free, then bound by the workers)
RENDEZVOUS_ERRORS = ("Address already in use", "Connection refused", "ECONNREFUSED", "EADDRINUSE")


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


class Children:
    """Child processes started at once, output to files; ``result(key)``
    waits for one and returns (exit code, stdout, stderr)."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        self.procs: dict[str, tuple[list, dict, subprocess.Popen]] = {}

    def start(self, key: str, argv: list, env: dict) -> None:
        out = open(self.tmp / f"{key}.out", "w")
        err = open(self.tmp / f"{key}.err", "w")
        with out, err:
            proc = subprocess.Popen([str(a) for a in argv], stdout=out, stderr=err, env=env, cwd=str(ROOT))
        self.procs[key] = (argv, env, proc)

    def result(self, key: str) -> tuple[int, str, str]:
        _argv, _env, proc = self.procs[key]
        rc = proc.wait(timeout=TIMEOUT_S)
        return rc, (self.tmp / f"{key}.out").read_text(), (self.tmp / f"{key}.err").read_text()

    def rerun(self, key: str) -> tuple[int, str, str]:
        argv, env, _proc = self.procs[key]
        self.start(key, argv, env)
        return self.result(key)

    def close(self) -> None:
        for _argv, _env, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child this file checks, started together: each port example at
    its tiny shape (the CBR transcode writing its WAV), and the VBR
    transcode and both JAX transcodes for the parity test."""
    tmp = tmp_path_factory.mktemp("examples_torch")
    kids = Children(tmp)
    try:
        for name in EXAMPLES:
            extra = ["--out", tmp / "torch_cbr.wav"] if name == "transcode.py" else []
            kids.start(name, [sys.executable, ROOT / "examples" / "torch" / name, *ARGS[name], *extra], _env())
        kids.start("torch_vbr", [sys.executable, ROOT / "examples" / "torch" / "transcode.py", *TRANSCODE,
                                 "--vbr", "--device", "cpu", "--out", tmp / "torch_vbr.wav"], _env())
        for mode, flags in (("cbr", []), ("vbr", ["--vbr"])):
            kids.start(f"jax_{mode}", [sys.executable, ROOT / "examples" / "transcode.py", *TRANSCODE, *flags,
                                       "--out", tmp / f"jax_{mode}.wav"], _env(JAX_PLATFORMS="cpu"))
        yield kids
    finally:
        kids.close()


def test_every_torch_example_has_smoke_args():
    """The port has one example for each JAX example, under the same name,
    and each has its tiny arguments here."""
    assert EXAMPLES == JAX_EXAMPLES, "examples/torch/ and examples/ out of sync"
    assert set(EXAMPLES) == set(ARGS), "examples/torch/ and ARGS out of sync"


@pytest.mark.parametrize("name", EXAMPLES)
def test_torch_example_runs(name, children):
    rc, out, err = children.result(name)
    if rc and name == "distributed.py" and any(m in out + err for m in RENDEZVOUS_ERRORS):
        rc, out, err = children.rerun(name)
    assert rc == 0, f"{name} failed:\n{out}\n{err}"
    assert out.strip(), f"{name} printed nothing"


@pytest.mark.parametrize("mode", ["cbr", "vbr"])
def test_transcode_wav_matches_jax(mode, children):
    """``examples/transcode.py`` (JAX, on the CPU) and
    ``examples/torch/transcode.py --device cpu`` write the same WAV bytes."""
    port = "transcode.py" if mode == "cbr" else "torch_vbr"
    for key in (port, f"jax_{mode}"):
        rc, out, err = children.result(key)
        assert rc == 0, f"{key} failed:\n{out}\n{err}"
    got = (children.tmp / f"torch_{mode}.wav").read_bytes()
    want = (children.tmp / f"jax_{mode}.wav").read_bytes()
    assert len(got) > 44 and got == want


def test_example_without_card_exits_nonzero():
    """Without ``--device`` an example asks for the card; with none visible
    it exits non-zero with ``resolve_device``'s message and prints no
    result: it never goes on on the CPU."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / "seek.py")],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(CUDA_VISIBLE_DEVICES=""), cwd=str(ROOT),
    )
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr, proc.stderr
    assert "decoded frames" not in proc.stdout
