"""The benchmark's harness on the CPU: BENCHMARK.json against the contract,
the result line, the faults and the control that the check must refuse,
and what the harness imports."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT, run_tiny

CELLS = ["cbr3-library-encode", "vbr3-library-decode", "cbr3-seek", "vbr3-library-encode"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    n = len(bench["workloads"])
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(x) for x in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        entry = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["entry"]
        assert NAME.match(entry) and (BENCH / "entries" / f"{entry}.py").is_file()
        assert 1 <= len(w["why"]) <= 200
    assert n >= 1 and len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == n


def test_metrics_follow_the_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert m["name"] == "setup_s" or (BENCH / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in bench["workloads"]}
    reports = lambda m, cell: "workloads" not in m or cell in m["workloads"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(reports(m, cell) for m in bench["end_to_end"] if m["name"] != "setup_s")
        assert any(reports(m, cell) for m in bench["per_layer"])


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, traced, bench):
    out = run_tiny(name, traced=traced)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert json.loads(json.dumps(out)) == out
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and UNIT.match(m["unit"])
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        host = {m["name"] for m in bench["per_layer"] if m["source"] == "host_clock" and name in m["workloads"]}
        assert host <= set(out["metrics"])  # read on the host, so present on the CPU too
    else:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def _altered(real):
    def entry(*a, **k):
        out = real(*a, **k)
        if isinstance(out, np.ndarray):
            out = out.copy()
            out[len(out) // 2] ^= 1
            return out
        first = out[0]
        if isinstance(first, bytes):
            b = bytearray(first)
            b[len(b) // 2] ^= 1
            return [bytes(b)] + list(out[1:])
        first.samples = first.samples.copy()
        first.samples[len(first.samples) // 2] ^= 1
        return out
    return entry


def _half(real):
    def entry(*a, **k):
        out = real(*a, **k)
        return out[: len(out) // 2]
    return entry


def _other_start(real):
    """Every file started from LMS weights that are not the encoder's, the
    state written into its first chunk's header as the bytes were made
    from it: a file consistent with itself, and not the upstream one."""
    import torch

    def weights(c, device="cpu"):
        return real(c, device) + torch.tensor([3, -2, 5, -7], dtype=torch.int32, device=device)
    return weights


def _stateless(real):
    """Every chunk encoded from the file's initial state: the LMS carry
    and the previous scale factor never reach the next chunk."""
    def entry(files, sample_rate, channels, settings, **k):
        fpc = settings.frames_per_chunk
        whole = real(files, sample_rate, channels, settings, **k)
        out = []
        for pcm, enc in zip(files, whole):
            pieces = [pcm[i:i + fpc * channels] for i in range(0, len(pcm), fpc * channels)]
            alone = real(pieces, sample_rate, channels, settings, **k)
            out.append(enc[:22] + b"".join(a[22:] for a in alone))
        return out
    return entry


FAULTS = [
    ("cbr3-library-encode", "encode_corpus", _altered), ("cbr3-library-encode", "encode_corpus", _half),
    ("cbr3-library-encode", "encode_corpus", _stateless), ("vbr3-library-encode", "encode_corpus", _stateless),
    ("cbr3-library-encode", "lms_init_weights", _other_start), ("vbr3-library-encode", "lms_init_weights", _other_start),
    ("vbr3-library-decode", "decode_corpus", _altered), ("vbr3-library-decode", "decode_corpus", _half),
    ("cbr3-seek", "decode_range", _altered), ("cbr3-seek", "decode_range", _half),
]


@pytest.mark.parametrize("name,entry,fault", FAULTS, ids=[f"{n}-{f.__name__[1:]}" for n, _e, f in FAULTS])
def test_check_refuses_a_broken_program(monkeypatch, name, entry, fault):
    from sea_codec_torch import batch

    monkeypatch.setattr(batch, entry, fault(getattr(batch, entry)))
    out = run_tiny(name)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", ["cbr3-library-encode", "vbr3-library-decode"])
def test_a_corpus_cell_runs_on_a_mesh(name):
    """A cell on four cards hands the corpus entry a mesh of four (here
    four entries of the CPU), and the check holds it to the reference."""
    out = run_tiny(name, chips=4)
    assert out["correct"] is True and out["device"]["count"] == 4, out["checks"]


def test_a_seek_cell_takes_no_mesh():
    with pytest.raises(ValueError, match="takes no mesh"):
        run_tiny("cbr3-seek", chips=4)


@pytest.mark.parametrize("config,traffic", [("sea-vbr3-stereo44k", "seek"), ("sea-cbr3-stereo44k", "library-decode")])
def test_a_new_cell_needs_data_only(config, traffic):
    """A pair of configuration and mix that BENCHMARK.json does not hold yet
    (VBR seeks, CBR library decode) runs and is checked from its files
    alone."""
    out = run_tiny("cbr3-seek", config=config, traffic=traffic)
    assert out["correct"] is True and out["attempted"] > 0, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_check_refuses_the_control(name):
    out = run_tiny(name, control=True)
    assert out["correct"] is False, out["checks"]


def _modules_after(code: str) -> list[str]:
    child = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(' '.join(sys.modules))"],
                           capture_output=True, text=True, timeout=300, cwd=ROOT,
                           env={"PYTHONPATH": f"{BENCH}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert child.returncode == 0, child.stderr[-2000:]
    return child.stdout.split()


def test_the_harness_loads_no_jax():
    from seabench.harness import FORBIDDEN, forbidden_modules

    mods = _modules_after("import run, roofline, control\n"
                          "from seabench import harness, driver, readers, traffic, trace, spec\n"
                          "harness.load_program('cpu')\n"
                          "bench = spec.load_json(spec.ROOT / 'BENCHMARK.json')\n"
                          "for m in bench['per_layer'] + bench['end_to_end'][:-1]:\n"
                          "    spec.metric_reader(m['name'])\n"
                          "for w in bench['workloads']:\n"
                          "    spec.entry_driver(spec.load_cell(w['name']).traffic['entry'])")
    assert "sea_codec_torch" in {m.split(".")[0] for m in mods}
    assert forbidden_modules(mods) == []
    # the comparison is by whole top-level names: the port's name begins with the JAX package's
    assert forbidden_modules(["sea_codec_torch.batch", "jaxtyping"]) == []
    assert forbidden_modules(["sea_codec_tpu.ops", "jax.numpy"]) == sorted({"sea_codec_tpu", "jax"} & set(FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    mods = {m.split(".")[0] for m in _modules_after("import reference.codec, reference.tables, reference.bits")}
    assert not mods & {"sea_codec_torch", "sea_codec_tpu", "jax", "jaxlib", "flax"}


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    child = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0], "--seed", "1",
                            "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                           cwd=ROOT)
    assert child.returncode != 0 and child.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    child = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", name, "--seed", str(2**31 + 99),
                            "--seconds", "5", "--trace", "0"], capture_output=True, text=True, timeout=900,
                           cwd=ROOT)
    assert child.returncode == 0, child.stderr[-3000:]
    assert json.loads(child.stdout.strip().splitlines()[-1])["correct"] is True
