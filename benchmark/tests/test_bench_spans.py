"""The per-layer metrics that read the program's spans and counter inside
``batch.decode_range`` and VBR ``batch.encode_corpus``, in a traced run on
the CPU."""

from __future__ import annotations

from conftest import run_tiny


def test_seek_reads_the_range_stages():
    metrics = run_tiny("cbr3-seek", traced=True)["metrics"]
    for name in ("decode_range.split_ms", "decode_range.parse_ms", "decode_range.decode_ms"):
        assert metrics[name]["unit"] == "ms" and metrics[name]["value"] > 0, name


def test_vbr_encode_reads_the_pack_stage_and_the_launch_count():
    """The pack stage is timed; no kernel is launched on the CPU, so the
    launch count reads 0."""
    metrics = run_tiny("vbr3-library-encode", traced=True)["metrics"]
    assert metrics["encode_corpus.pack_ms.vbr"]["value"] > 0
    launches = metrics["encode_corpus.search_launches.vbr"]
    assert launches == {"value": 0, "unit": "launches"}
