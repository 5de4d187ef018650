"""The per-layer metrics of the corpus decode's drain in a traced run on the
CPU: ``decode_corpus.drain_ms`` reads the ``decode_fetch`` and
``decode_assemble`` stages; ``decode_corpus.pinned_batches`` reads a counter
that stays at 0 where nothing goes through pinned memory, so the line leaves
it out."""

from __future__ import annotations

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("name", ["vbr3-library-decode", "cbr3-library-decode"])
def test_decode_reads_the_drain_stages(name):
    metrics = run_tiny(name, traced=True)["metrics"]
    assert metrics["decode_corpus.drain_ms"]["unit"] == "ms" and metrics["decode_corpus.drain_ms"]["value"] > 0
    assert "decode_corpus.pinned_batches" not in metrics
