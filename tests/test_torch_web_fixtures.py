"""The PyTorch port held to ``web/test_fixtures.json`` on the CPU
(``device="cpu"``: the plain versions of the kernels).

That file (written by ``scripts/gen_web_fixtures.py`` from the JAX package)
holds 53 streams: the 5 golden fixtures with their input PCM and settings,
and 48 decode-only streams (the reference-anchored VBR matrix and a seeded
subset of the anchored-stream fuzz), each with its expected PCM. The JS
decoder and the JAX, batch and C++ decoders are held to it; here the port's
batch engine, its sessions and its native host codec decode every stream,
and both engines encode the goldens. Integer codec: every comparison is
exact. The JSON is read directly, so this file imports nothing of the JAX
package."""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, native, sea_decode, sea_encode

torch.set_num_threads(1)

FIXTURES = json.loads((Path(__file__).resolve().parent.parent / "web" / "test_fixtures.json").read_text())
NAMES = sorted(FIXTURES)
GOLDENS = [n for n in NAMES if not FIXTURES[n].get("decode_only")]


def _b64(name, key) -> bytes:
    return base64.b64decode(FIXTURES[name][key])


def _pcm(name, key) -> np.ndarray:
    return np.frombuffer(_b64(name, key), dtype="<i2")


def test_fixture_set():
    """All 53 streams, 18,700 samples of expected PCM, 5 goldens to encode."""
    assert len(NAMES) == 53 and len(GOLDENS) == 5
    assert sum(_pcm(n, "decoded").size for n in NAMES) == 18_700


@pytest.mark.parametrize("engine", ["batch", "session"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_fixture(name, engine):
    fx = FIXTURES[name]
    dec = sea_decode(_b64(name, "encoded"), engine=engine, device="cpu")
    assert (dec.sample_rate, dec.channels) == (fx["rate"], fx["channels"])
    np.testing.assert_array_equal(dec.samples, _pcm(name, "decoded"))


@pytest.mark.parametrize("name", NAMES)
def test_native_decode_matches_fixture(name):
    if not native.available():
        pytest.skip("no host C++ compiler for the native codec")
    fx = FIXTURES[name]
    pcm, rate, channels = native.native_decode(_b64(name, "encoded"))
    assert (rate, channels) == (fx["rate"], fx["channels"])
    np.testing.assert_array_equal(pcm, _pcm(name, "decoded"))


@pytest.mark.parametrize("engine", ["batch", "session"])
@pytest.mark.parametrize("name", GOLDENS)
def test_encode_matches_fixture(name, engine):
    fx = FIXTURES[name]
    st = EncoderSettings(
        scale_factor_bits=fx["sfb"],
        scale_factor_frames=fx["sff"],
        residual_bits=fx["rb"],
        frames_per_chunk=fx["fpc"],
        vbr=fx["vbr"],
    )
    enc = sea_encode(_pcm(name, "input"), fx["rate"], fx["channels"], st, engine=engine, device="cpu")
    assert enc == _b64(name, "encoded")
