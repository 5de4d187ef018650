"""One-shot round trip of the PyTorch port (``device="cpu"``: the plain
versions of the kernels) against the JAX package and the committed
fixtures, CBR and VBR: the same ``.sea`` bytes and the same decoded PCM,
bit for bit. The session engine gives the batch engine's bytes and PCM; an
unknown engine raises."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, sea_decode, sea_encode
from sea_codec_torch.batch import split_chunks
from sea_codec_torch.utils.errors import SeaInvalidFile
from sea_codec_tpu import EncoderSettings as JaxSettings
from sea_codec_tpu.batch import decode_sea as jax_decode
from sea_codec_tpu.batch import encode_sea as jax_encode
from sea_codec_tpu.utils.errors import SeaInvalidFile as JaxInvalidFile
from sea_codec_tpu.utils.signal import varied_signal

torch.set_num_threads(1)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    return np.load(os.path.join(FIXTURE_DIR, name + ".npz"))


@pytest.mark.parametrize(
    "name",
    ["cbr_stereo_b3", "cbr_8ch_b8", "cbr_mono_b1_ragged", "vbr_stereo_b25", "vbr_mono_b5_ragged"],
)
def test_fixture_round_trip(name):
    fx = _fixture(name)
    st = EncoderSettings(
        scale_factor_bits=int(fx["sfb"]),
        scale_factor_frames=int(fx["sff"]),
        residual_bits=float(fx["rb"]),
        frames_per_chunk=int(fx["fpc"]),
        vbr=bool(fx["vbr"]),
    )
    encoded = sea_encode(fx["input"], int(fx["sample_rate"]), int(fx["channels"]), st, device="cpu")
    assert encoded == fx["encoded"].tobytes()
    out = sea_decode(encoded, device="cpu")
    assert (out.channels, out.sample_rate) == (int(fx["channels"]), int(fx["sample_rate"]))
    np.testing.assert_array_equal(out.samples, fx["decoded"])


@pytest.mark.parametrize(
    "channels,frames,fpc,sff,sfb,rb",
    [
        (1, 400, 160, 20, 4, 3.0),
        (2, 333, 96, 16, 2, 1.0),
        (2, 480, 120, 10, 8, 5.0),
        (8, 150, 64, 8, 5, 8.0),
        (1, 250, 250, 25, 3, 2.7),
        (3, 90, 120, 20, 6, 4.0),
        (2, 0, 96, 16, 4, 3.0),  # empty: the header alone
        (2, 37, 96, 16, 4, 3.0),  # the tail chunk alone
    ],
)
def test_seeded_round_trip_matches_jax(channels, frames, fpc, sff, sfb, rb):
    sig = varied_signal(channels, frames, seed=frames + channels)
    kw = dict(
        scale_factor_bits=sfb, scale_factor_frames=sff, residual_bits=rb,
        frames_per_chunk=fpc, metadata="title=x\n",
    )
    encoded = sea_encode(sig, 44100, channels, EncoderSettings(**kw), device="cpu")
    assert encoded == jax_encode(sig, 44100, channels, JaxSettings(**kw))
    if not frames:  # a header with chunk_size 0, which both decoders reject
        assert_both_reject(encoded)
        return
    header, _rect, _tail = split_chunks(encoded)
    assert (header.channels, header.total_frames, header.frames_per_chunk) == (channels, frames, fpc)
    out = sea_decode(encoded, device="cpu")
    np.testing.assert_array_equal(out.samples, jax_decode(encoded).samples)
    assert out.samples.shape == (frames * channels,)


def assert_both_reject(encoded: bytes) -> None:
    """The port's and the JAX package's decoders reject ``encoded`` with
    the same message."""
    with pytest.raises(SeaInvalidFile) as got:
        sea_decode(encoded, device="cpu")
    with pytest.raises(JaxInvalidFile) as want:
        jax_decode(encoded)
    assert str(got.value) == str(want.value)


def test_vbr_and_session_raise():
    """VBR and the session engine encode and decode; only an unknown engine
    raises, and the session decoder raises on a stream with no header."""
    from sea_codec_torch.utils.errors import SeaError

    sig = varied_signal(1, 200, seed=1)
    st = EncoderSettings(vbr=True, residual_bits=2.5)
    encoded = sea_encode(sig, 8000, 1, st, device="cpu")
    assert sea_decode(encoded, device="cpu").samples.shape == sig.shape
    assert sea_encode(sig, 8000, 1, st, engine="session", device="cpu") == encoded
    np.testing.assert_array_equal(
        sea_decode(encoded, engine="session", device="cpu").samples,
        sea_decode(encoded, device="cpu").samples,
    )
    with pytest.raises(ValueError, match="engine must be"):
        sea_encode(sig, 8000, 1, engine="stream", device="cpu")
    with pytest.raises(ValueError, match="engine must be"):
        sea_decode(encoded, engine="stream", device="cpu")
    with pytest.raises(SeaError):
        sea_decode(b"", engine="session", device="cpu")
