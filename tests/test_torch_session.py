"""The streaming sessions of the PyTorch port (``device="cpu"``) against the
JAX package's sessions and the port's batch engine: the same ``.sea`` bytes
and the same PCM, CBR and VBR, in streaming mode and after a seek. Mirrors
the JAX package's streaming tests. Integer codec: exact equality."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, SeaDecoder, SeaEncoder, sea_decode, sea_encode
from sea_codec_torch.utils.errors import SeaEncoderClosed, SeaError, SeaInvalidParameters
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, gen_test_signal, varied_signal
from sea_codec_tpu import EncoderSettings as JaxSettings
from sea_codec_tpu import SeaEncoder as JaxEncoder
from sea_codec_tpu import sea_decode as jax_decode
from sea_codec_tpu import sea_encode as jax_encode
from sea_codec_tpu.utils import signal as j_signal

torch.set_num_threads(1)


class SharedBuffer:
    """A pipe: writes append, reads drain from the front."""

    def __init__(self):
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf += data
        return len(data)

    def read(self, n: int) -> bytes:
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def flush(self):
        pass


def _settings(vbr, fpc, **kw):
    return dict(frames_per_chunk=fpc, residual_bits=2.5 if vbr else 3.0, vbr=vbr, **kw)


def test_signal_copies_match_the_jax_package():
    np.testing.assert_array_equal(gen_test_signal(2, 3000), j_signal.gen_test_signal(2, 3000))
    np.testing.assert_array_equal(varied_signal(3, 500, 4), j_signal.varied_signal(3, 500, 4))


@pytest.mark.parametrize("vbr", [False, True])
@pytest.mark.parametrize("channels,frames,fpc", [(2, 1730, 480), (1, 960, 320), (3, 500, 640)])
def test_session_engine_matches_jax_and_batch(vbr, channels, frames, fpc):
    """``engine="session"`` bytes == the JAX session's == the port's batch
    engine's; session PCM == the JAX session's == the batch engine's. Covers
    a ragged tail, an exact multiple and a tail-only file."""
    kw = _settings(vbr, fpc)
    sig = varied_signal(channels, frames, seed=frames + channels)
    enc = sea_encode(sig, TEST_SAMPLE_RATE, channels, EncoderSettings(**kw), engine="session", device="cpu")
    assert enc == jax_encode(sig, TEST_SAMPLE_RATE, channels, JaxSettings(**kw), engine="session")
    assert enc == sea_encode(sig, TEST_SAMPLE_RATE, channels, EncoderSettings(**kw), device="cpu")
    dec = sea_decode(enc, engine="session", device="cpu")
    assert (dec.channels, dec.sample_rate) == (channels, TEST_SAMPLE_RATE)
    np.testing.assert_array_equal(dec.samples, jax_decode(enc, engine="session").samples)
    np.testing.assert_array_equal(dec.samples, sea_decode(enc, device="cpu").samples)


@pytest.mark.parametrize("vbr", [False, True])
def test_streaming_matches_batch(vbr):
    """Interleaved chunk-by-chunk encode and decode through a pipe, header
    unknown in advance: the stream's bytes equal the JAX session's, and the
    PCM the batch round trip's."""
    channels = 2
    kw = _settings(vbr, 500)
    samples = gen_test_signal(channels, 6017)
    frames = samples.shape[0] // channels
    samples = samples[: frames * channels]
    st = EncoderSettings(**kw)
    batch = sea_decode(sea_encode(samples, TEST_SAMPLE_RATE, channels, st, device="cpu"), device="cpu")

    pipe = SharedBuffer()
    wire = bytearray()
    tee = type("Tee", (), {
        "write": lambda self, d: (wire.extend(d), pipe.write(d))[1],
        "flush": lambda self: None,
    })()
    out = io.BytesIO()
    reader = io.BytesIO(samples.astype("<i2").tobytes())
    enc = SeaEncoder(channels, TEST_SAMPLE_RATE, None, st, reader, tee, device="cpu")
    assert enc.encode_frame()  # header + first chunk; then attach the decoder
    dec = SeaDecoder(pipe, out, device="cpu")
    more = True
    while more:
        more = enc.encode_frame()
        dec.decode_frame()
    enc.finalize()
    # streaming mode cannot parse a short final chunk: drain the full ones
    while True:
        try:
            if not dec.decode_frame():
                break
        except SeaError:
            break
    streamed = np.frombuffer(out.getvalue(), dtype="<i2")
    assert streamed.size >= (frames // 500) * 500 * channels
    np.testing.assert_array_equal(streamed, batch.samples[: streamed.size])

    j_pipe = SharedBuffer()
    j_enc = JaxEncoder(channels, TEST_SAMPLE_RATE, None, JaxSettings(**kw),
                       io.BytesIO(samples.astype("<i2").tobytes()), j_pipe)
    while j_enc.encode_frame():
        pass
    assert bytes(wire) == j_pipe.read(10**9)
    assert int.from_bytes(wire[14:18], "little") == 0  # total_frames unknown


def test_explicit_streaming_mode_writes_header_upfront():
    pipe = SharedBuffer()
    SeaEncoder(1, TEST_SAMPLE_RATE, 0, EncoderSettings(), io.BytesIO(b""), pipe, device="cpu")
    data = pipe.read(10**9)
    assert data[0:4] == b"seac"
    assert int.from_bytes(data[6:8], "little") == 0  # chunk_size unknown


@pytest.mark.parametrize("vbr", [False, True])
def test_session_seek_bit_exact(vbr):
    channels, fpc = 2, 320
    st = EncoderSettings(**_settings(vbr, fpc))
    samples = gen_test_signal(channels, 2003 * channels)
    frames = samples.shape[0] // channels
    encoded = sea_encode(samples, TEST_SAMPLE_RATE, channels, st, device="cpu")
    full = jax_decode(encoded).samples
    for target in (0, fpc, 777, frames - 1, frames):  # aligned, mid-chunk, tail, EOF
        out = io.BytesIO()
        dec = SeaDecoder(io.BytesIO(encoded), out, device="cpu")
        pos = dec.seek(target)
        assert pos == (target // fpc) * fpc
        while dec.decode_frame():
            pass
        got = np.frombuffer(out.getvalue(), dtype="<i2")
        np.testing.assert_array_equal(got, full[pos * channels :])


def test_session_seek_rejects_bad_targets():
    samples = gen_test_signal(1, 1500)
    encoded = sea_encode(samples, TEST_SAMPLE_RATE, 1, EncoderSettings(frames_per_chunk=500), device="cpu")
    dec = SeaDecoder(io.BytesIO(encoded), io.BytesIO(), device="cpu")
    with pytest.raises(SeaError):
        dec.seek(-1)
    with pytest.raises(SeaError):
        dec.seek(samples.shape[0] + 1)
    pipe = SharedBuffer()
    pipe.write(encoded)
    with pytest.raises(SeaError):
        SeaDecoder(pipe, io.BytesIO(), device="cpu").seek(0)

    class TellOnly(io.BytesIO):
        def seek(self, *a, **k):
            raise OSError("backward seek unsupported")

    with pytest.raises(SeaError, match="seekable"):
        SeaDecoder(TellOnly(encoded), io.BytesIO(), device="cpu").seek(0)


def test_encoder_session_errors():
    """The u16 chunk_size bound, a finished encoder, and ragged input bytes
    raise the JAX session's errors."""
    st = EncoderSettings(frames_per_chunk=5120, residual_bits=8.0)
    pcm = np.zeros(5120 * 16, np.int16)
    enc = SeaEncoder(16, 44100, 5120, st, io.BytesIO(pcm.tobytes()), io.BytesIO(), device="cpu")
    with pytest.raises(SeaInvalidParameters, match="more than 65535 bytes"):
        enc.encode_frame()
    with pytest.raises(SeaInvalidParameters):
        SeaEncoder(0, 44100, None, EncoderSettings(), io.BytesIO(), io.BytesIO(), device="cpu")

    small = EncoderSettings(frames_per_chunk=40, scale_factor_frames=20)
    enc = SeaEncoder(1, 8000, None, small, io.BytesIO(np.zeros(50, "<i2").tobytes()), io.BytesIO(), device="cpu")
    assert enc.encode_frame() and not enc.encode_frame()
    with pytest.raises(SeaEncoderClosed):
        enc.encode_frame()
    from sea_codec_torch.utils.errors import SeaReadError

    enc = SeaEncoder(2, 8000, None, small, io.BytesIO(b"\0" * 6), io.BytesIO(), device="cpu")
    with pytest.raises(SeaReadError):
        enc.encode_frame()


@pytest.mark.parametrize("entry", ["encoder", "decoder", "encode", "decode"])
def test_sessions_default_to_cuda(entry):
    """Without ``device=`` the sessions target the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    st = EncoderSettings(frames_per_chunk=40, scale_factor_frames=20)
    pcm = np.zeros(64, np.int16)
    encoded = sea_encode(pcm, 8000, 1, st, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "encoder":
            SeaEncoder(1, 8000, None, st, io.BytesIO(), io.BytesIO())
        elif entry == "decoder":
            SeaDecoder(io.BytesIO(encoded), io.BytesIO())
        elif entry == "encode":
            sea_encode(pcm, 8000, 1, st, engine="session")
        else:
            sea_decode(encoded, engine="session")
