"""The PyTorch port's device-side row parse (``ops/parse_device.py``,
``device="cpu"`` tensors: the plain versions of the kernels) against the JAX
package's and the host parser, and its decodes against ``decode_sea``;
rows serialized by the port's corpus encode decode without a host parse.
Modelled on the JAX package's ``tests/test_parse_device.py``. Integer
codec: every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, sea_decode, sea_encode
from sea_codec_torch.batch import parse_full_chunks, split_chunks
from sea_codec_torch.ops import encode_file, lms
from sea_codec_torch.ops.parse_device import (
    decode_rows_vbr_device,
    parse_chunks_cbr_device,
    parse_chunks_vbr_device,
    transcode_chunks_cbr_device,
)
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, varied_signal
from sea_codec_tpu.ops import parse_device as j_parse

torch.set_num_threads(1)


def _rows(channels, n_chunks, fpc=200, sff=20, rb=3.0, sfb=4, vbr=False):
    sig = varied_signal(channels, n_chunks * fpc, seed=91)
    st = EncoderSettings(frames_per_chunk=fpc, scale_factor_frames=sff, residual_bits=rb,
                         scale_factor_bits=sfb, vbr=vbr)
    encoded = sea_encode(sig, TEST_SAMPLE_RATE, channels, st, device="cpu")
    header, rect, tail = split_chunks(encoded)
    assert not tail and rect.shape[0] == n_chunks
    return encoded, header, rect


def _check_parse(got, want, j_got):
    res, sf, rs, hist, wts = (t.numpy() for t in got)
    for g, w in zip((sf, rs, hist, wts), (want.sf, want.rs, want.hist, want.wts)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(res[:, : want.res_bytes.shape[1]], want.res_bytes)
    for g, j in zip((res, sf, rs, hist, wts), j_got):
        np.testing.assert_array_equal(g, np.asarray(j))


@pytest.mark.parametrize("channels,rs,sfb", [(1, 3, 4), (2, 3, 4), (2, 1, 3), (3, 8, 5), (2, 2, 8)])
def test_cbr_parse_matches_jax_and_host_parser(channels, rs, sfb):
    _enc, header, rect = _rows(channels, 4, rb=float(rs), sfb=sfb)
    args = (channels, sfb, 20, rs, header.frames_per_chunk)
    got = parse_chunks_cbr_device(torch.from_numpy(rect.copy()), *args)
    _check_parse(got, parse_full_chunks(rect, header), j_parse.parse_chunks_cbr_device(rect, *args))


@pytest.mark.parametrize("channels,rb", [(1, 2.5), (2, 2.5), (2, 5.0), (3, 4.0)])
def test_vbr_parse_matches_jax_and_host_parser(channels, rb):
    _enc, header, rect = _rows(channels, 4, rb=rb, vbr=True)
    residual_size = int(rect[0, 1]) & 0x0F
    args = (channels, 4, 20, residual_size, header.frames_per_chunk)
    got = parse_chunks_vbr_device(torch.from_numpy(rect.copy()), *args)
    _check_parse(got, parse_full_chunks(rect, header), j_parse.parse_chunks_vbr_device(rect, *args))


@pytest.mark.parametrize("vbr", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_device_decodes_match_decode_sea(channels, vbr):
    """decode(parse(rows)) on the rows' device == the one-shot decode, and
    == the JAX package's device decode of the same rows."""
    encoded, header, rect = _rows(channels, 4, rb=2.5 if vbr else 3.0, vbr=vbr)
    fpc = header.frames_per_chunk
    args = (channels, 4, 20, int(rect[0, 1]) & 0x0F, fpc)
    fn, j_fn = ((decode_rows_vbr_device, j_parse.decode_rows_vbr_device) if vbr
                else (transcode_chunks_cbr_device, j_parse.transcode_chunks_cbr_device))
    out = fn(torch.from_numpy(rect.copy()), *args)
    assert out.device.type == "cpu" and out.dtype == torch.int16
    want = sea_decode(encoded, device="cpu").samples.reshape(-1, fpc, channels)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_fn(rect, *args)))


def test_transcode_rows_from_the_corpus_encode():
    """The corpus encode's lane-packed rows, serialized on the device, decode
    on the device (no host parse) to the PCM of the per-file round trip."""
    channels, fpc, sff, rs = 2, 200, 20, 3
    nf, nc = 3, 3
    files = [varied_signal(channels, nc * fpc, seed=100 + i) for i in range(nf)]
    b = nf * channels
    x = np.stack([f.reshape(nc, fpc, channels) for f in files], axis=2).reshape(nc, fpc, b)
    frames = torch.full((b,), nc * fpc, dtype=torch.int32)
    h0 = lms.initial_history(channels).repeat(nf, 1)
    w0 = lms.initial_weights(channels).repeat(nf, 1)
    rows = encode_file.corpus_cbr_packed(
        torch.from_numpy(x), frames, torch.full((nf,), nc), h0, w0, torch.zeros(b, dtype=torch.int32),
        scale_factor_frames=sff, scale_factor_bits=4, residual_size=rs, n_files=nf,
    )[0]
    pcm = transcode_chunks_cbr_device(rows.reshape(nf * nc, -1), channels, 4, sff, rs, fpc)
    st = EncoderSettings(frames_per_chunk=fpc, scale_factor_frames=sff, residual_bits=float(rs))
    for i, f in enumerate(files):
        want = sea_decode(sea_encode(f, TEST_SAMPLE_RATE, channels, st, device="cpu"), device="cpu").samples
        np.testing.assert_array_equal(pcm[i * nc : (i + 1) * nc].reshape(-1).numpy(), want)
