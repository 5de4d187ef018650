"""Host layer of the PyTorch port against the JAX package: tables, bit
packing, the container and the LMS helpers are equal, and the plain
closed-form dequantization equals the table build over every
(sfb, rs, scale factor, code). Integer codec: every comparison is exact."""

from __future__ import annotations

import glob
import io
import os

import numpy as np
import pytest
import torch

from sea_codec_torch import container as t_container
from sea_codec_torch.ops import bitpack as t_bitpack
from sea_codec_torch.ops import lms as t_lms
from sea_codec_torch.ops import tables as t_tables
from sea_codec_torch.ops.device_decode import _dequant_window_constants, dequant_values
from sea_codec_tpu import container as j_container
from sea_codec_tpu.ops import bitpack as j_bitpack
from sea_codec_tpu.ops import lms as j_lms
from sea_codec_tpu.ops import tables as j_tables

torch.set_num_threads(1)

FIXTURES = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "*.npz"))
)


@pytest.mark.parametrize("sfb", range(1, 9))
def test_tables_equal_jax(sfb):
    for rs in range(1, 9):
        for fn in ("scale_factors", "reciprocals", "dqt"):
            np.testing.assert_array_equal(
                getattr(t_tables, fn)(rs, sfb), getattr(j_tables, fn)(rs, sfb)
            )
        assert t_tables.rs_curve_constants(rs) == j_tables.rs_curve_constants(rs)
    np.testing.assert_array_equal(t_tables.quant_tab(), j_tables.quant_tab())
    np.testing.assert_array_equal(t_tables.quant_offsets(), j_tables.quant_offsets())
    assert t_tables.LMS_LEN == j_tables.LMS_LEN


@pytest.mark.parametrize("sfb", range(1, 9))
def test_plain_dequant_equals_dqt_table(sfb):
    """Every (rs, sf, code) through the closed form == tables.dqt."""
    s = 1 << sfb
    for rs in range(1, 9):
        n_codes = 1 << rs
        sf = torch.arange(s, dtype=torch.uint8).reshape(1, s, 1)
        sfval, c0, stepf, endv, kmax = _dequant_window_constants(sf, sfb, rs)
        codes = torch.arange(n_codes, dtype=torch.int64)
        got = dequant_values(codes[None, :], sfval.reshape(s, 1), c0, stepf, endv, kmax)
        np.testing.assert_array_equal(got.numpy(), j_tables.dqt(rs, sfb))


@pytest.mark.parametrize("width", range(1, 9))
def test_bitpack_round_trip(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << width, 1001).astype(np.uint8)
    packed = t_bitpack.pack_bits(vals, width)
    np.testing.assert_array_equal(packed, j_bitpack.pack_bits(vals, width))
    np.testing.assert_array_equal(t_bitpack.unpack_bits(packed, width, count=1001), vals)
    rows = rng.integers(0, 1 << width, (3, 77)).astype(np.uint8)
    prow = j_bitpack.pack_bits_rows(rows, width)
    np.testing.assert_array_equal(t_bitpack.unpack_bits_rows(prow, width, 77), rows)
    widths = rng.integers(1, 9, 300)
    var = (rng.integers(0, 256, 300) & ((1 << widths) - 1)).astype(np.uint8)
    pv = t_bitpack.pack_bits(var, widths)
    np.testing.assert_array_equal(pv, j_bitpack.pack_bits(var, widths))
    np.testing.assert_array_equal(t_bitpack.unpack_bits(pv, widths), var)


def _chunks(mod, encoded):
    reader = io.BytesIO(encoded)
    header = mod.SeaFileHeader.from_reader(reader)
    body = encoded[header.serialized_len :]
    remaining = header.total_frames
    chunks = []
    for pos in range(0, len(body), header.chunk_size):
        chunk = mod.SeaChunk.from_bytes(body[pos : pos + header.chunk_size], header, remaining)
        remaining -= chunk.frames_in_chunk
        chunks.append(chunk)
    return header, chunks


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: os.path.basename(p)[:-4])
def test_container_parse_serialize_equal(path):
    encoded = np.load(path)["encoded"].tobytes()
    th, tc = _chunks(t_container, encoded)
    jh, jc = _chunks(j_container, encoded)
    assert th.serialize() == jh.serialize()
    rebuilt = th.serialize() + b"".join(c.serialize() for c in tc)
    assert rebuilt == encoded
    for a, b in zip(tc, jc):
        assert a.serialize() == b.serialize()
        np.testing.assert_array_equal(a.residuals, b.residuals)
        np.testing.assert_array_equal(a.scale_factors, b.scale_factors)


def test_lms_helpers_equal_jax():
    """predict/update/penalty with weights large enough to wrap int32."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    h = rng.integers(-32768, 32768, (64, 4)).astype(np.int32)
    w = rng.integers(-(1 << 31), 1 << 31, (64, 4), dtype=np.int64).astype(np.int32)
    dq = rng.integers(-27090, 27091, 64).astype(np.int32)
    th, tw = torch.from_numpy(h).long(), torch.from_numpy(w).long()
    pred = t_lms.predict(th, tw)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(j_lms.predict(jnp.asarray(h), jnp.asarray(w))))
    recon = t_lms.clamp_i16(pred + torch.from_numpy(dq).long())
    nh, nw = t_lms.update(th, tw, recon, torch.from_numpy(dq).long())
    jh, jw = j_lms.update(jnp.asarray(h), jnp.asarray(w), jnp.asarray(recon.numpy().astype(np.int32)), jnp.asarray(dq))
    np.testing.assert_array_equal(nh.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(nw.numpy(), np.asarray(jw))
    pen = t_lms.weights_penalty(tw).numpy().view(np.uint64)
    np.testing.assert_array_equal(pen, np.asarray(j_lms.weights_penalty(jnp.asarray(w))))
    np.testing.assert_array_equal(t_lms.initial_weights(3).numpy(), j_lms.initial_weights(3))
    np.testing.assert_array_equal(t_lms.initial_history(3).numpy(), j_lms.initial_history(3))
