"""The VBR row serializer of the PyTorch port (``ops.serialize_device``) on
the CPU: its plain version, which the wrapper takes for CPU tensors and
which ``chip_smoke.py`` holds the CUDA kernel to on the card, against the
host's ``batch.serialize_full_chunks`` under both packers and the JAX
package's, file by file out of lane-packed slabs; the full chunk's length;
the wrapper's checks; and the encoders' use of it (one launch a VBR slab,
no full chunk packed on the host). Integer codec: every comparison is
exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, batch, sea_encode
from sea_codec_torch.models.vbr import (
    chunk_residual_size,
    interpolate_distribution,
    normalized_vbr_bitrate,
    vbr_base,
)
from sea_codec_torch.native import binding
from sea_codec_torch.ops import serialize_device
from sea_codec_torch.ops.serialize_device import corpus_rows_vbr_device, vbr_chunk_size, vbr_rank_sizes
from sea_codec_torch.utils.profiling import StageTimes
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, varied_signal
from sea_codec_tpu import EncoderSettings as JaxSettings
from sea_codec_tpu import batch as j_batch
from sea_codec_tpu import sea_encode as j_sea_encode

torch.set_num_threads(1)

W = 5  # windows a chunk
FULL = [4, 2, 1]  # each file's full chunks in the slab; its rows past them are garbage


def _slab(rng, c, sfb, sff, rs, nc=max(FULL), w=W, pool=None):
    """Lane-packed search outputs of one slab, ``len(FULL)`` files x ``c``
    channels of ``w`` windows a chunk: every valid (file, chunk) draws its
    sizes as a permutation of one multiset (``pool``, or one drawn of
    rs-1..rs+2 clamped to 1..8), so that every full chunk has the same
    residual bits, as the search's size rule gives; a garbage row's sizes
    are anything, 0 and 9..255 too. Returns the five arrays and the chunk
    size."""
    nf = len(FULL)
    b = nf * c
    if pool is None:
        pool = np.clip(rng.integers(rs - 1, rs + 3, size=w * c), 1, 8)
    sizes = rng.integers(0, 256, size=(nc, w, b)).astype(np.uint8)
    for j, n in enumerate(FULL):
        for k in range(n):
            sizes[k, :, j * c : (j + 1) * c] = rng.permutation(pool).reshape(w, c)
    widths = np.repeat(np.clip(sizes, 1, 8), sff, axis=1).astype(np.int64)
    codes = (rng.integers(0, 256, size=(nc, w * sff, b)) % (1 << widths)).astype(np.uint8)
    sf = rng.integers(0, 1 << sfb, size=(nc, w, b)).astype(np.uint8)
    ehist, ewts = (rng.integers(-(1 << 31), (1 << 31) - 1, size=(nc, b, 4)).astype(np.int32) for _ in range(2))
    fixed = 4 + 16 * c + -(-(w * c * sfb) // 8) + -(-(w * c * 2) // 8)
    return (sf, codes, sizes, ehist, ewts), fixed + -(-(sff * int(pool.sum())) // 8)


@pytest.mark.parametrize("rs", [2, 6])
@pytest.mark.parametrize("sff", [10, 20])
@pytest.mark.parametrize("sfb", [2, 4, 8])
@pytest.mark.parametrize("c", [1, 2, 3, 64])
def test_plain_rows_match_the_host_pack_and_jax(c, sfb, sff, rs, monkeypatch):
    """Each file's valid rows out of the lane-packed slab equal
    ``serialize_full_chunks`` of its lane slice with the native packer and
    with numpy's, and the JAX package's; garbage rows change nothing."""
    rng = np.random.default_rng(1000 * c + 10 * sfb + sff + rs)
    arrays, size = _slab(rng, c, sfb, sff, rs)
    _check_rows(arrays, size, c, sfb, sff, rs, monkeypatch)


def test_plain_rows_match_the_host_pack_at_the_64_channel_geometry(monkeypatch):
    """At ``sea-vbr3-mc64-48k``'s geometry (64 channels, 2,400 frames a
    chunk, sfb 4, sff 20, VBR at 3 bits), 7,680 items a row, which the
    kernel's residuals take in two tiles of at most 4,096 on the card, with
    the sizes the size rule assigns (2, 3 and 4 for 2,943, 4,508 and 229
    items): 57,603-byte rows, each equal to the host's pack and the JAX
    package's."""
    c, fpc, sfb, sff = 64, 2400, 4, 20
    target = normalized_vbr_bitrate(3.0, fpc, sfb, sff)
    m1, _t, p1, p2 = interpolate_distribution(fpc // sff * c, target)
    pool = vbr_rank_sizes(fpc // sff * c, vbr_base(target), (m1, p1, p2))
    assert np.bincount(pool, minlength=5)[1:5].tolist() == [0, 2943, 4508, 229]
    rs = chunk_residual_size(3.0, target)
    arrays, size = _slab(np.random.default_rng(64), c, sfb, sff, rs, w=fpc // sff, pool=pool)
    assert size == vbr_chunk_size(c, fpc, sfb, sff, vbr_base(target), (m1, p1, p2)) == 57_603
    _check_rows(arrays, size, c, sfb, sff, rs, monkeypatch)


def _check_rows(arrays, size, c, sfb, sff, rs, monkeypatch):
    """The plain rows of a slab's ``arrays`` against the host's pack, under
    both packers, and the JAX package's, file by file."""
    got = corpus_rows_vbr_device(*(torch.from_numpy(a) for a in arrays), len(FULL), sfb, sff, rs, size)
    assert got.shape == (len(FULL), max(FULL), size) and got.dtype == torch.uint8
    packers = ["numpy"] + ["native"] * (binding.compiler() is not None)
    for j, n in enumerate(FULL):
        lanes = slice(j * c, (j + 1) * c)
        mine = [a[:n, :, lanes] for a in arrays[:3]] + [a[:n, lanes] for a in arrays[3:]]
        want = j_batch.serialize_full_chunks(*mine, sfb, sff, rs)
        np.testing.assert_array_equal(got[j, :n].numpy(), want)
        for packer in packers:
            with monkeypatch.context() as m:
                m.setattr(batch.native, "available", lambda p=packer: p == "native")
                np.testing.assert_array_equal(batch.serialize_full_chunks(*mine, sfb, sff, rs), want)


@pytest.mark.parametrize(
    "c,fpc,sfb,sff,rb",
    [(2, 5120, 4, 20, 3.0), (2, 500, 4, 20, 2.5), (1, 300, 1, 1, 1.0), (3, 259, 8, 7, 7.5), (64, 200, 4, 20, 3.0)],
)
def test_vbr_chunk_size_is_the_encoders(c, fpc, sfb, sff, rb):
    """A full chunk's length from the size rule alone equals the
    ``chunk_size`` of the JAX package's file (two full chunks and a tail),
    also where the target lies below every size and the counts come out
    negative (sfb 1, sff 1, 1 bit)."""
    target = normalized_vbr_bitrate(rb, fpc, sfb, sff)
    m1, _t, p1, p2 = interpolate_distribution(fpc // sff * c, target)
    pcm = varied_signal(c, 2 * fpc + fpc // 3, seed=fpc + c)
    enc = j_sea_encode(pcm, TEST_SAMPLE_RATE, c, JaxSettings(
        frames_per_chunk=fpc, scale_factor_bits=sfb, scale_factor_frames=sff, residual_bits=rb, vbr=True))
    assert int.from_bytes(enc[6:8], "little") == vbr_chunk_size(c, fpc, sfb, sff, vbr_base(target), (m1, p1, p2))


def _args(**changed):
    rng = np.random.default_rng(5)
    arrays, size = _slab(rng, 2, 4, 20, 3)
    args = dict(zip(("sf", "codes", "sizes", "ehist", "ewts"), (torch.from_numpy(a) for a in arrays)))
    args.update(n_files=len(FULL), scale_factor_bits=4, scale_factor_frames=20, residual_size=3, chunk_size=size)
    args.update(changed)
    return args


@pytest.mark.parametrize(
    "change",
    [
        {"sf": torch.zeros((4, W, 6), dtype=torch.int32)},  # dtype
        {"ehist": torch.zeros((4, 6, 4), dtype=torch.int64)},
        {"codes": torch.zeros((4, W * 20 - 1, 6), dtype=torch.uint8)},  # shape
        {"sizes": torch.zeros((4, W + 1, 6), dtype=torch.uint8)},
        {"ewts": torch.zeros((4, 6, 3), dtype=torch.int32)},
        {"sf": torch.zeros((4, 6, W), dtype=torch.uint8).transpose(1, 2)},  # not contiguous
        {"sizes": torch.zeros((4, W, 6), dtype=torch.uint8, device="meta")},  # device
        {"n_files": 4},  # 6 lanes are not 4 files
        {"scale_factor_bits": 9},
        {"chunk_size": 1 << 16},
        {"chunk_size": 4 + 16 * 2},  # shorter than the sections before the residuals
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change):
    with pytest.raises(ValueError):
        corpus_rows_vbr_device(**_args(**change))


def test_wrapper_refuses_another_device():
    """Every tensor on one device other than the CPU or a card: no plain
    fallback, no launch."""
    meta = {k: v.to("meta") for k, v in _args().items() if torch.is_tensor(v)}
    with pytest.raises(ValueError, match="unsupported device"):
        corpus_rows_vbr_device(**_args(**meta))


@pytest.fixture
def counting_rows(monkeypatch):
    """The plain serializer counts a launch per call, as the kernel's
    launcher does on the card."""
    plain = serialize_device.corpus_rows_vbr_plain

    def counted(*args, **kw):
        serialize_device.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(serialize_device, "corpus_rows_vbr_plain", counted)


@pytest.mark.parametrize("budget_chunks", [1, 2, 100])
def test_encode_corpus_packs_each_vbr_slab_once_on_its_device(budget_chunks, counting_rows, monkeypatch):
    """``encode_corpus`` VBR packs every full chunk through the row
    serializer, one call a slab, and none on the host
    (``serialize_full_chunks`` and the native packer are never called);
    ``encode_serialize_launches_count`` counts them; the bytes are the
    JAX package's."""
    fpc, c = 100, 2
    lens = [437, 250, 99, 0, 512]
    files = [varied_signal(c, n, seed=50 + i) for i, n in enumerate(lens)]
    st = EncoderSettings(frames_per_chunk=fpc, residual_bits=2.5, vbr=True)
    want = [j_sea_encode(f, TEST_SAMPLE_RATE, c, JaxSettings(frames_per_chunk=fpc, residual_bits=2.5, vbr=True))
            for f in files]
    monkeypatch.setattr(batch, "_GROUP_DEVICE_BYTES", budget_chunks * len(lens) * c * fpc * batch._LANE_FRAME_BYTES)
    monkeypatch.setattr(batch, "serialize_full_chunks", None)
    packs, launches = binding.pack_calls, serialize_device.launches
    batch.PIPELINE_TIMES = times = StageTimes()
    try:
        got = batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, device="cpu")
    finally:
        batch.PIPELINE_TIMES = None
    assert got == want
    slabs = sum(len(batch._slabs([lens[i] for i in g], c, fpc, True)) for g in batch._lane_groups(lens, c, fpc))
    assert slabs == -(-5 // budget_chunks)
    assert serialize_device.launches - launches == times["encode_serialize_launches_count"] == slabs
    assert binding.pack_calls == packs


def test_encode_sea_vbr_packs_on_its_device(counting_rows, monkeypatch):
    """``encode_sea`` VBR packs its full chunks through the row serializer
    (one file, one call), not on the host, byte for byte the JAX
    package's."""
    pcm = varied_signal(2, 3 * 500 + 77, seed=9)
    monkeypatch.setattr(batch, "serialize_full_chunks", None)
    launches = serialize_device.launches
    got = sea_encode(pcm, TEST_SAMPLE_RATE, 2, EncoderSettings(frames_per_chunk=500, residual_bits=2.5, vbr=True),
                     device="cpu")
    assert got == j_sea_encode(pcm, TEST_SAMPLE_RATE, 2, JaxSettings(frames_per_chunk=500, residual_bits=2.5, vbr=True))
    assert serialize_device.launches == launches + 1
