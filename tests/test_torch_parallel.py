"""The PyTorch port's mesh pipelines (``sea_codec_torch.parallel.pipeline``
and the ``mesh`` argument of ``batch.encode_corpus``/``decode_corpus``) on
meshes of repeated CPU entries, against the JAX package's on its virtual
8-device CPU mesh and against the port's unsharded paths. Integer codec:
every comparison is exact."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from sea_codec_torch import EncoderSettings, batch, sea_decode, sea_encode
from sea_codec_torch.ops.device_decode import decode_chunks
from sea_codec_torch.parallel import pipeline
from sea_codec_torch.utils.signal import TEST_SAMPLE_RATE, gen_test_signal, varied_signal
from sea_codec_tpu import EncoderSettings as JaxSettings
from sea_codec_tpu import batch as j_batch
from sea_codec_tpu.parallel import pipeline as j_pipeline

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(n):
    return pipeline.make_mesh(devices=[CPU] * n)


def _jax_encode(samples, c, st):
    """The JAX package's one-file encode at the same settings: the port's
    ``encode_sea`` is the corpus encode of one file, so the mesh paths are
    held to this independent reference instead."""
    return j_batch.encode_sea(samples, TEST_SAMPLE_RATE, c, JaxSettings(**dataclasses.asdict(st)))


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_grid_matches_jax(n):
    """The same most-square files x chunks factorization as the JAX
    package's ``make_mesh`` over its n virtual devices."""
    mesh = pipeline.make_mesh(n, devices=[CPU] * 8)
    assert mesh.devices.shape == j_pipeline.make_mesh(n).devices.shape
    assert mesh.axis_names == ("files", "chunks") and mesh.size == n
    assert mesh.flat == [CPU] * n


def test_make_mesh_refuses_bad_requests():
    with pytest.raises(ValueError):
        pipeline.make_mesh(3, devices=[CPU] * 2)
    with pytest.raises(ValueError):
        pipeline.make_mesh(devices=["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline.make_mesh()


def test_shard_chunk_batch_row_ranges():
    """Contiguous row ranges, one per entry in the mesh's flat order, the
    first ``n % size`` one row longer; entries past the rows get none."""
    assert pipeline.row_ranges(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert pipeline.row_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    a = np.arange(10 * 3).reshape(10, 3)
    b = torch.arange(10)
    parts = pipeline.shard_chunk_batch(_mesh(4), a, b)
    assert [len(p[0]) for p in parts] == [3, 3, 2, 2]
    np.testing.assert_array_equal(np.concatenate([p[0].numpy() for p in parts]), a)
    assert torch.equal(torch.cat([p[1] for p in parts]), b)
    assert all(t.device == CPU for p in parts for t in p)
    with pytest.raises(ValueError):
        pipeline.shard_chunk_batch(_mesh(2), a, b[:5])


@pytest.mark.parametrize("vbr", [False, True])
def test_decode_chunk_batch_sharded_equals_decode_chunks(vbr):
    """Chunk-parallel decode of a parsed file over a 4-entry mesh equals
    ``decode_chunks`` over the whole batch, and the file's PCM."""
    st = EncoderSettings(frames_per_chunk=100, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    sig = gen_test_signal(2, 1300)
    enc = sea_encode(sig, TEST_SAMPLE_RATE, 2, st, device="cpu")
    _header, (codes, sf, rs, hist, wts, sfb), frames_real = batch.parse_file(enc)
    pcm = pipeline.decode_chunk_batch_sharded(_mesh(4), codes, sf, rs, hist, wts, sfb, 20)
    args = (torch.from_numpy(a) for a in (codes, sf, rs, hist, wts))
    want = decode_chunks(*args, sfb=sfb, sff=20).numpy()
    np.testing.assert_array_equal(pcm, want)
    got = np.concatenate([pcm[i, : frames_real[i]].reshape(-1) for i in range(len(pcm))])
    np.testing.assert_array_equal(got, sea_decode(enc, device="cpu").samples)


def test_decode_chunk_batch_sharded_takes_tensors():
    """Tensors (here on the CPU) decode as the numpy arrays they hold, over
    a 3-entry mesh whose last entry gets one row fewer."""
    st = EncoderSettings(frames_per_chunk=100, residual_bits=3.0)
    enc = sea_encode(gen_test_signal(2, 1100), TEST_SAMPLE_RATE, 2, st, device="cpu")
    _header, (codes, sf, rs, hist, wts, sfb), _frames = batch.parse_file(enc)
    arrays = (codes, sf, rs, hist, wts)
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    got = pipeline.decode_chunk_batch_sharded(_mesh(3), *tensors, sfb, 20)
    np.testing.assert_array_equal(got, pipeline.decode_chunk_batch_sharded(_mesh(1), *arrays, sfb, 20))
    np.testing.assert_array_equal(got, decode_chunks(*tensors, sfb=sfb, sff=20).numpy())


def test_corpus_transcode_step_matches_jax():
    """Encode + decode of a [4, 4, 10, 2] corpus over a 2 x 2 mesh: PCM and
    codes equal to the JAX step's on its 8-device mesh, and the PCM to the
    port's per-file round trip."""
    sff, fpc, nc, c, nf = 5, 10, 4, 2, 4
    rng = np.random.default_rng(3)
    samples = (rng.standard_normal((nf, nc, fpc, c)) * 2000).astype(np.int32)
    pcm, codes = pipeline.corpus_transcode_step(_mesh(4), samples, 3, 4, sff)
    j_pcm, j_codes = j_pipeline.corpus_transcode_step(
        j_pipeline.make_mesh(8), samples, residual_size=3, scale_factor_bits=4, scale_factor_frames=sff
    )
    assert pcm.dtype == np.int16 and codes.dtype == np.uint8
    np.testing.assert_array_equal(pcm, np.asarray(j_pcm))
    np.testing.assert_array_equal(codes, np.asarray(j_codes))
    st = EncoderSettings(frames_per_chunk=fpc, scale_factor_frames=sff, residual_bits=3.0)
    for f in range(nf):
        flat = samples[f].astype(np.int16).reshape(-1)
        want = sea_decode(sea_encode(flat, TEST_SAMPLE_RATE, c, st, device="cpu"), device="cpu").samples
        np.testing.assert_array_equal(pcm[f].reshape(-1), want)


def test_corpus_transcode_step_entries_without_files():
    """More entries than files: the empty entries encode nothing and the
    chunks still cover every entry; out-of-range samples and windows that
    do not tile a chunk are refused."""
    rng = np.random.default_rng(4)
    samples = (rng.standard_normal((1, 3, 20, 1)) * 3000).astype(np.int32)
    one = pipeline.corpus_transcode_step(_mesh(1), samples, 2, 3, 10)
    five = pipeline.corpus_transcode_step(_mesh(5), samples, 2, 3, 10)
    for a, b in zip(one, five):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="int16"):
        pipeline.corpus_transcode_step(_mesh(2), samples * 100, 2, 3, 10)
    with pytest.raises(ValueError, match="multiple"):
        pipeline.corpus_transcode_step(_mesh(2), samples, 2, 3, 7)


def test_deal_files_longest_first_to_the_least_loaded():
    assert pipeline.deal_files([5, 9, 1, 7, 3], 2) == [[1, 4, 2], [3, 0]]
    assert pipeline.deal_files([4, 4, 4], 4) == [[0], [1], [2], []]
    assert pipeline.deal_files([], 3) == [[], [], []]


@pytest.mark.parametrize("vbr", [False, True])
def test_encode_corpus_mesh_matches_unsharded_and_jax(vbr, monkeypatch):
    """Ragged, exact-multiple, sub-chunk and empty files over a 3-entry
    mesh, at most two files a lane group, in slabs of one chunk (two
    files) or two (one file): bytes equal to ``mesh=None`` and to the JAX
    package's ``encode_corpus``."""
    c = 2
    lens = [260, 250, 100, 73, 0, 199, 400]
    files = [varied_signal(c, n, seed=40 + i) for i, n in enumerate(lens)]
    kw = dict(frames_per_chunk=100, scale_factor_frames=10, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    st = EncoderSettings(**kw)
    monkeypatch.setattr(batch, "_GROUP_DEVICE_BYTES", 2 * c * 100 * batch._LANE_FRAME_BYTES)
    got = batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, mesh=_mesh(3))
    assert got == batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, device="cpu")
    assert got == j_batch.encode_corpus(files, TEST_SAMPLE_RATE, c, JaxSettings(**kw))


@pytest.mark.parametrize("depth", [0, 1, 4])
@pytest.mark.parametrize("slab", [1, 2])
@pytest.mark.parametrize("vbr", [False, True])
def test_encode_corpus_mesh_runs_groups_in_slabs(vbr, slab, depth, monkeypatch):
    """Over a 3-entry mesh with a device-memory bound of ``slab`` chunks
    for the lanes of three files, each entry runs its group slab by slab
    with the carry, the entries' slabs in turn: every file, ragged, exact,
    sub-chunk and empty, byte-identical to the JAX package's per-file
    ``encode_sea``."""
    c, fpc = 2, 50
    lens = [333, 260, 190, 50, 41, 0, 120, 275]
    files = [varied_signal(c, n, seed=60 + i) for i, n in enumerate(lens)]
    st = EncoderSettings(frames_per_chunk=fpc, scale_factor_frames=10, residual_bits=2.5 if vbr else 3.0, vbr=vbr)
    monkeypatch.setattr(batch, "_GROUP_DEVICE_BYTES", slab * 3 * c * fpc * batch._LANE_FRAME_BYTES)
    got = batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, pipeline_depth=depth, mesh=_mesh(3))
    assert got == [_jax_encode(f, c, st) for f in files]


def test_encode_corpus_mesh_runs_every_entry(monkeypatch):
    """Each group runs on the entry it is dealt to, entries in turn; a
    device is one entry, as a mesh of one entry is, and runs the same
    loop; a mesh and a device together are refused."""
    c = 1
    files = [varied_signal(c, n, seed=n) for n in (90, 300, 150, 220)]
    st = EncoderSettings(frames_per_chunk=100, scale_factor_frames=10)
    ran = []
    real = pipeline.Shard.on

    def on(self):
        ran.append(id(self))
        return real(self)

    monkeypatch.setattr(pipeline.Shard, "on", on)
    want = batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, device="cpu")
    assert len(ran) == 1  # one entry, its one lane group in one slab
    ran.clear()
    assert batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, mesh=_mesh(2)) == want
    assert len(ran) == 2 and ran[0] != ran[1]
    assert batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, mesh=_mesh(1)) == want
    with pytest.raises(ValueError, match="mesh or a device"):
        batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="mesh or a device"):
        batch.decode_corpus([want[0]], mesh=_mesh(2), device="cpu")


def test_decode_corpus_mesh_matches_unsharded():
    """CBR and VBR files with ragged tails and a tail-only file over a
    4-entry mesh, in batches of 3 chunks (each split over the entries, some
    entries idle): the PCM of ``mesh=None``, and the JAX package's."""
    c = 2
    sig = gen_test_signal(c, 1500)
    st = EncoderSettings(frames_per_chunk=100, scale_factor_frames=10)
    stv = EncoderSettings(frames_per_chunk=100, scale_factor_frames=10, residual_bits=2.5, vbr=True)
    encs = [sea_encode(sig[: f * c], TEST_SAMPLE_RATE, c, s, device="cpu")
            for f in (700, 690, 77, 300) for s in (st, stv)]
    got = batch.decode_corpus(encs, device_batch=3, mesh=_mesh(4))
    want = batch.decode_corpus(encs, device_batch=3, device="cpu")
    j_want = j_batch.decode_corpus(encs)
    for g, w, j in zip(got, want, j_want):
        np.testing.assert_array_equal(g.samples, w.samples)
        np.testing.assert_array_equal(g.samples, np.asarray(j.samples))
        assert (g.channels, g.sample_rate) == (w.channels, w.sample_rate)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_corpus_fuzz(seed):
    """Random configurations and lengths through the mesh corpus paths:
    bytes equal to the JAX package's per-file ``encode_sea`` and PCM to
    the port's ``decode_sea``."""
    rng = np.random.default_rng(1234 + seed)
    c = int(rng.choice([1, 2, 3]))
    sfb = int(rng.integers(3, 6))
    sff = int(rng.choice([5, 10, 20]))
    fpc = sff * int(rng.integers(4, 8))
    vbr = bool(rng.integers(0, 2)) if seed else True
    rb = float(rng.integers(2, 5)) + (0.5 if vbr else 0.0)
    st = EncoderSettings(scale_factor_bits=sfb, scale_factor_frames=sff, residual_bits=rb,
                         frames_per_chunk=fpc, vbr=vbr)
    sig = varied_signal(c, 2 * fpc + 7, seed=seed)
    files = [sig[: int(rng.integers(1, 2 * fpc + 7)) * c] for _ in range(int(rng.integers(3, 7)))]
    mesh = _mesh(int(rng.integers(2, 5)))
    got = batch.encode_corpus(files, TEST_SAMPLE_RATE, c, st, mesh=mesh)
    for i in range(len(files)):
        assert got[i] == _jax_encode(files[i], c, st), (seed, i)
    dec = batch.decode_corpus(got, device_batch=2, mesh=mesh)
    for i in rng.choice(len(files), size=2, replace=False):
        np.testing.assert_array_equal(dec[i].samples, sea_decode(got[i], device="cpu").samples)

