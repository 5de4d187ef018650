"""The plain reference (``benchmark/reference``) against the port's CPU
paths at a tiny size, and the frozen yardstick (``benchmark/roofline.py``)
against ``chip_smoke.py``'s counts at the main path's shape."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts benchmark/ and the checkout on sys.path)
from reference import bits, codec, tables


def _signal(frames, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / 44100
    sig = np.stack([np.sin(2 * np.pi * rng.uniform(100, 4000) * t) * rng.uniform(2000, 20000),
                    np.sign(np.sin(2 * np.pi * rng.uniform(50, 900) * t)) * rng.uniform(1000, 9000)], 1)
    return (sig + rng.normal(0, 300, (frames, 2))).clip(-32768, 32767).astype(np.int16).reshape(-1)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("vbr", [False, True])
def test_reference_equals_the_port(vbr, seed):
    """Files the port encodes are the reference's chunk by chunk (re-encoded
    from each chunk's entry state), and the reference decodes them as the
    port does."""
    from sea_codec_torch import batch
    from sea_codec_torch.encoder import EncoderSettings

    fpc, frames = 200, 200 * 3 + 57
    lay = codec.Layout(2, fpc, 4, 20, 3.0, vbr)
    sig = _signal(frames, seed)
    enc = batch.encode_sea(sig, 44100, 2, EncoderSettings(frames_per_chunk=fpc, vbr=vbr), device="cpu")
    cs = lay.chunk_bytes()
    assert enc[:22] == codec.header_bytes(lay, 44100, frames, cs)
    body = torch.from_numpy(np.frombuffer(enc, np.uint8, offset=22).copy())
    full, tail = body[: 3 * cs].view(3, cs), body[3 * cs:][None]
    f, ft = codec.parse(lay, fpc, full), codec.parse(lay, 57, tail)
    pcm = torch.cat([codec.decode(p["hist"], p["wts"], p["sf"], p["sizes"], p["codes"], 4, 20).reshape(-1)
                     for p in (f, ft)]).numpy()
    assert np.array_equal(pcm, batch.decode_sea(enc, device="cpu").samples)
    assert torch.equal(codec.serialize(lay, fpc, f["hist"], f["wts"], f["sf"], f["codes"], f["sizes"] if vbr else None),
                       full)
    x = torch.zeros(4, fpc, 2, dtype=torch.int64)
    x.view(-1)[: frames * 2] = torch.from_numpy(sig.astype(np.int64))
    nv = torch.tensor([[20] * 10] * 3 + [[20, 20, 17] + [0] * 7])
    hist, wts = torch.cat([f["hist"], ft["hist"]]), torch.cat([f["wts"], ft["wts"]])
    prev = torch.zeros(4, 2, dtype=torch.int64)
    prev[1:] = codec.last_scale_factors(lay, full)
    sf, codes, sizes, h, w, _p = codec.encode(lay, x, nv, hist, wts, prev, torch.tensor([fpc] * 3 + [57]))
    assert torch.equal(codec.serialize(lay, fpc, hist[:3], wts[:3], sf[:3], codes[:3], None if sizes is None
                                       else sizes[:3]), full)
    t_row = codec.serialize(lay, 57, hist[3:], wts[3:], sf[3:, :3], codes[3:, :57], None if sizes is None
                            else sizes[3:, :3])
    assert torch.equal(t_row, tail)
    assert torch.equal(codec.wrap16(h[:3]), hist[1:]) and torch.equal(codec.wrap16(w[:3]), wts[1:])


def test_tables_equal_the_port():
    from sea_codec_torch.ops import tables as port

    for sfb in (1, 4, 8):
        for rs in range(1, 9):
            assert np.array_equal(tables.dqt(rs, sfb), port.dqt(rs, sfb))
            assert np.array_equal(tables.reciprocals(rs, sfb), port.reciprocals(rs, sfb))
    assert np.array_equal(np.concatenate([tables.quant(rs) for rs in range(1, 9)]), port.quant_tab())
    from sea_codec_torch.models import vbr as port_vbr

    for rb in (1.5, 2.5, 3.0, 4.2, 7.9):
        t = tables.normalized_vbr_bitrate(rb, 5120, 4, 20)
        assert t == port_vbr.normalized_vbr_bitrate(rb, 5120, 4, 20)
        assert tables.interpolate_distribution(512, t) == port_vbr.interpolate_distribution(512, t)
        assert tables.vbr_header_size(rb, t) == port_vbr.chunk_residual_size(rb, t)


@pytest.mark.parametrize("width", [1, 2, 3, 5, 8, "var"])
def test_bits_round_trip(width):
    g = torch.Generator().manual_seed(3)
    if width == "var":
        w = torch.randint(1, 9, (1, 37), generator=g).expand(4, 37)
        v = torch.randint(0, 256, (4, 37), generator=g) % (1 << w)
    else:
        w = width
        v = torch.randint(0, 1 << width, (4, 37), generator=g)
    packed = bits.pack(v, w)
    total = 37 * width if width != "var" else int(w[0].sum())
    assert packed.shape == (4, (total + 7) // 8)
    assert torch.equal(bits.unpack(packed, w, 37), v)


def test_work_counts_equal_the_smoke():
    """roofline.py's frozen counts give chip_smoke.py's numbers at the main
    path's shape, [1550, 5120, 2] full chunks (sfb 4, sff 20, CBR 3 bits;
    VBR at the VBR main path's sizes)."""
    import chip_smoke
    import roofline

    n, f, c, sff, sfb = 1550, 5120, 2, 20, 4
    w = f // sff
    samples = n * f * c
    cbr = roofline.search_work(n * f, c, f, sff, sfb, vbr=False)
    assert cbr["bytes"] == samples * 2 + samples + n * w * c * 9 + 2 * n * c * 16
    assert cbr["ops"] == tuple(samples * 16 * k for k in chip_smoke.SEARCH_OPS_PER_STEP)
    vbr = roofline.search_work(n * f, c, f, sff, sfb, vbr=True)
    assert vbr["bytes"] == 2 * samples * 2 + samples + 2 * n * w * c * 9 + n * w * c + 2 * n * c * 16
    assert vbr["ops"] == tuple(2 * samples * 16 * k for k in chip_smoke.SEARCH_OPS_PER_STEP)
    rng = np.random.default_rng(5)
    for is_vbr in (False, True):
        rs = rng.integers(1, 5, (n, w, c)).astype(np.uint8) if is_vbr else np.full((n, w, c), 3, np.uint8)
        b = types.SimpleNamespace(sf=np.zeros((n, w, c), np.uint8), rs=rs, scale_factor_frames=sff,
                                  residual_size=0 if is_vbr else 3)
        code_bytes = chip_smoke.code_bytes(b, f)
        per_chunk = ((rs.astype(np.int64).sum(axis=(1, 2)) * sff + 7) // 8)
        mine = roofline.sum_work(roofline.decode_work(f, c, sff, int(cb), is_vbr) for cb in per_chunk)
        assert mine["ops"] == chip_smoke.decode_ops(b, f)
        rs_bytes = rs.nbytes if is_vbr else 0
        assert mine["bytes"] == code_bytes + b.sf.nbytes + rs_bytes + 2 * n * c * 4 * 4 + n * f * c * 2
