"""The decode kernels as custom ops (``sea_codec_torch.ops.custom_ops``), on
the CPU: ``torch.library.opcheck`` on each of the five ops, each public
wrapper reaching its op and equal to its plain version, and the table caches
left unfilled by an export (a fake tensor cached there while tracing would
be handed to every later eager call). Integer codec: exact equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sea_codec_torch.aot import export_rows_decoder
from sea_codec_torch.ops import custom_ops, dequant, fused_decode, fused_decode_vbr, lms_decode, tables

torch.set_num_threads(1)

SFB, SFF = 4, 20
# (chunks, frames, channels): C 1, 2 and 3, each with a partial last window
# (frames % sff != 0), and an empty batch
SHAPES = [(3, 57, 1), (2, 50, 2), (2, 41, 3), (0, 57, 2)]


def _batch(rng, n, frames, c, rs=3):
    """CBR and VBR inputs of one geometry as tensors: residual rows wide
    enough for 8-bit codes, scale factors, per-window sizes 1..8, LMS
    states."""
    w = -(-frames // SFF)
    res = rng.integers(0, 256, (n, frames * c + 2), dtype=np.uint8)
    sf = rng.integers(0, 1 << SFB, (n, w, c), dtype=np.uint8)
    sizes = rng.integers(1, 9, (n, w, c), dtype=np.uint8)
    hist = rng.integers(-32768, 32768, (n, c, 4)).astype(np.int32)
    wts = rng.integers(-(1 << 14), 1 << 14, (n, c, 4)).astype(np.int32)
    dq = rng.integers(-3000, 3000, (frames, n, c)).astype(np.int16)
    return {k: torch.from_numpy(v) for k, v in
            dict(res=res, sf=sf, sizes=sizes, hist=hist, wts=wts, dq=dq).items()}


def _cases(b, frames, rs=3):
    """(op, its arguments, the public wrapper's call, the plain version's
    call) for each of the five ops."""
    res, sf, sizes, hist, wts, dq = (b[k] for k in ("res", "sf", "sizes", "hist", "wts", "dq"))
    kw = dict(sfb=SFB, sff=SFF, frames=frames)
    return {
        "fused_decode_cbr": (
            custom_ops.fused_decode_cbr, (res, sf, hist, wts, SFB, rs, SFF, frames),
            lambda: fused_decode.decode_cbr_fused(res, sf, hist, wts, rs=rs, **kw),
            lambda: fused_decode.decode_cbr_plain(res, sf, hist, wts, rs=rs, **kw)),
        "fused_decode_vbr": (
            custom_ops.fused_decode_vbr, (res, sf, sizes, hist, wts, SFB, SFF, frames),
            lambda: fused_decode_vbr.decode_vbr_fused(res, sf, sizes, hist, wts, **kw),
            lambda: fused_decode_vbr.decode_vbr_plain(res, sf, sizes, hist, wts, **kw)),
        "dequant_cbr": (
            custom_ops.dequant_cbr, (res, sf, SFB, rs, SFF, frames),
            lambda: dequant.unpack_dequant_cbr(res, sf, rs=rs, **kw),
            lambda: dequant.unpack_dequant_cbr_plain(res, sf, rs=rs, **kw)),
        "dequant_vbr": (
            custom_ops.dequant_vbr, (res, sf, sizes, SFB, SFF, frames),
            lambda: dequant.unpack_dequant_vbr(res, sf, sizes, **kw),
            lambda: dequant.unpack_dequant_vbr_plain(res, sf, sizes, **kw)),
        "lms_decode": (
            custom_ops.lms_decode, (dq, hist, wts),
            lambda: lms_decode.lms_decode(dq, hist, wts),
            lambda: lms_decode.lms_decode_plain(dq, hist, wts)),
    }


OPS = ("fused_decode_cbr", "fused_decode_vbr", "dequant_cbr", "dequant_vbr", "lms_decode")


class _OpsCalled(TorchDispatchMode):
    """Records the name of every operator dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.name())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n,frames,c", SHAPES)
def test_opcheck(op, n, frames, c):
    """Schema, autograd registration, the fake implementation against the
    CPU kernel (shapes, dtypes, strides) and the traced op, by
    ``torch.library.opcheck``."""
    rng = np.random.default_rng(1000 * c + frames + n)
    opdef, args, _wrapper, _plain = _cases(_batch(rng, n, frames, c), frames)[op]
    results = torch.library.opcheck(opdef, args)
    assert set(results.values()) == {"SUCCESS"}, results


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n,frames,c", SHAPES)
def test_wrapper_reaches_its_op(op, n, frames, c):
    """The public wrapper dispatches its op (once, and no other of the
    five) and returns what the plain version does."""
    rng = np.random.default_rng(2000 * c + frames + n)
    _opdef, _args, wrapper, plain = _cases(_batch(rng, n, frames, c), frames)[op]
    with _OpsCalled() as seen:
        got = wrapper()
    ours = [name for name in seen.names if name.startswith("sea_codec_torch::")]
    assert ours == [f"sea_codec_torch::{op}"]
    assert type(got) is torch.Tensor
    torch.testing.assert_close(got, plain(), rtol=0, atol=0)


def test_ops_refuse_other_devices():
    """A device other than CPU or CUDA raises in the wrapper, before the
    op: nothing falls back."""
    b = _batch(np.random.default_rng(5), 2, 40, 2)
    meta = {k: v.to("meta") for k, v in b.items()}
    with pytest.raises(ValueError, match="unsupported device meta"):
        fused_decode.decode_cbr_fused(meta["res"], meta["sf"], meta["hist"], meta["wts"],
                                      sfb=SFB, rs=3, sff=SFF, frames=40)
    with pytest.raises(ValueError, match="unsupported device meta"):
        lms_decode.lms_decode(meta["dq"], meta["hist"], meta["wts"])


TABLE_CACHES = (tables.dq_table, tables.kernel_tables, tables.search_kernel_table)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_export_leaves_the_table_caches_real(fused, monkeypatch):
    """An export traces the wrappers with fake tensors; the ops' fake
    implementations touch no table, so the caches stay empty through it,
    and eager calls afterwards get real tensors equal to the plain
    versions."""
    monkeypatch.setenv("SEA_FUSED_PROLOG", fused)
    for cache in TABLE_CACHES:
        cache.cache_clear()
    export_rows_decoder(n_chunks=2, channels=2, frames_per_chunk=60, device="cpu")
    export_rows_decoder(n_chunks=2, channels=2, frames_per_chunk=60, residual_size=2, vbr=True,
                        chunk_size=200, device="cpu")
    assert [cache.cache_info().currsize for cache in TABLE_CACHES] == [0, 0, 0]

    frames, cpu = 57, torch.device("cpu")
    b = _batch(np.random.default_rng(9), 3, frames, 2)
    cases = _cases(b, frames)
    for op in ("fused_decode_cbr", "dequant_vbr"):
        _opdef, _args, wrapper, plain = cases[op]
        got = wrapper()
        assert type(got) is torch.Tensor
        torch.testing.assert_close(got, plain(), rtol=0, atol=0)
    cached = [tables.dq_table(SFB, cpu), *tables.kernel_tables(SFB, cpu), tables.search_kernel_table(SFB, cpu)]
    assert all(type(t) is torch.Tensor for t in cached)
