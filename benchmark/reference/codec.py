"""The SEA chunk, its decoder and its encoder, in plain PyTorch.

Integer arithmetic runs in int64 tensors; where the format wraps at 32 bits
(the LMS dot product and weights, upstream ``lms.rs``) the value is folded
back to int32 explicitly. Lanes are independent chunks x channels (x
candidate scale factors in the search); the loops over windows and samples
are plain Python loops, as the format defines them.

``pred_dtype=torch.float32`` computes the LMS prediction, and in the search
the division by the scale factor and the rank, in float32: the lower
precision that the benchmark's control runs to show that its comparisons
catch it. Nothing else uses it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import bits, tables

CBR, VBR = 0x01, 0x02
_SIGN64 = -(1 << 63)
_KEY_MAX = (1 << 63) - 1


def wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """The int16 that a chunk header stores of an int32 state value."""
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


@dataclass(frozen=True)
class Layout:
    """A stream's chunk geometry and mode, as its configuration states it."""

    channels: int
    frames_per_chunk: int
    scale_factor_bits: int
    scale_factor_frames: int
    residual_bits: float
    vbr: bool

    @property
    def target(self) -> np.float32:
        return tables.normalized_vbr_bitrate(
            self.residual_bits, self.frames_per_chunk, self.scale_factor_bits, self.scale_factor_frames)

    @property
    def base(self) -> int:
        return tables.vbr_base(self.target)

    @property
    def header_rs(self) -> int:
        """The chunk header's residual size."""
        if self.vbr:
            return tables.vbr_header_size(self.residual_bits, self.target)
        return int(math.floor(self.residual_bits))

    def windows(self, frames: int) -> int:
        return -(-frames // self.scale_factor_frames)

    def window_frames(self, frames: int) -> np.ndarray:
        """Frames in each window of a chunk of ``frames`` frames."""
        sff = self.scale_factor_frames
        return np.minimum(sff, frames - np.arange(self.windows(frames)) * sff)

    def size_counts(self, frames: int) -> tuple[int, int, int, int, int]:
        """VBR: (sortable items, counts of sizes base-1, base, base+1,
        base+2) of a chunk of ``frames`` frames (``encoder_vbr.rs:98-137``)."""
        sortable = frames * self.channels // self.scale_factor_frames
        return (sortable, *tables.interpolate_distribution(sortable, self.target))

    def full_residual_bits(self) -> int:
        fpc, c = self.frames_per_chunk, self.channels
        if not self.vbr:
            return fpc * c * self.header_rs
        _n, m1, t, p1, p2 = self.size_counts(fpc)
        b = self.base
        per_window = sum(n * min(max(s, 1), 8) for n, s in ((m1, b - 1), (t, b), (p1, b + 1), (p2, b + 2)))
        return per_window * self.scale_factor_frames  # a full chunk's windows all hold sff frames

    def chunk_bytes(self, frames: int | None = None, residual_bits: int | None = None) -> int:
        """Bytes of a chunk: a full one by default."""
        f = self.frames_per_chunk if frames is None else frames
        items = self.windows(f) * self.channels
        n = 4 + 16 * self.channels + bits.packed_len(items * self.scale_factor_bits)
        if self.vbr:
            n += bits.packed_len(2 * items)
        if residual_bits is None:
            residual_bits = self.full_residual_bits()
        return n + bits.packed_len(residual_bits)


def header_bytes(layout: Layout, sample_rate: int, total_frames: int, chunk_size: int) -> bytes:
    """The 22-byte file header with no metadata (``file.rs:40-93``)."""
    return (b"seac" + bytes([1, layout.channels]) + chunk_size.to_bytes(2, "little")
            + layout.frames_per_chunk.to_bytes(2, "little") + sample_rate.to_bytes(4, "little")
            + total_frames.to_bytes(4, "little") + (0).to_bytes(4, "little"))


def sample_widths(sizes: torch.Tensor, sff: int, frames: int) -> torch.Tensor:
    """Per-(window, channel) sizes [R, W, C] -> per-sample widths [R, frames * C]."""
    r = sizes.shape[0]
    return sizes.repeat_interleave(sff, dim=1)[:, :frames].reshape(r, -1)


def serialize(layout: Layout, frames: int, hist, wts, sf, codes, sizes=None) -> torch.Tensor:
    """Chunks of ``frames`` frames -> uint8 [R, bytes] (``chunk.rs:215-278``).
    ``hist``/``wts`` [R, C, 4] (stored as int16), ``sf`` and VBR ``sizes``
    [R, W, C], ``codes`` [R, frames, C]."""
    r, c = hist.shape[0], layout.channels
    dev = hist.device
    head = torch.tensor([VBR if layout.vbr else CBR,
                         (layout.scale_factor_bits << 4) | layout.header_rs,
                         layout.scale_factor_frames, 0x5A], dtype=torch.uint8, device=dev)
    lms = torch.cat([hist, wts], dim=2).to(torch.int16).reshape(r, c * 8)
    lms_bytes = torch.stack([(lms & 0xFF), (lms >> 8) & 0xFF], dim=2).to(torch.uint8).reshape(r, -1)
    parts = [head.expand(r, 4), lms_bytes, bits.pack(sf.reshape(r, -1), layout.scale_factor_bits)]
    flat_codes = codes.reshape(r, -1)
    if layout.vbr:
        parts.append(bits.pack(sizes.reshape(r, -1) - layout.header_rs + 1, 2))
        parts.append(bits.pack(flat_codes, sample_widths(sizes, layout.scale_factor_frames, frames)))
    else:
        parts.append(bits.pack(flat_codes, layout.header_rs))
    return torch.cat(parts, dim=1)


def entry_state(rows: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 [R, >= 4 + 16C] chunk starts -> the LMS entry state (hist,
    wts) [R, C, 4] that their headers carry, int64."""
    r = rows.shape[0]
    lms = (rows[:, 4:4 + 16 * c].to(torch.int64).reshape(r, c * 8, 2)
           * torch.tensor([1, 256], device=rows.device)).sum(2)
    lms = torch.where(lms >= 32768, lms - 65536, lms).view(r, c, 8)
    return lms[:, :, :4], lms[:, :, 4:]


def last_scale_factors(layout: Layout, rows: torch.Tensor) -> torch.Tensor:
    """uint8 [R, bytes] full chunks -> int64 [R, C]: the scale factors of
    each chunk's last window, which the encoder carries into the next."""
    c, sfb = layout.channels, layout.scale_factor_bits
    w = layout.windows(layout.frames_per_chunk)
    pos = 4 + 16 * c
    sf = bits.unpack(rows[:, pos:pos + bits.packed_len(w * c * sfb)], sfb, w * c)
    return sf[:, -c:]


def parse(layout: Layout, frames: int, rows: torch.Tensor) -> dict:
    """uint8 [R, bytes] chunks of ``frames`` frames -> their fields:
    ``hist``/``wts`` [R, C, 4], ``sf`` and ``sizes`` [R, W, C], ``codes``
    [R, frames, C] (int64)."""
    r, c = rows.shape[0], layout.channels
    w = layout.windows(frames)
    hist, wts = entry_state(rows, c)
    rows = rows.to(torch.int64)
    pos = 4 + 16 * c
    n_sf = bits.packed_len(w * c * layout.scale_factor_bits)
    sf = bits.unpack(rows[:, pos:pos + n_sf].to(torch.uint8), layout.scale_factor_bits, w * c).view(r, w, c)
    pos += n_sf
    rs = rows[:, 1] & 0x0F
    if layout.vbr:
        n_sz = bits.packed_len(2 * w * c)
        rel = bits.unpack(rows[:, pos:pos + n_sz].to(torch.uint8), 2, w * c).view(r, w, c)
        sizes = rel + rs[:, None, None] - 1
        pos += n_sz
        widths = sample_widths(sizes, layout.scale_factor_frames, frames)
    else:
        sizes = rs[:, None, None].expand(r, w, c)
        widths = int(layout.header_rs)
    codes = bits.unpack(rows[:, pos:].to(torch.uint8), widths, frames * c).view(r, frames, c)
    return dict(hist=hist, wts=wts, sf=sf, sizes=sizes, codes=codes)


class Tables:
    """The flat tables of one scale-factor width on one device: dequantised
    values by (size, scale factor, code) and codes by (size, clamped
    quotient), each with its offsets by size, and the reciprocals."""

    def __init__(self, sfb: int, device):
        s = 1 << sfb
        dq = [np.zeros(0, np.int64)] + [tables.dqt(rs, sfb).reshape(-1) for rs in range(1, 9)]
        qt = [np.zeros(0, np.int64)] + [tables.quant(rs) for rs in range(1, 9)]
        rc = [np.zeros(s, np.int64)] + [tables.reciprocals(rs, sfb) for rs in range(1, 9)]
        sv = [np.ones(s, np.int64)] + [tables.scale_factors(rs, sfb) for rs in range(1, 9)]
        as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        self.dq = as_t(np.concatenate(dq))
        self.dq_off = as_t(np.cumsum([0] + [len(a) for a in dq[:-1]]))
        self.qt = as_t(np.concatenate(qt))
        self.qt_off = as_t(np.cumsum([0] + [len(a) for a in qt[:-1]]))
        self.recip = as_t(np.stack(rc))  # [9, S]
        self.sf = as_t(np.stack(sv))  # [9, S]


def _predict(h, w, pred_dtype):
    if pred_dtype is torch.float32:
        return torch.floor((w.to(torch.float32) * h.to(torch.float32)).sum(-1) / 8192.0).to(torch.int64)
    return wrap32((w * h).sum(-1)) >> 13


def _update(h, w, recon, dq):
    delta = (dq >> 4)[..., None]
    w = wrap32(w + torch.where(h < 0, -delta, delta))
    return torch.cat([h[..., 1:], recon[..., None]], dim=-1), w


def decode(hist, wts, sf, sizes, codes, sfb: int, sff: int, pred_dtype=torch.int64) -> torch.Tensor:
    """Chunks -> int16 PCM [R, F, C]: each chunk from its own entry state
    ``hist``/``wts`` [R, C, 4]; ``sf``/``sizes`` [R, W, C]; ``codes`` [R, F, C]
    (``codec/decoder.rs:36-45``). The dequantised values are looked up a
    block of frames at a time, to bound memory."""
    r, f, c = codes.shape
    t = Tables(sfb, codes.device)
    h, w = hist.to(torch.int64), wts.to(torch.int64)
    out = torch.empty((r, f, c), dtype=torch.int16, device=codes.device)
    block = max(sff, 512 // sff * sff)
    for t0 in range(0, f, block):
        n = min(block, f - t0)
        win = slice(t0 // sff, -(-(t0 + n) // sff))
        per_sample = lambda a: a[:, win].to(torch.int64).repeat_interleave(sff, dim=1)[:, :n]
        rs = per_sample(sizes)
        dq = t.dq[t.dq_off[rs] + (per_sample(sf) << rs) + codes[:, t0:t0 + n].to(torch.int64)]
        for i in range(n):
            d = dq[:, i]
            recon = (_predict(h, w, pred_dtype) + d).clamp(-32768, 32767)
            out[:, t0 + i] = recon.to(torch.int16)
            h, w = _update(h, w, recon, d)
    return out


def search(x, n_valid, hist0, wts0, prev0, sizes, sfb: int, sff: int, pred_dtype=torch.int64):
    """The scale-factor search over every window of R chunk rows
    (``encoder_base.rs:94-144``): ``x`` int64 [R, W*sff, C] samples,
    ``n_valid`` None or int64 [R, W] valid frames per window (a masked step
    leaves the state and the rank as they are), ``hist0``/``wts0`` [R, C, 4]
    and ``prev0`` [R, C] the entry state, ``sizes`` an int or [R, W, C].
    Every candidate runs the window from the state the last window's winner
    left; the lowest rank wins, ties going to the first in the order
    starting at the previous winner. Returns (sf [R, W, C], codes [R, W*sff,
    C], ranks [R, W, C], hist, wts, prev) as int64."""
    r, n, c = x.shape
    nw, s, dev = n // sff, 1 << sfb, x.device
    low = pred_dtype is torch.float32  # the control: prediction and rank in float32
    t = Tables(sfb, dev)
    cand = torch.arange(s, device=dev)
    h = hist0.to(torch.int64)[:, :, None, :].expand(r, c, s, 4)
    w = wts0.to(torch.int64)[:, :, None, :].expand(r, c, s, 4)
    prev = prev0.to(torch.int64)
    if isinstance(sizes, int):
        sizes = torch.full((r, nw, c), sizes, dtype=torch.int64, device=dev)
    sizes = sizes.to(torch.int64)
    out_sf, out_codes, out_ranks = [], [], []
    for wi in range(nw):
        rs = sizes[:, wi, :, None]  # [R, C, 1]
        lim = 1 << rs
        recip = t.recip[rs[..., 0]]  # [R, C, S]
        sfv = t.sf[rs[..., 0]].to(torch.float32)
        q_at = t.qt_off[rs] + lim
        dq_at = t.dq_off[rs] + (cand << rs)
        rank = torch.zeros((r, c, s), dtype=torch.float32 if low else torch.int64, device=dev)
        qs = []
        for k in range(sff):
            xs = x[:, wi * sff + k, :, None]
            pred = _predict(h, w, pred_dtype)
            v = xs - pred
            if low:  # a float32 division in place of the fixed-point one
                qf = v.to(torch.float32) / sfv
                q = (torch.sign(qf) * torch.floor(qf.abs() + 0.5)).to(torch.int64)
            else:
                q = (v * recip + (1 << 15)) >> 16
                q = q + torch.sign(v) - torch.sign(q)
            code = t.qt[q_at + torch.maximum(torch.minimum(q, lim), -lim)]
            dq = t.dq[dq_at + code]
            recon = (pred + dq).clamp(-32768, 32767)
            err = xs - recon
            pen = (((w * w).sum(-1) >> 18) - 0x8FF).clamp_min(0)
            inc = err * err + pen * pen
            if low:
                inc = inc.to(torch.float32)
            h2, w2 = _update(h, w, recon, dq)
            qs.append(code)
            if n_valid is None:
                rank, h, w = rank + inc, h2, w2
            else:
                ok = (k < n_valid[:, wi])[:, None, None]
                rank = torch.where(ok, rank + inc, rank)
                h, w = torch.where(ok[..., None], h2, h), torch.where(ok[..., None], w2, w)
        key = rank if low else rank ^ _SIGN64  # unsigned order
        tie = key == key.min(dim=2, keepdim=True).values
        rot = torch.where(tie, (cand - prev[..., None]) & (s - 1), s)
        best = (rot.min(dim=2).values + prev) & (s - 1)  # [R, C]
        pick = lambda a: a.gather(2, best[..., None, None].expand(r, c, 1, a.shape[-1]))
        out_sf.append(best.to(torch.uint8))
        out_ranks.append(rank.gather(2, best[..., None])[..., 0].to(torch.int64))
        out_codes.append(torch.stack(qs, dim=1).gather(3, best[:, None, :, None].expand(r, sff, c, 1))[..., 0]
                         .to(torch.uint8))
        h = pick(h).expand(r, c, s, 4)
        w = pick(w).expand(r, c, s, 4)
        prev = best
    return (torch.stack(out_sf, 1), torch.cat(out_codes, 1), torch.stack(out_ranks, 1),
            h[:, :, 0], w[:, :, 0], prev)


def assign_sizes(ranks, base: int, sortable, m1, p1, p2) -> torch.Tensor:
    """VBR sizes [R, N] from pass-1 ranks [R, N] (window-major): of each
    row's first ``sortable`` items, in stable order of rank, the ``m1``
    lowest get base-1, the ``p2`` highest base+2 and the ``p1`` below them
    base+1, the rest base; clamped to 1..8. The counts are int64 [R, 1]
    tensors or ints."""
    r, n = ranks.shape
    idx = torch.arange(n, device=ranks.device)
    in_sort = idx < sortable
    key = torch.where(in_sort, ranks ^ _SIGN64, _KEY_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    pos = torch.empty_like(order).scatter_(1, order, idx.expand(r, n))
    size = base + (pos >= sortable - p2 - p1).long() + (pos >= sortable - p2).long() - (pos < m1).long()
    return torch.where(in_sort, size, base).clamp(1, 8)


def encode(layout: Layout, x, n_valid, hist0, wts0, prev0, frames, pred_dtype=torch.int64):
    """Encode chunk rows from their entry state: CBR one search; VBR a
    ranks pass at base+1, the sizes, and a second search from the same LMS
    state and the first pass's previous scale factors
    (``encoder_vbr.rs``). ``frames`` int64 [R] real frames of each row.
    Returns (sf, codes, sizes, hist, wts, prev)."""
    sfb, sff = layout.scale_factor_bits, layout.scale_factor_frames
    kw = dict(sfb=sfb, sff=sff, pred_dtype=pred_dtype)
    if not layout.vbr:
        sf, codes, _r, h, w, prev = search(x, n_valid, hist0, wts0, prev0, layout.header_rs, **kw)
        return sf, codes, None, h, w, prev
    r, n, c = x.shape
    nw = n // sff
    base = layout.base
    _sf, _codes, ranks, _h, _w, prev1 = search(x, n_valid, hist0, wts0, prev0, base + 1, **kw)
    counts = torch.tensor([layout.size_counts(int(f)) for f in frames.tolist()], device=x.device)
    sortable, m1, _t, p1, p2 = (counts[:, i:i + 1] for i in range(5))
    sizes = assign_sizes(ranks.reshape(r, nw * c), base, sortable, m1, p1, p2).view(r, nw, c)
    sf, codes, _r, h, w, prev = search(x, n_valid, hist0, wts0, prev1, sizes, **kw)
    return sf, codes, sizes, h, w, prev
