"""The encoder's brute-force scale-factor search in plain PyTorch.

Reference semantics (``src/codec/encoder_base.rs``): for every scale-factor
window (``scale_factor_frames`` frames), try all 2^sfb candidate scale
factors; for each, run the per-sample loop predict -> scale (fixed-point
division) -> clamp -> quantize -> dequantize -> reconstruct -> LMS-update,
accumulating a rank = sum of squared error + weight penalty; keep the
candidate with the lowest rank, visiting candidates in rotated order starting
from the previous window's winner (ties resolve to the first minimum in that
order, ``encoder_base.rs:116-140``).

Here the candidates are a batch axis (row s *is* scale factor s, and the
rotated order is reproduced by a lexicographic argmin over (rank,
(s - prev_sf) mod S)), channels are a second batch axis, and windows and
samples are Python loops. The reference's early abort never changes the
argmin and is dropped. Ranks are u64 with wrap-around, held as int64 with
the same bits and compared unsigned by flipping the sign bit. This is the
plain version of the window-search kernel (``ops.window_search``).
"""

from __future__ import annotations

import torch

from . import lms, tables
from .device_decode import dequant_values

_SIGN64 = -(1 << 63)


def sea_div(v: torch.Tensor, recip: torch.Tensor) -> torch.Tensor:
    """Round-half-away fixed-point division by scale factor (reference
    ``encoder_base.rs:22-26``), in its int64 form."""
    n = (v * recip + (1 << 15)) >> 16
    return n + (torch.sign(v) - torch.sign(n))


def encode_windows_fn(
    samples, n_valid, hist0, wts0, prev_sf0, *, sfb, rs, sff, ranks_only=False
):
    """Run the scale-factor search over consecutive windows of one chunk.

    ``samples`` [W*sff, C] (any integer dtype), ``n_valid`` a sequence of W
    host ints (valid frames per window, shared by every channel) or an
    integer tensor [W, C] (one count per window and channel: each channel
    a lane of its own, as in the corpus encode), ``hist0``/``wts0`` int32[C, 4],
    ``prev_sf0`` int32[C]; ``rs`` is the residual size, an int (CBR, VBR
    pass 1) or an integer tensor [W, C] of per-(window, channel) sizes 1..8
    (VBR pass 2). Returns (sf uint8[W, C], codes uint8[W*sff, C], ranks
    int64[W, C], hist int32[C, 4], wts int32[C, 4], prev_sf int32[C]);
    ``ranks_only`` skips the winner's codes (the VBR analyze pass reads
    only ranks and state) and returns None for them."""
    device = samples.device
    s = 1 << sfb
    c = samples.shape[1]
    w = samples.shape[0] // sff
    sfval_t, recip_t, c0_t, stepf_t, endv_t, kmax_t, climit_t = (
        torch.as_tensor(t, device=device) for t in tables.rs_tables(sfb)
    )
    recip_t = recip_t.to(torch.int64)
    qtab = torch.as_tensor(tables.quant_tab().astype("int64"), device=device)
    qoff = torch.as_tensor(tables.quant_offsets().astype("int64"), device=device)
    if not torch.is_tensor(rs):
        rs = torch.full((w, c), int(rs), dtype=torch.int64, device=device)
    rs = rs.to(device=device, dtype=torch.int64)
    cand = torch.arange(s, device=device)[:, None]  # [S, 1]
    x = samples.to(torch.int64).reshape(w, sff, c)
    hist = hist0.to(torch.int64)
    wts = wts0.to(torch.int64)
    prev = prev_sf0.to(torch.int64)
    per_lane = torch.is_tensor(n_valid)
    if per_lane:
        nv_lane = n_valid.to(device=device, dtype=torch.int64)
    sf_out, codes_out, ranks_out = [], [], []
    for wi in range(w):
        # this window's constants per channel: tables rows [C, S] -> [S, C]
        r = rs[wi]  # [C]
        sfval = sfval_t[r].T
        recip = recip_t[r].T
        consts = (c0_t[r], stepf_t[r], endv_t[r], kmax_t[r])
        climit = climit_t[r].to(torch.int64)
        qbase = qoff[r] + climit  # table index of a zero residual
        hh = hist.expand(s, c, 4)
        ww = wts.expand(s, c, 4)
        rank = torch.zeros((s, c), dtype=torch.int64, device=device)
        qs = []
        for t in range(sff):
            smp = x[wi, t]  # [C]
            pred = lms.predict(hh, ww)  # [S, C]
            scaled = sea_div(smp - pred, recip)
            q = qtab[torch.minimum(torch.maximum(scaled, -climit), climit) + qbase]
            qs.append(q)
            if not per_lane and t >= n_valid[wi]:
                continue  # masked step: codes only, state frozen
            dq = dequant_values(q, sfval, *consts)
            recon = lms.clamp_i16(pred + dq)
            err = smp - recon
            inc = err * err + lms.weights_penalty(ww)
            h2, w2 = lms.update(hh, ww, recon, dq)
            if per_lane:  # masked lanes: codes only, state frozen
                valid = t < nv_lane[wi]  # [C]
                rank = torch.where(valid, rank + inc, rank)
                hh = torch.where(valid[:, None], h2, hh)
                ww = torch.where(valid[:, None], w2, ww)
            else:
                rank = rank + inc
                hh, ww = h2, w2
        # first minimum in rotated order: lexicographic (unsigned rank, rot)
        key = rank ^ _SIGN64
        tie = key == key.min(dim=0).values
        rot = torch.where(tie, (cand - prev) & (s - 1), s)
        best = (rot.min(dim=0).values + prev) & (s - 1)  # [C]
        idx = best[None, :]
        sf_out.append(best.to(torch.uint8))
        ranks_out.append(rank.gather(0, idx)[0])
        if not ranks_only:
            codes_out.append(torch.stack(qs).gather(1, idx[None].expand(sff, 1, c))[:, 0])
        hist = hh.gather(0, idx[..., None].expand(1, c, 4))[0]
        wts = ww.gather(0, idx[..., None].expand(1, c, 4))[0]
        prev = best
    if w == 0:
        empty = torch.zeros((0, c), dtype=torch.uint8, device=device)
        codes = None if ranks_only else empty
        return empty, codes, torch.zeros((0, c), dtype=torch.int64, device=device), hist0, wts0, prev_sf0
    i32 = torch.int32
    return (
        torch.stack(sf_out),
        None if ranks_only else torch.cat(codes_out).to(torch.uint8),
        torch.stack(ranks_out),
        hist.to(i32),
        wts.to(i32),
        prev.to(i32),
    )
