"""The encoder's scale-factor search over a run of windows.

Replaces the TPU kernel ``sea_codec_tpu/ops/pallas_encode.py``
``run_window_search``. On a CUDA tensor, ``window_search`` launches
``csrc/window_search.cu``: one block per channel, one thread per candidate
(a block of max(32, 2^sfb) threads), one launch for every window of every
chunk. The search is bound by one channel's serial chain of windows x sff
sample steps, walked by a lone warp, so the kernel keeps everything else off
that chain: the next window's samples, size and valid count are loaded a
window ahead; at sfb <= 5 the winner and its state pass by warp reductions
and shuffles with no block barrier; the quantizer and dequantizer are one
shared-memory lookup (``tables.search_table``) where the table fits, else
the arithmetic form; the weights penalty is skipped behind an exact guard;
and the sample loop is unrolled for sff == 20 (see the source note there).
On a CPU tensor it runs the plain PyTorch version, ``window_search_plain``,
which is ``ops.device_encode.encode_windows_fn`` plus the per-chunk entry
state snapshots. ``launches`` counts kernel launches, and
``ranks_only_launches`` those of them in the ranks-only form.

The residual size ``rs`` is an int (CBR, and VBR pass 1 at ``base+1``) or
a tensor uint8/int32[W, C] of per-(window, channel) sizes (VBR pass 2),
which lie in ``rs_range`` = (lo, hi), host ints the caller knows (VBR
assigns base-1..base+2; 1..8 by default): the kernel stages only those
sizes' table rows, a few KB a block instead of 128 KB at sfb 4, so that
many lanes share an SM. With ``ranks_only`` (VBR pass 1, which reads only
ranks and state) the winner's codes are not kept: the codes output is None.

``n_valid`` masks windows: None (all full), int32[W] valid frames shared
by every channel, or int32[W, C], one count per (window, lane). The
corpus encode packs files x channels into the lanes of one launch, each
lane with its own length; the number of lanes is not bounded by the
format's 255 channels.

Both return ``(sf uint8[W, C], codes uint8[W*sff, C] | None, ranks
int64[W, C], ehist int32[NC, C, 4], ewts int32[NC, C, 4], hist int32[C, 4],
wts int32[C, 4], prev_sf int32[C])``: ranks are the reference's u64 values
held in int64 (same bits), and ``ehist``/``ewts`` are the LMS state at the
first window of each run of ``wpc`` windows (the chunk-entry state a chunk
header carries), NC = ceil(W / wpc).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, tables
from .device_encode import encode_windows_fn

launches = 0
ranks_only_launches = 0


def window_search_plain(
    samples, n_valid, hist0, wts0, prev0, *, sfb, rs, sff, wpc, ranks_only=False, rs_range=(1, 8)
):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    nw = samples.shape[0] // sff
    if n_valid is None:
        nv = [sff] * nw
    elif n_valid.dim() == 1:  # host ints: the shared form's loop skips masked steps
        nv = [int(v) for v in n_valid.tolist()]
    else:
        nv = n_valid
    if torch.is_tensor(rs) and rs.numel():
        lo, hi = rs_range
        if int(rs.min()) < lo or int(rs.max()) > hi:
            raise ValueError(f"sizes outside the staged range {lo}..{hi}")
    hist, wts, prev = hist0, wts0, prev0
    outs, ehist, ewts = [], [], []
    for start in range(0, nw, wpc):
        end = min(start + wpc, nw)
        ehist.append(hist)
        ewts.append(wts)
        sf, codes, ranks, hist, wts, prev = encode_windows_fn(
            samples[start * sff : end * sff], nv[start:end], hist, wts, prev,
            sfb=sfb, rs=rs[start:end] if torch.is_tensor(rs) else rs, sff=sff,
            ranks_only=ranks_only,
        )
        outs.append((sf, codes, ranks))
    sf, codes, ranks = zip(*outs)
    codes = None if ranks_only else torch.cat(codes)
    return (
        torch.cat(sf), codes, torch.cat(ranks), torch.stack(ehist), torch.stack(ewts),
        hist, wts, prev,
    )


# window_search.cu's static shared memory (the warps' minima and the winner's
# state, used at sfb 6-8): it counts against a block's limit with the dynamic
_STATIC_SMEM = 4 * (2 * 8 * 3 + 2 * 8)


def _smem_bytes(s, sff, ranks_only, table_rows):
    """Dynamic shared memory of one block (layout in window_search.cu):
    reciprocals of every size, two windows of samples, the [sff, s] code
    buffer, and the quantizer: ``table_rows`` rows of the lookup table, or
    with ``table_rows`` 0 the arithmetic form's constants of every size
    (scale-factor values, curve constants, zig-zag tables)."""
    common = 4 * (9 * s + 2 * sff) + (0 if ranks_only else sff * s)
    if table_rows:
        return common + 4 * table_rows * s
    return common + 4 * (9 * s + 5 * 9) + tables.QUANT_TAB_SIZE


def _table_rows(s, sff, ranks_only, rs):
    """Rows of the lookup table the launch stages (``rs`` an int, a (lo, hi)
    range of per-window sizes, or None for all sizes), or 0 where the table
    does not fit shared memory and the kernel takes its arithmetic form.
    Raises where that does not fit."""
    rows = tables.search_table_rows(rs)[1]
    limit = cuda_build.SMEM_LIMIT - _STATIC_SMEM
    if _smem_bytes(s, sff, ranks_only, rows) <= limit:
        return rows
    if _smem_bytes(s, sff, ranks_only, 0) <= limit:
        return 0
    raise ValueError(f"sff={sff} at sfb={s.bit_length() - 1} exceeds the kernel's shared memory")


def window_search(
    samples, n_valid, hist0, wts0, prev0, *, sfb, rs, sff, wpc, ranks_only=False, rs_range=(1, 8)
):
    """Search every window of ``samples`` int16[W*sff, C] in order.

    ``n_valid`` is None (every window full), int32[W] or int32[W, C] valid
    frames; ``hist0``/``wts0`` int32[C, 4] and ``prev0`` int32[C] are the
    entry state; ``rs`` and ``rs_range`` are described in the module
    docstring. Returns the tuple described there."""
    global launches, ranks_only_launches
    device = samples.device
    c = samples.shape[1]
    s = 1 << sfb
    per_window = torch.is_tensor(rs)
    if not (1 <= sfb <= 8 and sff >= 1 and wpc >= 1):
        raise ValueError(f"bad search config sfb={sfb} sff={sff} wpc={wpc}")
    if samples.dim() != 2 or samples.shape[0] % sff or c < 1:
        raise ValueError(f"samples must be [W*sff, C], got {tuple(samples.shape)}")
    nw = samples.shape[0] // sff
    for name, t in (("hist0", hist0), ("wts0", wts0), ("prev0", prev0)):
        if t.dtype != torch.int32 or t.device != device:
            raise TypeError(f"{name} must be int32 on {device}")
    if hist0.shape != (c, 4) or wts0.shape != (c, 4) or prev0.shape != (c,):
        raise ValueError("hist0/wts0 must be [C, 4] and prev0 [C]")
    if n_valid is not None and (
        n_valid.shape not in ((nw,), (nw, c)) or n_valid.dtype != torch.int32 or n_valid.device != device
    ):
        raise ValueError(f"n_valid must be int32[{nw}] or int32[{nw}, {c}] on {device}")
    if per_window:
        if rs.shape != (nw, c) or rs.dtype not in (torch.uint8, torch.int32) or rs.device != device:
            raise ValueError(f"rs must be uint8/int32[{nw}, {c}] on {device}")
        lo, hi = rs_range
    else:
        lo = hi = int(rs)
    if not 1 <= lo <= hi <= 8:
        raise ValueError(f"bad residual size {rs} or range {rs_range}")
    table_rows = _table_rows(s, sff, ranks_only, (lo, hi))
    if device.type == "cpu":
        return window_search_plain(
            samples, n_valid, hist0, wts0, prev0,
            sfb=sfb, rs=rs, sff=sff, wpc=wpc, ranks_only=ranks_only, rs_range=(lo, hi),
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if samples.dtype != torch.int16:
        raise TypeError(f"samples must be int16, got {samples.dtype}")

    sfval, recip, curve, ints, qtab = tables.kernel_tables(sfb, device)
    nch = -(-nw // wpc)
    u8, i32 = torch.uint8, torch.int32
    sf = torch.empty((nw, c), dtype=u8, device=device)
    codes = None if ranks_only else torch.empty((nw * sff, c), dtype=u8, device=device)
    ranks = torch.empty((nw, c), dtype=torch.int64, device=device)
    ehist = torch.empty((nch, c, 4), dtype=i32, device=device)
    ewts = torch.empty((nch, c, 4), dtype=i32, device=device)
    hist = torch.empty((c, 4), dtype=i32, device=device)
    wts = torch.empty((c, 4), dtype=i32, device=device)
    prev = torch.empty((c,), dtype=i32, device=device)
    if nw == 0:
        return sf, codes, ranks, ehist, ewts, hist0.clone(), wts0.clone(), prev0.clone()
    rs_w = rs.to(u8).contiguous() if per_window else None
    nv = None if n_valid is None else n_valid.contiguous()
    samples = samples.contiguous()
    hist0, wts0, prev0 = hist0.contiguous(), wts0.contiguous(), prev0.contiguous()
    tab = None
    if table_rows:
        first = tables.search_table_rows((lo, hi))[0]
        tab = tables.search_kernel_table(sfb, device)[first : first + table_rows]
    fn = _launcher()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            samples.data_ptr(), ptr(nv), ptr(rs_w), hist0.data_ptr(), wts0.data_ptr(), prev0.data_ptr(),
            sfval.data_ptr(), recip.data_ptr(), curve.data_ptr(), ints.data_ptr(),
            qtab.data_ptr(), ptr(tab), sf.data_ptr(), ptr(codes), ranks.data_ptr(),
            ehist.data_ptr(), ewts.data_ptr(), hist.data_ptr(), wts.data_ptr(),
            prev.data_ptr(), c, s, sff, nw, wpc, lo, hi,
            1 if nv is None or nv.dim() == 1 else c, int(ranks_only), qtab.numel(), table_rows, stream,
        )
    cuda_build.check(rc, "sea_window_search")
    launches += 1
    ranks_only_launches += int(ranks_only)
    return sf, codes, ranks, ehist, ewts, hist, wts, prev


def _launcher():
    fn = cuda_build.load("window_search").sea_window_search
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 20 + [i] * 11 + [p]
    fn.restype = ctypes.c_int
    return fn
