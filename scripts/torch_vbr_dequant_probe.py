#!/usr/bin/env python3
"""Where the VBR dequant wrapper's time goes on a CUDA card
(``sea_codec_torch.ops.dequant.unpack_dequant_vbr``).

Run from the repository root on a machine with one GPU:
``python3 scripts/torch_vbr_dequant_probe.py``. At the shape of a 3-minute
stereo file's full chunks ([1550, 5120, 2], sff 20) it times, with CUDA
events over 20 calls after a warm-up: the whole wrapper; the addressing
(``vbr_addressing``: the prefix sums over the size table, a dozen small
tensor ops); the kernel alone, launched on addressing made beforehand; and
the channel prefix sum in the two forms that were tried, a ``cumsum`` over
the innermost dimension (C entries per row) against one over the outer
dimension of a transposed copy, the form the wrapper uses. Also the
addressing at 255 channels. Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sea_codec_torch.ops import cuda_build, dequant, tables  # noqa: E402


def cuda_ms(fn, reps=20):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip())
    cuda_build.build_all(("dequant_vbr",))
    rng = np.random.default_rng(7)
    n, f, c, sff, sfb = 1550, 5120, 2, 20, 4
    w = f // sff
    up = lambda a: torch.from_numpy(a).cuda()
    res = up(rng.integers(0, 256, (n, 3203), dtype=np.uint8))
    sf = up(rng.integers(0, 1 << sfb, (n, w, c), dtype=np.uint8))
    rs = up(rng.integers(2, 4, (n, w, c), dtype=np.uint8))
    kw = dict(sfb=sfb, sff=sff, frames=f)
    print(f"wrapper at {[n, f, c]}: {cuda_ms(lambda: dequant.unpack_dequant_vbr(res, sf, rs, **kw)):.4f} ms")
    print(f"  addressing (vbr_addressing): {cuda_ms(lambda: dequant.vbr_addressing(rs, sff, f)):.4f} ms")

    win_start, wsum, prefix = dequant.vbr_addressing(rs, sff, f)
    sfval, _recip, curve, ints, _q = tables.kernel_tables(sfb, res.device)
    out = torch.empty((f, n, c), dtype=torch.int16, device="cuda")
    fn = dequant._vbr_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    raw = lambda: fn(
        res.data_ptr(), sf.data_ptr(), rs.data_ptr(), win_start.data_ptr(), wsum.data_ptr(),
        prefix.data_ptr(), sfval.data_ptr(), curve.data_ptr(), ints.data_ptr(), out.data_ptr(),
        n, res.shape[1], c, w, f, 1 << sfb, sff, stream)
    print(f"  kernel alone: {cuda_ms(raw):.4f} ms")
    want = dequant.unpack_dequant_vbr(res, sf, rs, **kw)
    assert torch.equal(out, want)

    r = rs.to(torch.int32)
    rt = r.permute(2, 0, 1).contiguous()
    print(f"channel prefix sum, cumsum over the innermost dim [{n}, {w}, {c}]: "
          f"{cuda_ms(lambda: r.cumsum(dim=2, dtype=torch.int32)):.4f} ms")
    print(f"channel prefix sum, transpose + cumsum over the outer dim: "
          f"{cuda_ms(lambda: r.permute(2, 0, 1).contiguous().cumsum(dim=0, dtype=torch.int32)):.4f} ms")
    assert torch.equal(rt.cumsum(dim=0, dtype=torch.int32).permute(1, 2, 0), r.cumsum(dim=2, dtype=torch.int32))
    r255 = up(rng.integers(1, 9, (8, w, 255), dtype=np.uint8))
    print(f"addressing at [8, {w}, 255]: {cuda_ms(lambda: dequant.vbr_addressing(r255, sff, f)):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
