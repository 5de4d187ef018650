"""``batch.decode_range``: one client seeking in ``.sea`` files held as
bytes, one request at a time.

The check compares every sample of every request (up to
``CHECK_REQUESTS`` drawn from the seed) with the reference's decode
(``reference.codec``) of the chunks the request touches.
"""

from __future__ import annotations

import numpy as np
import torch

import roofline
from seabench.driver import Driver, decode_chunks, decode_kernel

CHECK_REQUESTS = 4000


class Entry(Driver):
    inputs = "sea"

    def answers(self, out) -> tuple[int, int]:
        return 1, int(out is None)

    def call(self, i):
        tr = self.tr
        j, start = tr.requests[i % len(tr.requests)]
        return self.port.batch.decode_range(tr.files[j], int(start), int(tr.params["range_frames"]),
                                            **self.placement())

    def warm(self):
        """A request of each chunk count the traffic can make (whole chunks,
        one more for a start inside a chunk) and one that reaches the tail."""
        tr, lay = self.tr, self.tr.layout
        span, fpc = int(tr.params["range_frames"]), lay.frames_per_chunk
        for start in (0, fpc // 2, tr.frames[0] - span):
            self.port.batch.decode_range(tr.files[0], start, span, **self.placement())

    def check(self, control: bool = False) -> tuple[dict, int, int]:
        tr, lay = self.tr, self.tr.layout
        fpc, cs, c = lay.frames_per_chunk, lay.chunk_bytes(), lay.channels
        span = int(tr.params["range_frames"])
        n = len(self.records)
        idx = np.arange(n)
        if n > CHECK_REQUESTS:
            idx = np.sort(np.random.default_rng([self.seed, 0x5EE]).choice(n, CHECK_REQUESTS, replace=False))
        reqs = [(int(j), int(s)) for j, s in (tr.requests[i % len(tr.requests)] for i in idx)]
        touched = lambda start: range(start // fpc, -(-(start + span) // fpc))
        keys = sorted({(j, k) for j, s in reqs for k in touched(s)})
        chunks = []
        for j, k in keys:
            f = min(fpc, tr.frames[j] - k * fpc)
            chunks.append((tr.files[j][22 + k * cs: 22 + k * cs + (cs if f == fpc else len(tr.files[j]))], f))
        want_pcm = dict(zip(keys, decode_chunks(lay, chunks, self.device, torch.int64)))
        ctl_pcm = dict(zip(keys, decode_chunks(lay, chunks, self.device, torch.float32))) if control else None

        def answer(pcm, j, start):
            whole = np.concatenate([pcm[(j, k)] for k in touched(start)]).reshape(-1, c)
            return whole[start - start // fpc * fpc:][:span].reshape(-1)

        mism = 0
        for i, (j, start) in zip(idx, reqs):
            want = answer(want_pcm, j, start)
            got = answer(ctl_pcm, j, start) if control else self.records[i][2]
            if got is None:
                continue
            got = np.asarray(got)
            mism += want.size if got.shape != want.shape else int(np.count_nonzero(got != want))
        checks = {"failed_answers": (self.failed, 0), "mismatched_samples": (mism, 0),
                  "requests_compared": (len(idx), None)}
        return checks, self.attempted, self.failed

    def work(self, records) -> dict:
        tr, lay = self.tr, self.tr.layout
        fpc, span = lay.frames_per_chunk, int(tr.params["range_frames"])
        total = roofline.ZERO
        for i in range(len(records)):
            j, start = (int(v) for v in tr.requests[i % len(tr.requests)])
            for k in range(start // fpc, -(-(start + span) // fpc)):
                f = min(fpc, tr.frames[j] - k * fpc)
                bits = tr.tail_bits[j] if f < fpc else lay.full_residual_bits()
                total = roofline.sum_work([total, roofline.decode_work(f, lay.channels, lay.scale_factor_frames,
                                                                       -(-bits // 8), lay.vbr)])
        return {decode_kernel(lay): total}
