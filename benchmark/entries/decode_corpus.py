"""``batch.decode_corpus``: a library of ``.sea`` files decoded in one call.

The check compares every sample of every file of one call drawn from the
seed with the reference's decode (``reference.codec``) of the files'
chunks, from the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

import roofline
from seabench.driver import Driver, decode_chunks, decode_kernel


def file_decode_work(lay, frames: int, tail_bits: int) -> dict:
    fpc, c, sff = lay.frames_per_chunk, lay.channels, lay.scale_factor_frames
    n_full, tail = divmod(frames, fpc)
    full = roofline.scale(roofline.decode_work(fpc, c, sff, -(-lay.full_residual_bits() // 8), lay.vbr), n_full)
    if not tail:
        return full
    return roofline.sum_work([full, roofline.decode_work(tail, c, sff, -(-tail_bits // 8), lay.vbr)])


class Entry(Driver):
    inputs = "sea"
    takes_mesh = True
    keep = 1

    def call(self, i):
        return self.port.batch.decode_corpus(self.tr.files, **self.placement())

    def reference_pcm(self, pred_dtype=torch.int64) -> list[np.ndarray]:
        """Each file's PCM by the reference, decoded from the file's bytes."""
        tr, lay = self.tr, self.tr.layout
        fpc, cs = lay.frames_per_chunk, lay.chunk_bytes()
        chunks, owner = [], []
        for j, (blob, frames) in enumerate(zip(tr.files, tr.frames)):
            for k in range(-(-frames // fpc)):
                f = min(fpc, frames - k * fpc)
                chunks.append((blob[22 + k * cs: 22 + k * cs + (cs if f == fpc else len(blob))], f))
                owner.append(j)
        pcm = decode_chunks(lay, chunks, self.device, pred_dtype)
        return [np.concatenate([p for p, o in zip(pcm, owner) if o == j]).reshape(-1) for j in range(len(tr.files))]

    def check(self, control: bool = False) -> tuple[dict, int, int]:
        want = self.reference_pcm()
        if control:
            answers = [self.reference_pcm(torch.float32)]
        else:
            answers = [[None if d is None else d.samples for d in out] for _i, out in self.kept()]
        mism = compared = 0
        for out in answers:
            for j, w in enumerate(want):
                got = out[j] if j < len(out) else None
                if got is None:
                    continue
                compared += 1
                got = np.asarray(got)
                mism += w.size if got.shape != w.shape else int(np.count_nonzero(got != w))
        checks = {"failed_answers": (self.failed, 0), "mismatched_samples": (mism, 0),
                  "files_compared": (compared, None)}
        return checks, self.attempted, self.failed

    def work(self, records) -> dict:
        tr, lay = self.tr, self.tr.layout
        one = roofline.sum_work(file_decode_work(lay, f, b) for f, b in zip(tr.frames, tr.tail_bits))
        return {decode_kernel(lay): roofline.scale(one, len(records))}
