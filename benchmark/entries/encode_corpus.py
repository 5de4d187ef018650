"""``batch.encode_corpus``: a library of PCM files encoded in one call.

The check takes every file of one call drawn from the seed and encodes
each of its chunks again with the reference (``reference.codec``): the
first chunk of a file from the encoder's start (a zero history, the
weights of ``tables.initial_weights`` and a previous scale factor of 0),
every later one from the LMS entry state its header carries and its
predecessor's last scale factor. It compares the header and length of each
file, the bytes of each chunk, the state each first chunk's header states
with the start, and each chunk's end state with its successor's entry
state (the carry). So the start and the carry are held to the reference
each on its own, and every chunk between them through its bytes.
"""

from __future__ import annotations

import numpy as np
import torch

import roofline
from reference import codec, tables
from seabench.driver import PARSE_ROWS, Driver, entry_states

class Entry(Driver):
    inputs = "pcm"
    takes_mesh = True
    keep = 1

    def __init__(self, port, traffic, device, seed, mesh=None):
        super().__init__(port, traffic, device, seed, mesh)
        cfg = traffic.layout
        self.settings = port.EncoderSettings(
            scale_factor_bits=cfg.scale_factor_bits, scale_factor_frames=cfg.scale_factor_frames,
            residual_bits=cfg.residual_bits, frames_per_chunk=cfg.frames_per_chunk, vbr=cfg.vbr)

    def call(self, i):
        return self.port.batch.encode_corpus(
            self.tr.pcm, self.tr.sample_rate, self.tr.layout.channels, self.settings, **self.placement())

    def check(self, control: bool = False) -> tuple[dict, int, int]:
        """Every chunk of every file of the kept call, re-encoded by the
        reference: a file's first chunk from the encoder's start, every
        later one from the LMS entry state its header carries and its
        predecessor's last scale factor. Its bytes compared, the state a
        first chunk's header states compared with the start, and each end
        state compared with the successor's entry state, the carry."""
        tr, lay = self.tr, self.tr.layout
        fpc, cs = lay.frames_per_chunk, lay.chunk_bytes()
        full, tails = [], []  # full: (file, rows uint8 [n, cs]); tails: (file, bytes)
        bad = 0
        for _i, out in self.kept():
            for j, frames in enumerate(tr.frames):
                enc = out[j] if out is not None and j < len(out) else None
                if not enc:
                    continue
                n_full, tail = divmod(frames, fpc)
                head = 22 + n_full * cs
                if enc[:22] != codec.header_bytes(lay, tr.sample_rate, frames, cs) or len(enc) < head \
                        or (tail == 0 and len(enc) != head) or (tail and len(enc) == head):
                    bad += 1
                    continue
                full.append((j, np.frombuffer(enc, np.uint8, count=n_full * cs, offset=22).reshape(n_full, cs)))
                if tail:
                    tails.append((j, enc[head:]))
        mism, start, carry, bad_len = self._compare(full, tails, control) if full or tails else (0, 0, 0, 0)
        checks = {
            "failed_answers": (self.failed, 0),
            "bad_headers_or_lengths": (bad + bad_len, 0),
            "mismatched_chunks": (mism, 0),
            "start_state_mismatches": (start, 0),
            "carry_mismatches": (carry, 0),
            "chunks_compared": (sum(r.shape[0] for _j, r in full) + len(tails), None),
        }
        return checks, self.attempted, self.failed

    def _compare(self, full, tails, control):
        tr, lay, dev = self.tr, self.tr.layout, self.device
        fpc, c = lay.frames_per_chunk, lay.channels
        nw = lay.windows(fpc)
        rows = torch.from_numpy(np.concatenate([r for _j, r in full])).to(dev) if full else None
        n = 0 if rows is None else rows.shape[0]
        states = ([codec.entry_state(rows, c)] if n else []) + ([entry_states([b for _j, b in tails], c, dev)]
                                                                if tails else [])
        hist, wts = (torch.cat(parts) for parts in zip(*states))
        last_sf = codec.last_scale_factors(lay, rows) if n else None
        # each row's samples, frames, predecessor (row index or -1) and successor
        x = torch.zeros((n + len(tails), fpc, c), dtype=torch.int16)
        nv = torch.zeros((n + len(tails), nw), dtype=torch.int64)
        prev_of, next_of, frames = [], [], []
        first_row = {}
        r = 0
        for j, fr in full:
            k = fr.shape[0]
            x[r:r + k] = torch.from_numpy(tr.pcm[j][: k * fpc * c]).view(k, fpc, c)
            nv[r:r + k] = torch.from_numpy(lay.window_frames(fpc))
            prev_of += [-1] + list(range(r, r + k - 1))
            next_of += list(range(r + 1, r + k)) + [None]
            first_row[j] = (r, k)
            frames += [fpc] * k
            r += k
        tail_last = {}
        for t, (j, blob) in enumerate(tails):
            f = tr.frames[j] % fpc
            x[n + t, :f] = torch.from_numpy(tr.pcm[j][(tr.frames[j] - f) * c:]).view(f, c)
            nv[n + t, : lay.windows(f)] = torch.from_numpy(lay.window_frames(f))
            r0, k = first_row.get(j, (0, 0))
            prev_of.append(r0 + k - 1 if k else -1)
            next_of.append(None)
            if k:
                next_of[r0 + k - 1] = n + t
            tail_last[t] = f
            frames.append(f)
        prev = torch.zeros((len(frames), c), dtype=torch.int64, device=dev)
        has_prev = torch.tensor(prev_of, device=dev) >= 0
        if n:
            prev[has_prev] = last_sf[torch.tensor(prev_of, device=dev)[has_prev]]
        # a file's first chunk starts from the encoder's start, whatever its header says
        first = ~has_prev
        w0 = torch.from_numpy(tables.initial_weights()).to(dev)
        start = int(((hist[first] != 0).flatten(1).any(1) | (wts[first] != w0).flatten(1).any(1)).sum())
        hist, wts = hist.clone(), wts.clone()
        hist[first] = 0
        wts[first] = w0
        x, nv, frames_t = x.to(dev).to(torch.int64), nv.to(dev), torch.tensor(frames)
        want = codec.encode(lay, x, nv, hist, wts, prev, frames_t)
        ctl = codec.encode(lay, x, nv, hist, wts, prev, frames_t, pred_dtype=torch.float32) if control else None
        del x

        def ser(out, idx, f):
            w = lay.windows(f)
            return codec.serialize(lay, f, hist[idx], wts[idx], out[0][idx, :w], out[1][idx, :f],
                                   None if out[2] is None else out[2][idx, :w])

        mism = bad_len = 0
        for b0 in range(0, n, PARSE_ROWS):
            idx = torch.arange(b0, min(n, b0 + PARSE_ROWS), device=dev)
            ref = ser(want, idx, fpc)
            got = ser(ctl, idx, fpc) if control else rows[idx]
            mism += int((ref != got).any(dim=1).sum())
        for t, (_j, blob) in enumerate(tails):
            idx = torch.tensor([n + t], device=dev)
            ref = ser(want, idx, tail_last[t])[0].cpu().numpy().tobytes()
            got = ser(ctl, idx, tail_last[t])[0].cpu().numpy().tobytes() if control else blob
            bad_len += len(got) != len(ref)
            mism += got != ref
        succ = [i for i, s_ in enumerate(next_of) if s_ is not None]
        carry = 0
        if succ:
            nxt = torch.tensor([next_of[i] for i in succ], device=dev)
            h16, w16 = codec.wrap16(want[3][succ]), codec.wrap16(want[4][succ])
            carry = int(((h16 != hist[nxt]).flatten(1).any(1) | (w16 != wts[nxt]).flatten(1).any(1)).sum())
        return mism, start, carry, bad_len



    def work(self, records) -> dict:
        tr, lay = self.tr, self.tr.layout
        one = roofline.sum_work(roofline.search_work(f, lay.channels, lay.frames_per_chunk,
                                                     lay.scale_factor_frames, lay.scale_factor_bits, lay.vbr)
                                for f in tr.frames)
        return {"window_search": roofline.scale(one, len(records))}
