// The VBR producer for Hopper (sm_90a): the bit addressing and the extract +
// dequant of a tile of packed VBR codes into a dq slot (tiles.cuh), shared by
// the fused VBR decode (fused_decode_vbr.cu) and the VBR dequant prolog
// (dequant_vbr.cu).
//
// A VBR chunk's residual sizes vary per (window, channel); within a window
// they are constant per channel and the codes are frame-major, channel-minor
// (reference src/codec/chunk.rs:245-271), so a code's bit offset is affine:
//   bit(w, t, ch) = win_start[w] + t*wsum[w] + prefix[w, ch]
// with wsum the window's bits per frame, prefix the bits of the channels
// before ch, and win_start the sum of (frames in window) * wsum over the
// windows before (only the last window may be partial). Per sample, as in
// the reference decoder (src/codec/decoder.rs):
//   code  = rs bits, MSB first, at that offset
//   dq    = +-floor(sfval[rs][sf]*curve(k) + 0.5), k = code >> 1,
//           curve = 0.5 + k*stepfloor[rs] with the k==kmax / k==0 overrides,
//           read from the reference tables of every size (ops/tables.py
//           dq_table) through the L1 cache, as in producer_cbr.cuh.
//
// For each tile, prepare() builds in shared memory the addressing of the
// windows the tile touches, per chunk of the block: a warp per chunk reads
// the windows' sizes and scale factors (contiguous in device memory), scans
// the sizes across channels (a segmented warp scan over the [windows, C]
// entries) for each entry's prefix and each window's wsum, then scans
// fiw * wsum across windows for their first bits, starting from the chunk's
// bit cursor, which it carries from tile to tile: the tiles of a block's
// chunks are prepared in order. An entry holds (prefix | size << 16, where
// its (size, scale factor) row starts in the tables), a window (start bit,
// wsum). Then fill() has each producer thread take groups of four
// consecutive samples of a chunk: their codes follow each other in the bit
// stream, so it computes the group's first bit from the tables, reads the
// <= 39 bits from there once, straight from device memory, walks them with
// each sample's size, looks up their values and stores the four into the
// slot. No packed row is staged, so a row of any length decodes; the tables
// are sized for the most windows a tile can touch (`nwmax`), so they fit
// shared memory for every sfb 1..8, sff 1..255 and C 1..255.
//
// Malformed input: sizes are clamped to 1..8 and scale factors masked to
// 2^sfb as they are read, and bytes at or past the row's end read as zero,
// so no read leaves the row.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace decode_tiles {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Inclusive scan of v over the warp's lanes, each lane summing only the
// lanes at most `span` below it: a segmented scan whose segment starts
// `span` lanes down.
__device__ __forceinline__ int warp_scan(int v, int lane, int span) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (span >= off) v += u;
  }
  return v;
}

// Shared memory of the producer's tables, laid out by the kernel: the
// window tables and the cursors. cursor_s[k] must be 0 before the first tile.
struct VbrProducer {
  const Tiles& r;
  const uint8_t* __restrict__ res;
  const uint8_t* __restrict__ sf;
  const uint8_t* __restrict__ rs;
  const int16_t* __restrict__ dqt;  // dqt of sizes 1..8, [n_sf, 2^r] from n_sf * (2^r - 2) on
  int2* rows_s;          // [chunks, nwmax] (first bit, bits per frame) of a window
  int2* ents_s;          // [chunks, nwmax, c] (prefix | size << 16, the entry's dqt row)
  int* cursor_s;         // [chunks] first bit of the tile's first window
  int res_len, w, n_sf, sff, nwmax;
  FastDiv div_c, div_sff;
  // this tile's frames and its first frame's place in its window, set by prepare()
  int nf, off;

  __device__ void prepare(int i) {
    const int c = r.c;
    const int lane = r.ptid & 31, pwarp = r.ptid >> 5, pwarps = r.prod_threads >> 5;
    if (i > 0) producer_sync(r.prod_threads);  // every sample of tile i-1 is in its slot
    const int f0 = i * r.tile;
    nf = min(r.tile, r.frames - f0);
    const int wa = f0 / sff;  // the tile's windows wa .. wa + nw - 1
    const int nw = (f0 + nf - 1) / sff - wa + 1;
    off = f0 - wa * sff;
    const int n_e = nw * c;
    for (int k = pwarp; k < r.chunks; k += pwarps) {
      const size_t tab = (static_cast<size_t>(r.chunk0 + k) * w + wa) * c;
      int2* ents = ents_s + k * nwmax * c;
      int2* rows = rows_s + k * nwmax;
      // sizes and scale factors -> entries; the sizes' scan per window
      int carry = 0;
      for (int base = 0; base < n_e; base += 32) {
        const int e = base + lane;
        const int wl = div_c(e), ch = e - wl * c;
        const bool valid = e < n_e;
        const int size = valid ? min(max(static_cast<int>(rs[tab + e]), 1), 8) : 0;
        const int code = valid ? sf[tab + e] & (n_sf - 1) : 0;
        int incl = warp_scan(size, lane, min(lane, ch));
        if (ch > lane) incl += carry;  // the window's row began in an earlier pass
        if (valid) {
          ents[e] = make_int2((incl - size) | (size << 16), n_sf * ((1 << size) - 2) + (code << size));
          if (ch == c - 1) rows[wl].y = incl;
        }
        carry = __shfl_sync(kFull, incl, 31);
      }
      __syncwarp();
      // the windows' first bits: the cursor plus the scan of fiw * wsum
      int run = cursor_s[k];
      for (int base = 0; base < nw; base += 32) {
        const int wl = base + lane;
        const int v = wl < nw ? min(sff, r.frames - (wa + wl) * sff) * rows[wl].y : 0;
        const int incl = warp_scan(v, lane, lane);
        if (wl < nw) rows[wl].x = run + incl - v;
        run += __shfl_sync(kFull, incl, 31);
      }
      __syncwarp();
      // the next tile starts in this tile's last window or in the one after
      if (lane == 0) cursor_s[k] = (f0 + r.tile) / sff - wa == nw ? run : rows[nw - 1].x;
      __syncwarp();
    }
    producer_sync(r.prod_threads);  // the tables are complete
  }

  // A group is four consecutive samples of a chunk: their codes follow each
  // other in the bit stream (in frame-major order every code starts where
  // the last one ended, across windows too), so a group reads its <= 39
  // bits once and walks them, each code's size and scale factor from its
  // entry. kGroups groups a thread at a time, all their byte loads issued
  // before any store.
  __device__ void fill(int, int16_t* slot) {
    constexpr int kGroups = 2;
    const int c = r.c;
    const int nsamp = nf * c;
    const int groups = (nsamp + 3) / 4, total = r.chunks * groups;
    const FastDiv div_g(groups);
    for (int base = r.ptid; base < total; base += kGroups * r.prod_threads) {
      unsigned long long buf[kGroups];
      int k[kGroups], j0[kGroups], ch[kGroups], wl[kGroups], t[kGroups], pos[kGroups];
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int idx = min(base + u * r.prod_threads, total - 1);  // past the end: the last again, not stored
        k[u] = div_g(idx);
        j0[u] = 4 * (idx - k[u] * groups);
        const int fl = div_c(j0[u]);
        ch[u] = j0[u] - fl * c;
        const int x = fl + off;
        wl[u] = div_sff(x);
        t[u] = x - wl[u] * sff;
        const int2 row = rows_s[k[u] * nwmax + wl[u]];
        const int bit = row.x + t[u] * row.y + (ents_s[(k[u] * nwmax + wl[u]) * c + ch[u]].x & 0xFFFF);
        pos[u] = bit & 7;
        const uint8_t* src = res + static_cast<size_t>(r.chunk0 + k[u]) * res_len + (bit >> 3);
        const int room = res_len - (bit >> 3);  // bytes at or past the row's end read as zero
        buf[u] = 0;
#pragma unroll
        for (int b = 0; b < 5; ++b)
          buf[u] |= static_cast<unsigned long long>(b < room ? src[b] : 0) << (56 - 8 * b);
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        if (base + u * r.prod_threads >= total) break;
        __align__(8) int16_t vals[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (j0[u] + v >= nsamp) break;
          const int2 ent = ents_s[(k[u] * nwmax + wl[u]) * c + ch[u]];
          const int size = ent.x >> 16;
          const int q = static_cast<int>(buf[u] >> (64 - pos[u] - size)) & ((1 << size) - 1);
          pos[u] += size;
          vals[v] = __ldg(dqt + ent.y + q);
          if (++ch[u] == c) {
            ch[u] = 0;
            if (++t[u] == sff) {
              t[u] = 0;
              ++wl[u];
            }
          }
        }
        int16_t* dst = slot + k[u] * r.sub + j0[u];
        if (j0[u] + 4 <= nsamp) {
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(vals);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (j0[u] + v < nsamp) dst[v] = vals[v];
        }
      }
    }
  }
};

}  // namespace decode_tiles
