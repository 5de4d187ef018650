// The CBR producer for Hopper (sm_90a): unpack + dequant of a tile of packed
// CBR codes into a dq slot (tiles.cuh), shared by the fused CBR decode
// (fused_decode_cbr.cu) and the CBR dequant prolog (dequant_cbr.cu).
//
// Per sample, as in the reference decoder (src/codec/decoder.rs):
//   code = rs bits, MSB first, at bit (frame*C + ch)*rs of the chunk's
//          residual section
//   dq   = +-floor(sfval*curve(k) + 0.5), k = code >> 1, sign = code & 1,
//          curve = 0.5 + k*stepfloor with the k==kmax / k==0 overrides,
//          read from the reference table itself: dq = dqt[sf][code]
//          (ops/tables.py dq_table, at most 2^8 x 2^8 int16) through the
//          L1 cache, no f32 step and no conversion on the card.
// Eight consecutive codes are exactly rs bytes, so a producer thread reads
// one byte-aligned group straight from device memory (no staged row: a row
// of any length decodes; bytes at or past `res_bytes` read as zero),
// dequantizes its eight samples and stores them with two 8-byte stores.
// Consecutive threads take consecutive groups of one chunk, so a warp's byte
// loads fall in 32*rs contiguous bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace decode_tiles {

struct CbrProducer {
  const Tiles& r;
  const uint8_t* __restrict__ res;
  const uint8_t* __restrict__ sf;
  const int16_t* __restrict__ dqt;  // [2^sfb, 2^rs] dq by (scale factor, code)
  int res_stride, res_bytes, w, n_sf, rs, sff;
  FastDiv div_c, div_sff;

  __device__ void prepare(int) {}

  // tile i of every chunk of the block into `slot`; a partial last group
  // writes past the tile's samples but inside the chunk's sub-tile
  __device__ void fill(int i, int16_t* slot) {
    const int c = r.c;
    const int mask = (1 << rs) - 1;
    const int f0 = i * r.tile;
    const int nsamp = min(r.tile, r.frames - f0) * c;
    const int groups = (nsamp + 7) / 8;  // of eight codes, per chunk
    const FastDiv div_g(groups);
    const int win0 = f0 / sff, off0 = f0 - win0 * sff;  // the tile's first window, f0's place in it
    for (int idx = r.ptid; idx < r.chunks * groups; idx += r.prod_threads) {
      const int k = div_g(idx), g = idx - k * groups;
      const uint8_t* row = res + static_cast<size_t>(r.chunk0 + k) * res_stride;
      const uint8_t* sf_row = sf + static_cast<size_t>(r.chunk0 + k) * w * c;
      // eight codes = rs bytes at a byte boundary, MSB first
      const int byte0 = ((f0 * c) / 8 + g) * rs;
      unsigned long long bits = 0;
      for (int b = 0; b < rs; ++b) {
        const int at = byte0 + b;
        const unsigned long long v = at < res_bytes ? row[at] : 0;
        bits |= v << (56 - 8 * b);
      }
      const int fl = div_c(g * 8);  // frame within the tile, then its channel
      int ch = g * 8 - fl * c;
      const int dw = div_sff(off0 + fl);
      int win = win0 + dw;
      int fin = off0 + fl - dw * sff;  // frame within its window
      __align__(8) int16_t vals[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = static_cast<int>(bits >> (64 - rs * (u + 1))) & mask;
        const int wi = min(win, w - 1);  // a partial group runs past the chunk
        const int code = sf_row[wi * c + ch] & (n_sf - 1);
        vals[u] = __ldg(dqt + ((code << rs) | q));
        if (++ch == c) {
          ch = 0;
          if (++fin == sff) {
            fin = 0;
            ++win;
          }
        }
      }
      uint2* dst = reinterpret_cast<uint2*>(slot + k * r.sub + g * 8);
      dst[0] = reinterpret_cast<const uint2*>(vals)[0];
      dst[1] = reinterpret_cast<const uint2*>(vals)[1];
    }
  }
};

}  // namespace decode_tiles
