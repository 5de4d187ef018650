// What the decode kernels for Hopper (sm_90a) share below the recurrence:
// the tile geometry a producer of dequantized residuals (dq) works on, and
// the copy of a finished dq tile into the time-major stream.
//
// A block decodes `chunks` consecutive chunks from `chunk0` on, a tile of
// `tile` frames at a time. A producer (producer_cbr.cuh, producer_vbr.cuh)
// fills a dq slot laid out as one sub-tile [tile, C] per chunk, `sub` int16
// apart, frame-major and channel-minor: sample j = frame * C + channel of
// chunk k's tile lies at k * sub + j. Two kinds of kernel fill such slots:
//   - the fused decodes (fused_decode_cbr.cu, fused_decode_vbr.cu), whose
//     recurrence ring (decode_ring.cuh) holds them, with producer warps
//     beside the recurrence warps;
//   - the dequant prologs of the two-kernel decode (dequant_cbr.cu,
//     dequant_vbr.cu), ring-less: every warp of the block is a producer, and
//     a finished slot goes to the time-major stream dq [frames, N*C] by
//     store_rows below.
// Tiles carries what the producers read of the block; the ring's Ring
// extends it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace decode_tiles {

struct Tiles {
  int c, tile, frames;  // channels, frames a tile, frames a chunk
  int chunk0, chunks;   // the block's first chunk and how many it decodes
  int sub;              // int16 between two chunks' sub-tiles in a slot
  int prod_threads;     // the block's producer threads
  int ptid;             // this thread's index among them, -1 on other warps
};

// a barrier among the producer warps alone (named barrier 1; a ring's
// recurrence warps never wait on it)
__device__ __forceinline__ void producer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// x / d by one multiply, exact for 0 <= x < 2^32 / d (the kernels divide
// indices below 2^16 by divisors below 2^14)
struct FastDiv {
  uint32_t magic;
  int d;
  __device__ explicit FastDiv(int d_) : magic(d_ == 1 ? 0u : 0xFFFFFFFFu / d_ + 1u), d(d_) {}
  __device__ __forceinline__ int operator()(int x) const {
    return d == 1 ? x : static_cast<int>(__umulhi(static_cast<uint32_t>(x), magic));
  }
};

// The widest store, in int16 (8, 4, 2 or 1), that every row of a block's
// columns allows in the time-major stream `out` of `stride` int16 a frame:
// the base, the stride, the block's first column and its width all
// multiples of it.
__device__ __forceinline__ int row_vector(const Tiles& t, const int16_t* out, size_t stride) {
  const size_t g = (reinterpret_cast<uintptr_t>(out) >> 1) | stride |
                   static_cast<size_t>(t.chunk0) * t.c | static_cast<size_t>(t.chunks) * t.c;
  const size_t low = g & (~g + 1);
  return low >= 8 ? 8 : static_cast<int>(low);
}

template <int V> struct VecOf;
template <> struct VecOf<8> { using T = uint4; };
template <> struct VecOf<4> { using T = uint2; };
template <> struct VecOf<2> { using T = uint32_t; };
template <> struct VecOf<1> { using T = uint16_t; };

// Frames f0 .. f0 + nf - 1 of a filled slot into the time-major stream: row
// f of the block's columns [chunk0*C, (chunk0 + chunks)*C) is contiguous in
// `out`, so a thread gathers V of them from the chunks' sub-tiles (V int16
// loads from shared memory) and stores them at once.
template <int V>
__device__ __forceinline__ void store_rows_v(const Tiles& t, const int16_t* slot, int f0, int nf,
                                             int16_t* __restrict__ out, size_t stride) {
  using T = typename VecOf<V>::T;
  const int c = t.c;
  const int per = t.chunks * c / V;  // stores a row
  const int total = nf * per;
  const FastDiv div_per(per), div_c(c);
  T* base = reinterpret_cast<T*>(out + static_cast<size_t>(f0) * stride + static_cast<size_t>(t.chunk0) * c);
  const size_t row = stride / V;
  for (int idx = t.ptid; idx < total; idx += t.prod_threads) {
    const int fl = div_per(idx), x = idx - fl * per;
    int k = div_c(x * V);
    int ch = x * V - k * c;
    union {
      T v;
      int16_t s[V];
    } u;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      u.s[e] = slot[k * t.sub + fl * c + ch];
      if (++ch == c) {
        ch = 0;
        ++k;
      }
    }
    base[fl * row + x] = u.v;
  }
}

__device__ __forceinline__ void store_rows(const Tiles& t, const int16_t* slot, int f0, int nf,
                                           int16_t* __restrict__ out, size_t stride, int vec) {
  if (vec == 8) store_rows_v<8>(t, slot, f0, nf, out, stride);
  else if (vec == 4) store_rows_v<4>(t, slot, f0, nf, out, stride);
  else if (vec == 2) store_rows_v<2>(t, slot, f0, nf, out, stride);
  else store_rows_v<1>(t, slot, f0, nf, out, stride);
}

}  // namespace decode_tiles
