// Standalone LMS recurrence for Hopper (sm_90a): dq stream -> int16 PCM.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_decode.py:92
// lms_decode_lanes (body _decode_kernel; its interpret-mode twin at :192).
// The second half of the two-kernel decode: the dequantized residuals were
// written by a dequant kernel (dequant_cbr.cu, dequant_vbr.cu) or by plain
// tensor code, and every stream (chunk, channel) walks them in time order
// (the recurrence is written out in decode_ring.cuh).
//
// What bounds it on this card: the dependent chain of one stream (`frames`
// steps), not bytes (2 bytes read and 2 written per sample). Design: the
// shared recurrence ring of decode_ring.cuh, fed by a copy. A block takes
// 32 / C whole chunks (one from 17 channels on); their streams are the
// contiguous columns [chunk0*C, (chunk0 + chunks)*C) of the time-major dq
// stream [frames, N*C], so a tile of the dq ring is `tile` rows of those
// columns side by side. Producer warps copy such tiles from device memory,
// in the widest of 16, 8, 4 or 2 bytes that the block's row offsets allow
// (a row of 3 chunks of 3 channels is 18 bytes; at N*C = 3,100 a row starts
// on 8 bytes), and copy finished PCM tiles out in 8-byte lines. The
// recurrence warps walk only the chain: no dq batches in flight from device
// memory and no 2-byte stores at stride C on the thread that walks it. The
// TPU's layout ([T, R, 128] tiles, time blocks with the state parked in VMEM
// between them, lane padding) has no counterpart: any N, frames and C >= 1,
// no padding.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_ring.cuh"
#include "launch.cuh"

namespace {

using namespace decode_ring;

// a copy leaves the producers time to spare: the recurrence warp's scheduler
// is left to it (decode_ring.cuh)
constexpr bool kIsolate = true;

// A tile of the block's dq columns into a slot of `row` int16 a frame.
struct CopyProducer {
  const Ring& r;
  const int16_t* __restrict__ dq;
  size_t stride;  // N*C, int16 between two frames of the stream
  int row;        // the slot's int16 a frame, a multiple of 8
  int vec;        // the copy's width in int16: 8, 4, 2 or 1

  __device__ void prepare(int) {}

  // kLoads lines a thread at a time, all loaded before any is stored, so
  // that a thread has as many loads from device memory in flight
  template <typename V>
  __device__ __forceinline__ void copy(int nf, const int16_t* src, int16_t* slot) const {
    constexpr int kE = sizeof(V) / sizeof(int16_t), kLoads = 4;
    const int per = r.chunks * r.c / kE;  // lines a frame
    const int total = nf * per;
    const FastDiv div(per);
    for (int base = r.ptid; base < total; base += kLoads * r.prod_threads) {
      V v[kLoads];
      int at[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = min(base + u * r.prod_threads, total - 1);  // past the end: the last again, not stored
        const int f = div(idx), x = idx - f * per;
        v[u] = reinterpret_cast<const V*>(src + f * stride)[x];
        at[u] = f * row / kE + x;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (base + u * r.prod_threads < total) reinterpret_cast<V*>(slot)[at[u]] = v[u];
    }
  }

  __device__ void fill(int i, int16_t* slot) {
    const int f0 = i * r.tile;
    const int nf = min(r.tile, r.frames - f0);
    const int16_t* src = dq + f0 * stride + static_cast<size_t>(r.chunk0) * r.c;
    if (vec == 8) copy<uint4>(nf, src, slot);
    else if (vec == 4) copy<uint2>(nf, src, slot);
    else if (vec == 2) copy<uint32_t>(nf, src, slot);
    else copy<uint16_t>(nf, src, slot);
  }
};

__global__ void __launch_bounds__(kMaxWarps * 32) lms_decode_kernel(
    const int16_t* __restrict__ dq,    // [frames, n, c] dequantized residuals
    const int32_t* __restrict__ hist,  // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,   // [n, c, 4] LMS entry weights
    int16_t* __restrict__ out,         // [n, frames, c] PCM
    int n, int frames, int c, int tile, int group, int rec_warps, int row) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const Ring r = make_ring(smem, n, c, frames, tile, group, tile * row, rec_warps, kIsolate, &rest);
  __syncthreads();
  if (r.ptid >= 0) {
    // the widest copy that every row of the block's columns allows: the
    // stream's base, the stride between frames, the block's first column
    // and its width all multiples of it
    const size_t stride = static_cast<size_t>(n) * c;
    const size_t g = (reinterpret_cast<uintptr_t>(dq) >> 1) | stride |
                     static_cast<size_t>(r.chunk0) * c | static_cast<size_t>(r.chunks) * c;
    const size_t low = g & (~g + 1);
    const int vec = low >= 8 ? 8 : static_cast<int>(low);
    CopyProducer p{r, dq, stride, row, vec};
    produce(r, out, p);
  } else if (threadIdx.x < r.rec_threads) {
    recurrence(r, hist, wts, c, row);
  }
}

}  // namespace

// `tile` (frames per tile, a multiple of 32) and `group` (chunks per block)
// come from the wrapper.
extern "C" int sea_lms_decode(
    const void* dq, const void* hist, const void* wts, void* out, int n,
    int frames, int c, int tile, int group, void* stream) {
  const int rec_warps = (group * c + 31) / 32;
  const int threads = 32 * block_warps(rec_warps, producer_warps(group * c, rec_warps, kIsolate), kIsolate);
  const int row = (group * c + 7) / 8 * 8;
  const size_t smem = kBarrierBytes + kSlots * static_cast<size_t>(tile) * row * sizeof(int16_t) +
                      kSlots * static_cast<size_t>(group) * (tile * c + kPad) * sizeof(int16_t);
  const cudaError_t err = sea_launch::allow_smem(lms_decode_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + group - 1) / group;
  lms_decode_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(dq), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(wts), static_cast<int16_t*>(out), n, frames, c, tile,
      group, rec_warps, row);
  return static_cast<int>(cudaGetLastError());
}
