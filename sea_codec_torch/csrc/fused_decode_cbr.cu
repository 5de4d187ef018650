// Fused CBR chunk decode for Hopper (sm_90a): unpack + dequant + LMS.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_fused_decode.py
// decode_cbr_fused_single (built by _make_fused_kernel). Per sample, as in
// the reference decoder (src/codec/decoder.rs):
//   code  = rs bits, MSB first, at bit (frame*C + ch)*rs of the chunk's
//           residual section
//   dq    = +-floor(sfval*curve(k) + 0.5), k = code >> 1, sign = code & 1,
//           curve = 0.5 + k*stepfloor with the k==kmax / k==0 overrides
//   pred  = (sum w_i*h_i) >> 13 (wrapping int32), recon = clamp_i16(pred+dq)
//   w_i  += h_i < 0 ? -(dq >> 4) : dq >> 4, history shifts in recon.
//
// What bounds it on this card: not bytes (a chunk reads ~rs/8 byte and writes
// 2 bytes per sample) but the recurrence: a stream is a chain of `frames`
// dependent steps (the dot's last multiply-add, a shift, an add, the clamp),
// and a chunk holds only C streams. Whatever else the thread that walks the
// chain has to issue (unpack, dequant, scattered 2-byte stores) lengthens
// every step, because a lone warp pays each instruction's latency in order.
//
// Design: the shared recurrence ring of decode_ring.cuh (a block of 32 / C
// chunks, recurrence warps that walk only the chain, producer warps, and
// mbarriers between them). This file adds the producer: eight consecutive
// codes are exactly rs bytes, so a producer thread reads one byte-aligned
// group straight from device memory (no staged row: a row of any length
// decodes), dequantizes its eight samples and stores them into the dq ring,
// which has the PCM ring's layout. The TPU layout (byte-plane transpose,
// chunk = g*128 + lane, VMEM block planning) has no counterpart.
//
// Rounding: the two f32 steps of the dequant curve and of floor(x*c + 0.5)
// are separate roundings in the table build; __fmul_rn/__fadd_rn keep nvcc
// from contracting them into an FMA.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_ring.cuh"

namespace {

using namespace decode_ring;

// these producers have time to spare: the recurrence warp's scheduler is left
// to it (decode_ring.cuh)
constexpr bool kIsolate = true;

// Unpack + dequant of a tile of every chunk of the block into a dq slot laid
// out like the PCM ring (one sub-tile [tile, C] per chunk).
struct CbrProducer {
  const Ring& r;
  const uint8_t* __restrict__ res;
  const uint8_t* __restrict__ sf;
  const float* sfv_s;
  int res_stride, res_bytes, w, n_sf, rs, sff, kmax;
  float c0, stepf, endv;

  __device__ void prepare(int) {}

  __device__ void fill(int i, int16_t* slot) {
    const int c = r.c;
    const int mask = (1 << rs) - 1;
    const int f0 = i * r.tile;
    const int nsamp = min(r.tile, r.frames - f0) * c;
    const int groups = (nsamp + 7) / 8;  // of eight codes, per chunk
    for (int idx = r.ptid; idx < r.chunks * groups; idx += r.prod_threads) {
      const int k = idx / groups, g = idx - k * groups;
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
      int fl = (g * 8) / c;  // frame within the tile, then its channel
      int ch = g * 8 - fl * c;
      int win = (f0 + fl) / sff;
      int fin = (f0 + fl) - win * sff;  // frame within its window
      __align__(8) int16_t vals[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = static_cast<int>(bits >> (64 - rs * (u + 1))) & mask;
        const int wi = min(win, w - 1);  // a partial group runs past the chunk
        const float sfv = sfv_s[sf_row[wi * c + ch] & (n_sf - 1)];
        const int kq = q >> 1;
        float curve = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(kq), stepf));
        if (kq == kmax) curve = endv;
        if (kq == 0) curve = c0;
        const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(sfv, curve), 0.5f)));
        vals[u] = static_cast<int16_t>((q & 1) ? -dq_abs : dq_abs);
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

__global__ void __launch_bounds__(kMaxWarps * 32) fused_decode_cbr_kernel(
    const uint8_t* __restrict__ res,    // [n, res_stride] packed residuals
    const uint8_t* __restrict__ sf,     // [n, w, c] scale-factor codes
    const int32_t* __restrict__ hist,   // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,    // [n, c, 4] LMS entry weights
    const float* __restrict__ sfval,    // [2^sfb] scale-factor values for rs
    int16_t* __restrict__ out,          // [n, frames, c] PCM
    int n, int res_stride, int res_bytes, int c, int w, int frames, int n_sf,
    int rs, int sff, int tile, int group, int rec_warps, float c0,
    float stepf, float endv, int kmax) {
  // the rings (dq in the PCM ring's layout), then the scale-factor values
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const Ring r = make_ring(smem, n, c, frames, tile, group, group * (tile * c + kPad), rec_warps, kIsolate,
                         &rest);
  float* sfv_s = reinterpret_cast<float*>(rest);
  for (int i = threadIdx.x; i < n_sf; i += blockDim.x) sfv_s[i] = sfval[i];
  __syncthreads();
  if (r.ptid >= 0) {
    CbrProducer p{r, res, sf, sfv_s, res_stride, res_bytes, w, n_sf, rs, sff, kmax, c0, stepf, endv};
    produce(r, out, p);
  } else if (threadIdx.x < r.rec_threads) {
    recurrence(r, hist, wts, r.sub, c);
  }
}

}  // namespace

// `tile` (frames per tile, a multiple of 32) and `group` (chunks per block:
// as many as give one warp of streams, 1 from 17 channels on) come from the
// wrapper, which sizes the shared memory by them too.
extern "C" int sea_fused_decode_cbr(
    const void* res, const void* sf, const void* hist, const void* wts,
    const void* sfval, void* out, int n, int res_stride, int res_bytes, int c,
    int w, int frames, int n_sf, int rs, int sff, int tile, int group,
    float c0, float stepf, float endv, int kmax, void* stream) {
  const int streams = group * c;
  const int rec_warps = (streams + 31) / 32;
  const int threads = 32 * block_warps(rec_warps, producer_warps(streams, rec_warps, kIsolate), kIsolate);
  const size_t smem = kBarrierBytes + 2 * kSlots * static_cast<size_t>(group) * (tile * c + kPad) * sizeof(int16_t) +
                      sizeof(float) * n_sf;
  cudaFuncSetAttribute(fused_decode_cbr_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int blocks = (n + group - 1) / group;
  fused_decode_cbr_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const int32_t*>(hist), static_cast<const int32_t*>(wts),
      static_cast<const float*>(sfval), static_cast<int16_t*>(out), n, res_stride,
      res_bytes, c, w, frames, n_sf, rs, sff, tile, group, rec_warps, c0, stepf, endv,
      kmax);
  return static_cast<int>(cudaGetLastError());
}
