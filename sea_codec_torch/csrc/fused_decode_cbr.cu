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
// mbarriers between them) fed by the CBR producer of producer_cbr.cuh, which
// the CBR dequant prolog (dequant_cbr.cu) shares: eight consecutive codes
// are exactly rs bytes, so a producer thread reads one byte-aligned group
// straight from device memory (no staged row: a row of any length decodes),
// dequantizes its eight samples (a lookup of the reference table dqt[sf][code],
// bit-exact by construction) and stores them into the dq ring, which has the
// PCM ring's layout. The TPU layout (byte-plane transpose, chunk = g*128 +
// lane, VMEM block planning) has no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_ring.cuh"
#include "launch.cuh"
#include "producer_cbr.cuh"

namespace {

using namespace decode_ring;

// these producers have time to spare: the recurrence warp's scheduler is left
// to it (decode_ring.cuh)
constexpr bool kIsolate = true;

__global__ void __launch_bounds__(kMaxWarps * 32) fused_decode_cbr_kernel(
    const uint8_t* __restrict__ res,    // [n, res_stride] packed residuals
    const uint8_t* __restrict__ sf,     // [n, w, c] scale-factor codes
    const int32_t* __restrict__ hist,   // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,    // [n, c, 4] LMS entry weights
    const int16_t* __restrict__ dqt,    // [n_sf, 2^rs] dq by (scale factor, code)
    int16_t* __restrict__ out,          // [n, frames, c] PCM
    int n, int res_stride, int res_bytes, int c, int w, int frames, int n_sf,
    int rs, int sff, int tile, int group, int rec_warps) {
  // the rings (dq in the PCM ring's layout)
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const Ring r = make_ring(smem, n, c, frames, tile, group, group * (tile * c + kPad), rec_warps, kIsolate,
                         &rest);
  __syncthreads();  // the barriers are initialised
  if (r.ptid >= 0) {
    CbrProducer p{r, res, sf, dqt, res_stride, res_bytes, w, n_sf, rs, sff, FastDiv(c), FastDiv(sff)};
    produce(r, out, p);
  } else if (threadIdx.x < r.rec_threads) {
    recurrence(r, hist, wts, r.sub, c);
  }
}

}  // namespace

// `tile` (frames per tile, a multiple of 32), `group` (chunks per block: as
// many as give one warp of streams, 1 from 17 channels on) and `smem` (the
// block's dynamic shared memory: the barriers and the two rings) come from
// the wrapper (ops/fused_decode.py), which sizes the shared memory.
extern "C" int sea_fused_decode_cbr(
    const void* res, const void* sf, const void* hist, const void* wts,
    const void* dqt, void* out, int n, int res_stride, int res_bytes, int c,
    int w, int frames, int n_sf, int rs, int sff, int tile, int group, int smem,
    void* stream) {
  const int streams = group * c;
  const int rec_warps = (streams + 31) / 32;
  const int threads = 32 * block_warps(rec_warps, producer_warps(streams, rec_warps, kIsolate), kIsolate);
  const cudaError_t err = sea_launch::allow_smem(fused_decode_cbr_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + group - 1) / group;
  fused_decode_cbr_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const int32_t*>(hist), static_cast<const int32_t*>(wts),
      static_cast<const int16_t*>(dqt), static_cast<int16_t*>(out), n, res_stride,
      res_bytes, c, w, frames, n_sf, rs, sff, tile, group, rec_warps);
  return static_cast<int>(cudaGetLastError());
}
