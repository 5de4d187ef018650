// Fused VBR chunk decode for Hopper (sm_90a): extract + dequant + LMS.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_fused_decode.py:419
// decode_vbr_fused_single (built by _make_vbr_fused_kernel). A VBR chunk's
// residual sizes vary per (window, channel); within a window they are
// constant per channel and the codes are frame-major, channel-minor
// (reference src/codec/chunk.rs:245-271), so a code's bit offset is affine:
//   bit(w, t, ch) = win_start[w] + t*wsum[w] + prefix[w, ch]
// with wsum the window's bits per frame, prefix the bits of the channels
// before ch, and win_start the sum of (frames in window) * wsum over the
// windows before (only the last window may be partial). Per sample, as in
// the reference decoder (src/codec/decoder.rs):
//   code  = rs bits, MSB first, at that offset
//   dq    = +-floor(sfval[rs][sf]*curve(k) + 0.5), k = code >> 1,
//           curve = 0.5 + k*stepfloor[rs] with the k==kmax / k==0 overrides,
//           a lookup of the reference tables dqt[rs][sf][code] of every size
// then the LMS recurrence (decode_ring.cuh).
//
// What bounds it on this card: not bytes (a chunk reads ~rs/8 byte and writes
// 2 bytes per sample) but, as in the CBR kernel, one stream's chain of
// `frames` dependent LMS steps. Design: the shared recurrence ring of
// decode_ring.cuh (32 / C chunks a block, recurrence warps that walk only the
// chain) fed by the VBR producer of producer_vbr.cuh, which the VBR dequant
// prolog (dequant_vbr.cu) shares: for each tile the producer warps build, in
// shared memory, the bit addressing of the windows the tile touches from a
// bit cursor carried from tile to tile, then unpack and dequantize groups of
// four consecutive codes read straight from device memory. No packed row is
// staged, so a row of any length decodes; the tables fit shared memory for
// every sfb 1..8, sff 1..255 and C 1..255 (ops/fused_decode_vbr.py sizes
// them and the launch). The TPU's MXU one-hot word fetch, group/lane
// layout and VMEM gates have no counterpart.
//
// Malformed input: sizes are clamped to 1..8 and scale factors masked to
// 2^sfb as they are read, and bytes at or past the row's end read as zero,
// so no read leaves the row; the plain version (decode_vbr_plain) cleans the
// tables the same way and pads the row with zeros.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_ring.cuh"
#include "launch.cuh"
#include "producer_vbr.cuh"

namespace {

using namespace decode_ring;

// these producers set the kernel's pace: it keeps all fifteen producer warps
// rather than leave the recurrence warp's scheduler to it (decode_ring.cuh)
constexpr bool kIsolate = false;

__global__ void __launch_bounds__(kMaxWarps * 32) fused_decode_vbr_kernel(
    const uint8_t* __restrict__ res,    // [n, res_len] packed residuals
    const uint8_t* __restrict__ sf,     // [n, w, c] scale-factor codes
    const uint8_t* __restrict__ rs,     // [n, w, c] residual sizes 1..8
    const int32_t* __restrict__ hist,   // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,    // [n, c, 4] LMS entry weights
    const int16_t* __restrict__ dqt,    // dqt of sizes 1..8, [n_sf, 2^r] from n_sf * (2^r - 2) on
    int16_t* __restrict__ out,          // [n, frames, c] PCM
    int n, int res_len, int c, int w, int frames, int n_sf, int sff, int tile,
    int group, int rec_warps, int nwmax) {
  // the rings (dq in the PCM ring's layout), then the windows, the entries
  // and the cursors
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const Ring r = make_ring(smem, n, c, frames, tile, group, group * (tile * c + kPad), rec_warps, kIsolate,
                         &rest);
  int2* rows_s = reinterpret_cast<int2*>(rest);
  int2* ents_s = rows_s + group * nwmax;
  int* cursor_s = reinterpret_cast<int*>(ents_s + group * nwmax * c);
  if (threadIdx.x < group) cursor_s[threadIdx.x] = 0;
  __syncthreads();
  if (r.ptid >= 0) {
    VbrProducer p{r, res, sf, rs, dqt, rows_s, ents_s, cursor_s, res_len, w, n_sf, sff, nwmax,
                  FastDiv(c), FastDiv(sff), 0, 0};
    produce(r, out, p);
  } else if (threadIdx.x < r.rec_threads) {
    recurrence(r, hist, wts, r.sub, c);
  }
}

}  // namespace

// `tile` (frames per tile, a multiple of 32), `group` (chunks per block),
// `nwmax` (windows a tile can touch) and `smem` (the block's dynamic shared
// memory: the barriers, the rings and the window tables) come from the
// wrapper (ops/fused_decode_vbr.py), which sizes the shared memory.
extern "C" int sea_fused_decode_vbr(
    const void* res, const void* sf, const void* rs, const void* hist,
    const void* wts, const void* dqt, void* out, int n, int res_len, int c, int w,
    int frames, int n_sf, int sff, int tile, int group, int nwmax, int smem, void* stream) {
  const int rec_warps = (group * c + 31) / 32;
  const int threads = 32 * block_warps(rec_warps, producer_warps(group * c, rec_warps, kIsolate), kIsolate);
  const cudaError_t err = sea_launch::allow_smem(fused_decode_vbr_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + group - 1) / group;
  fused_decode_vbr_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const uint8_t*>(rs), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(wts), static_cast<const int16_t*>(dqt),
      static_cast<int16_t*>(out), n, res_len, c, w, frames, n_sf, sff, tile, group,
      rec_warps, nwmax);
  return static_cast<int>(cudaGetLastError());
}
