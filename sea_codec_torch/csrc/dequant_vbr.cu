// VBR extract + dequant for Hopper (sm_90a): packed variable-width residual
// bytes -> the int16 dq stream that lms_decode.cu walks, the bit addressing
// included.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_dequant.py:322
// unpack_dequant_vbr_lanes (body from _make_vbr_dequant_kernel), the VBR
// prolog of the two-kernel decode, together with the addressing the JAX
// package computes outside its kernel (ops/device_decode.py, the window
// starts, bits per frame and channel prefixes as prefix sums over the size
// table). A code's bit offset in its row is affine within a window,
//   bit(w, t, ch) = win_start[w] + t*wsum[w] + prefix[w, ch],
// and dq = +-floor(sfval[r][sf]*curve(k) + 0.5) with r the window's size for
// the channel, here read from the reference tables dqt[r][sf][code] of
// every size (ops/tables.py dq_table); producer_vbr.cuh does both.
//
// What bounds it on this card: instructions and their latency. A sample
// reads ~r/8 byte and writes 2; per (window, channel) the size and the
// scale factor are read once and summed into the prefixes. But a block
// walks its tiles in series (each tile's tables start from the bit cursor
// the last one left), and each code is walked by its own size: ~46 integer
// instructions a sample. An earlier design computed the prefix sums in the
// wrapper with a dozen tensor ops, each a launch.
//
// Design: the fused VBR decode's producer without the recurrence, one launch
// per call. A block takes `group` chunks and walks their tiles of `tile`
// frames in order, every warp a producer: for each tile it builds the
// windows' addressing in shared memory (a warp per chunk scans the sizes
// across channels and fiw * wsum across windows from the chunk's bit cursor,
// which it carries to the next tile), fills a dq slot (one sub-tile [tile,
// C] per chunk) from groups of four consecutive codes read straight from
// device memory, and copies the slot out time-major (tiles.cuh store_rows:
// row f of the block's columns is contiguous in the stream, written in the
// widest of 16, 8, 4 or 2 bytes the rows' offsets allow). Before its walk a
// block asks for its rows and tables into L2, so that each tile's loads do
// not wait on device memory. The tables are sized for the most windows a
// tile can touch, so they fit shared memory for every sfb 1..8, sff 1..255
// and C 1..255; no packed row is staged, so a row of any length decodes.
// The TPU's one-hot MXU word fetch, word-pair select chain, group/lane
// planes and block planner have no counterpart. Memory safety on malformed
// input: sizes clamp to 1..8, scale factors mask to 2^sfb, and bytes at or
// past the row's end read as zero.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "producer_vbr.cuh"

namespace {

using namespace decode_tiles;

constexpr int kPad = 4;  // int16 after each sub-tile: keeps the 8-byte stores aligned
constexpr int kMaxThreads = 512;

// a line of device memory into L2, ahead of its use
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(kMaxThreads) dequant_vbr_kernel(
    const uint8_t* __restrict__ res,  // [n, res_len] packed residuals
    const uint8_t* __restrict__ sf,   // [n, w, c] scale-factor codes
    const uint8_t* __restrict__ rs,   // [n, w, c] residual sizes 1..8
    const int16_t* __restrict__ dqt,  // dqt of sizes 1..8, [n_sf, 2^r] from n_sf * (2^r - 2) on
    int16_t* __restrict__ out,        // [frames, n, c] dq
    int n, int res_len, int c, int w, int frames, int n_sf, int sff, int tile, int group,
    int nwmax) {
  // the dq slot, then the windows, the entries and the cursors
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles t;
  t.c = c;
  t.tile = tile;
  t.frames = frames;
  t.chunk0 = blockIdx.x * group;
  t.chunks = min(group, n - t.chunk0);
  t.sub = tile * c + kPad;
  t.prod_threads = blockDim.x;
  t.ptid = threadIdx.x;
  int16_t* slot = reinterpret_cast<int16_t*>(smem);
  int2* rows_s = reinterpret_cast<int2*>(smem + (static_cast<size_t>(group) * t.sub * 2 + 15) / 16 * 16);
  int2* ents_s = rows_s + group * nwmax;
  int* cursor_s = reinterpret_cast<int*>(ents_s + group * nwmax * c);
  if (threadIdx.x < group) cursor_s[threadIdx.x] = 0;
  // the block walks its tiles in series, each behind loads of its tables
  // and its codes: ask for all of them into L2 at once
  const size_t rows = static_cast<size_t>(t.chunks) * res_len, tabs = static_cast<size_t>(t.chunks) * w * c;
  for (size_t b = static_cast<size_t>(threadIdx.x) * 128; b < rows; b += static_cast<size_t>(blockDim.x) * 128)
    prefetch_l2(res + static_cast<size_t>(t.chunk0) * res_len + b);
  for (size_t b = static_cast<size_t>(threadIdx.x) * 128; b < tabs; b += static_cast<size_t>(blockDim.x) * 128) {
    prefetch_l2(rs + static_cast<size_t>(t.chunk0) * w * c + b);
    prefetch_l2(sf + static_cast<size_t>(t.chunk0) * w * c + b);
  }
  __syncthreads();
  VbrProducer p{t, res, sf, rs, dqt, rows_s, ents_s, cursor_s, res_len, w, n_sf, sff, nwmax,
                FastDiv(c), FastDiv(sff), 0, 0};
  const size_t stride = static_cast<size_t>(n) * c;
  const int vec = row_vector(t, out, stride);
  const int ntiles = (frames + tile - 1) / tile;
  for (int i = 0; i < ntiles; ++i) {
    p.prepare(i);  // waits until every thread is done with tile i - 1
    p.fill(i, slot);
    __syncthreads();
    store_rows(t, slot, i * tile, p.nf, out, stride, vec);
  }
}

}  // namespace

// `tile` (frames per tile, a multiple of 32), `group` (chunks per block),
// `threads` (a multiple of 32, at most kMaxThreads), `nwmax` (windows a tile
// can touch) and `smem` (the block's dynamic shared memory: the dq slot, then
// the window tables) come from the wrapper (ops/dequant.py), which sizes the
// launch.
extern "C" int sea_dequant_vbr(
    const void* res, const void* sf, const void* rs, const void* dqt, void* out, int n,
    int res_len, int c, int w, int frames, int n_sf, int sff, int tile, int group, int threads,
    int nwmax, int smem, void* stream) {
  const cudaError_t err = sea_launch::allow_smem(dequant_vbr_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + group - 1) / group;
  dequant_vbr_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const uint8_t*>(rs), static_cast<const int16_t*>(dqt),
      static_cast<int16_t*>(out), n, res_len, c, w, frames, n_sf, sff, tile, group, nwmax);
  return static_cast<int>(cudaGetLastError());
}
