// CBR unpack + dequant for Hopper (sm_90a): packed residual bytes -> the
// int16 dq stream that lms_decode.cu walks.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_dequant.py:108
// unpack_dequant_cbr_lanes (body from _make_dequant_kernel), the prolog of
// the two-kernel decode. Per sample, as in the reference decoder
// (src/codec/decoder.rs): code = rs bits, MSB first, at bit (frame*C + ch)*rs
// of the chunk's residual section, dq = +-floor(sfval*curve(k) + 0.5), here
// read from the reference table dqt[sf][code] (ops/tables.py dq_table).
//
// What bounds it on this card: instructions. A sample reads rs/8 byte and
// writes 2, and no sample depends on another, but unpacking, the table
// lookup and the copy to the time-major stream cost ~30 integer
// instructions a sample. An earlier design, one thread per (chunk, channel)
// stream with two guarded byte loads a sample from its own chunk's row,
// made each warp-wide load touch ~16 rows: the loads set its pace.
//
// Design: the fused CBR decode's producer (producer_cbr.cuh) without the
// recurrence. A block takes `group` chunks (as many as fill a warp with
// streams, as in the ring) and one tile of `tile` frames (the grid's y):
// every warp is a producer. They fill a shared-memory dq slot, one sub-tile
// [tile, C] per chunk, from byte-aligned groups of eight codes (rs bytes: a
// warp's loads fall in 32*rs contiguous bytes of one row) with two 8-byte
// stores each, then copy the slot out time-major (tiles.cuh store_rows):
// row f of the block's columns is contiguous in the stream, written in the
// widest of 16, 8, 4 or 2 bytes that the rows' offsets allow. CBR
// addressing is affine, so the tiles of a chunk are independent blocks.
// Nothing is staged per row, so a row of any length decodes; bytes past the
// codes' last byte read as zero, and scale factors mask to 2^sfb. The TPU's
// layout (byte-plane transpose, chunks on 512 lanes, blocks of m whole
// windows, the 8-code period shuffle) has no counterpart, and neither has
// its whole-windows-only gate: a partial last window or tile decodes.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "producer_cbr.cuh"

namespace {

using namespace decode_tiles;

constexpr int kPad = 4;  // int16 after each sub-tile: keeps the 8-byte stores aligned
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads) dequant_cbr_kernel(
    const uint8_t* __restrict__ res,  // [n, res_stride] packed residuals
    const uint8_t* __restrict__ sf,   // [n, w, c] scale-factor codes
    const int16_t* __restrict__ dqt,  // [n_sf, 2^rs] dq by (scale factor, code)
    int16_t* __restrict__ out,        // [frames, n, c] dq
    int n, int res_stride, int res_bytes, int c, int w, int frames, int n_sf, int rs,
    int sff, int tile, int group) {
  // the dq slot
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
  CbrProducer p{t, res, sf, dqt, res_stride, res_bytes, w, n_sf, rs, sff, FastDiv(c), FastDiv(sff)};
  const int i = blockIdx.y;
  p.fill(i, slot);
  __syncthreads();
  const size_t stride = static_cast<size_t>(n) * c;
  store_rows(t, slot, i * tile, min(tile, frames - i * tile), out, stride, row_vector(t, out, stride));
}

}  // namespace

// `tile` (frames per tile, a multiple of 32), `group` (chunks per block),
// `threads` (a multiple of 32, at most kMaxThreads) and `smem` (the block's
// dynamic shared memory: the dq slot) come from the wrapper (ops/dequant.py),
// which sizes the launch.
extern "C" int sea_dequant_cbr(
    const void* res, const void* sf, const void* dqt, void* out, int n,
    int res_stride, int res_bytes, int c, int w, int frames, int n_sf, int rs, int sff,
    int tile, int group, int threads, int smem, void* stream) {
  const cudaError_t err = sea_launch::allow_smem(dequant_cbr_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + group - 1) / group, (frames + tile - 1) / tile);
  dequant_cbr_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const int16_t*>(dqt), static_cast<int16_t*>(out), n, res_stride, res_bytes,
      c, w, frames, n_sf, rs, sff, tile, group);
  return static_cast<int>(cudaGetLastError());
}
