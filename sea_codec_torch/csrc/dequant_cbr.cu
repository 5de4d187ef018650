// CBR unpack + dequant for Hopper (sm_90a): packed residual bytes -> the
// int16 dq stream that lms_decode.cu walks.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_dequant.py:108
// unpack_dequant_cbr_lanes (body from _make_dequant_kernel), the prolog of
// the two-kernel decode. Per sample, as in the reference decoder
// (src/codec/decoder.rs):
//   code = rs bits, MSB first, at bit (frame*C + ch)*rs of the chunk's
//          residual section: a 16-bit window over the byte pair at bit>>3,
//          one shift and one mask
//   dq   = +-floor(sfval*curve(k) + 0.5), k = code >> 1, sign = code & 1,
//          curve = 0.5 + k*stepfloor with the k==kmax / k==0 overrides.
//
// What bounds it on this card: bytes. A sample reads ~rs/8 byte and writes
// 2 bytes and costs a dozen instructions; nothing depends on anything else.
// Design: one thread per stream (chunk, channel), a block of DQ_STREAMS
// streams by DQ_FRAMES frames. The output is time-major [frames, streams]
// (the layout the recurrence kernel loads coalesced), so a warp's stores of
// one frame are one 64-byte write. A thread's reads of successive frames
// are C*rs bits apart in one chunk's row, so a sector fetched for one frame
// serves the following ones from L1. Nothing is staged per chunk, so a row
// of any length decodes (the fused kernel stages a whole row in shared
// memory and stops at 227 KB). The TPU's layout (byte-plane transpose,
// chunks on 512 lanes, blocks of m whole windows, the 8-code period
// shuffle) has no counterpart, and neither has its whole-windows-only gate:
// a partial last window is a shorter frame loop. Bytes past the row read as
// zero, as the fused kernels pad their staged copy.
//
// Rounding: the two f32 steps of the dequant curve and of floor(x*c + 0.5)
// are separate roundings in the table build; __fmul_rn/__fadd_rn keep nvcc
// from contracting them into an FMA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DQ_STREAMS = 128;
constexpr int DQ_FRAMES = 64;

__global__ void dequant_cbr_kernel(
    const uint8_t* __restrict__ res,  // [n, res_stride] packed residuals
    const uint8_t* __restrict__ sf,   // [n, w, c] scale-factor codes
    const float* __restrict__ sfval,  // [n_sf] scale-factor values for rs
    int16_t* __restrict__ out,        // [frames, streams] dq
    int streams, int res_stride, int c, int w, int frames, int n_sf, int rs,
    int sff, float c0, float stepf, float endv, int kmax) {
  const int s = blockIdx.x * DQ_STREAMS + threadIdx.x;
  if (s >= streams) return;
  const int chunk = s / c, ch = s - chunk * c;
  const uint8_t* row = res + static_cast<size_t>(chunk) * res_stride;
  const uint8_t* sf_row = sf + static_cast<size_t>(chunk) * w * c + ch;
  const int f0 = blockIdx.y * DQ_FRAMES;
  const int f1 = min(f0 + DQ_FRAMES, frames);
  const int mask = (1 << rs) - 1;
  int win = f0 / sff, t = f0 - win * sff;
  float sfv = sfval[sf_row[win * c] & (n_sf - 1)];
  for (int f = f0; f < f1; ++f) {
    const int bit = (f * c + ch) * rs;
    const int idx = bit >> 3;
    const int hi = idx < res_stride ? row[idx] : 0;
    const int lo = idx + 1 < res_stride ? row[idx + 1] : 0;
    const int q = (((hi << 8) | lo) >> (16 - (bit & 7) - rs)) & mask;
    const int k = q >> 1;
    float curve = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(k), stepf));
    if (k == kmax) curve = endv;
    if (k == 0) curve = c0;
    const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(sfv, curve), 0.5f)));
    out[static_cast<size_t>(f) * streams + s] = static_cast<int16_t>((q & 1) ? -dq_abs : dq_abs);
    if (++t == sff && f + 1 < f1) {
      t = 0;
      ++win;
      sfv = sfval[sf_row[win * c] & (n_sf - 1)];
    }
  }
}

}  // namespace

extern "C" int sea_dequant_cbr(
    const void* res, const void* sf, const void* sfval, void* out, int n,
    int res_stride, int c, int w, int frames, int n_sf, int rs, int sff,
    float c0, float stepf, float endv, int kmax, void* stream) {
  const int streams = n * c;
  const dim3 grid((streams + DQ_STREAMS - 1) / DQ_STREAMS, (frames + DQ_FRAMES - 1) / DQ_FRAMES);
  dequant_cbr_kernel<<<grid, DQ_STREAMS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const float*>(sfval), static_cast<int16_t*>(out), streams,
      res_stride, c, w, frames, n_sf, rs, sff, c0, stepf, endv, kmax);
  return static_cast<int>(cudaGetLastError());
}
