// VBR extract + dequant for Hopper (sm_90a): packed variable-width residual
// bytes -> the int16 dq stream that lms_decode.cu walks.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_dequant.py:322
// unpack_dequant_vbr_lanes (body from _make_vbr_dequant_kernel), the VBR
// prolog of the two-kernel decode. A VBR chunk's residual sizes vary per
// (window, channel); within a window they are constant per channel and the
// codes are frame-major, channel-minor (reference src/codec/chunk.rs:245-271),
// so a code's bit offset is affine:
//   bit(w, t, ch) = win_start[w] + t*wsum[w] + prefix[w, ch]
// with wsum the window's bits per frame, prefix the bits of the channels
// before ch, and win_start the bits of the windows before. Those three are
// prefix sums over the size table; as in the JAX package they are computed
// outside the kernel (the wrapper's cumsum). Per sample:
//   code = r bits, MSB first, at that offset (16-bit window over the byte
//          pair at bit>>3), r the window's size for the channel
//   dq   = +-floor(sfval[r][sf]*curve(k) + 0.5), k = code >> 1,
//          curve = 0.5 + k*stepfloor[r] with the k==kmax / k==0 overrides.
//
// What bounds it on this card: bytes (a sample reads ~r/8 byte and writes 2
// bytes; per window and stream, up to 14 bytes of sizes and offsets). Design:
// dequant_cbr.cu's: one thread per stream, a block of DQ_STREAMS streams by
// DQ_FRAMES frames, time-major coalesced stores, nothing staged per chunk.
// A thread walks its frame tile window by window and loads the window's
// size, offsets, scale factor and curve constants when it enters one. The
// TPU's one-hot MXU word fetch, word-pair select chain, group/lane planes
// and block planner have no counterpart. Memory safety on malformed input:
// sizes clamp to 1..8, scale factors mask to 2^sfb, byte indices clamp to
// the row and bytes past it read as zero, as fused_decode_vbr.cu stages them.
//
// Rounding: as in dequant_cbr.cu, __fmul_rn/__fadd_rn keep the two f32
// roundings of the table build apart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DQ_STREAMS = 128;
constexpr int DQ_FRAMES = 64;

__global__ void dequant_vbr_kernel(
    const uint8_t* __restrict__ res,        // [n, res_len] packed residuals
    const uint8_t* __restrict__ sf,         // [n, w, c] scale-factor codes
    const uint8_t* __restrict__ rs,         // [n, w, c] residual sizes 1..8
    const int32_t* __restrict__ win_start,  // [n, w] first bit of the window
    const int32_t* __restrict__ wsum,       // [n, w] bits per frame
    const int32_t* __restrict__ prefix,     // [n, w, c] bits of channels before
    const float* __restrict__ sfval,        // [9, n_sf] scale-factor values by size
    const float* __restrict__ curve,        // [3, 9] c0, stepfloor, endval by size
    const int32_t* __restrict__ kmax_g,     // [9] kmax by size
    int16_t* __restrict__ out,              // [frames, streams] dq
    int streams, int res_len, int c, int w, int frames, int n_sf, int sff) {
  const int s = blockIdx.x * DQ_STREAMS + threadIdx.x;
  if (s >= streams) return;
  const int chunk = s / c, ch = s - chunk * c;
  const uint8_t* row = res + static_cast<size_t>(chunk) * res_len;
  const size_t wbase = static_cast<size_t>(chunk) * w;
  const int f0 = blockIdx.y * DQ_FRAMES;
  const int f1 = min(f0 + DQ_FRAMES, frames);
  int f = f0;
  int win = f0 / sff, t = f0 - win * sff;
  while (f < f1) {
    const size_t wi = wbase + win, wc = wi * c + ch;
    const int r = min(max(static_cast<int>(rs[wc]), 1), 8);
    const int mask = (1 << r) - 1;
    const float sfv = sfval[r * n_sf + (sf[wc] & (n_sf - 1))];
    const float c0 = curve[r], stepf = curve[9 + r], endv = curve[18 + r];
    const int kmax = kmax_g[r];
    const int step = wsum[wi];
    int bit = win_start[wi] + t * step + prefix[wc];
    const int fend = min(f1, f + (sff - t));
    for (; f < fend; ++f, bit += step) {
      const int idx = min(max(bit >> 3, 0), res_len);
      const int hi = idx < res_len ? row[idx] : 0;
      const int lo = idx + 1 < res_len ? row[idx + 1] : 0;
      const int q = (((hi << 8) | lo) >> (16 - (bit & 7) - r)) & mask;
      const int k = q >> 1;
      float cv = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(k), stepf));
      if (k == kmax) cv = endv;
      if (k == 0) cv = c0;
      const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(sfv, cv), 0.5f)));
      out[static_cast<size_t>(f) * streams + s] = static_cast<int16_t>((q & 1) ? -dq_abs : dq_abs);
    }
    t = 0;
    ++win;
  }
}

}  // namespace

extern "C" int sea_dequant_vbr(
    const void* res, const void* sf, const void* rs, const void* win_start,
    const void* wsum, const void* prefix, const void* sfval, const void* curve,
    const void* kmax, void* out, int n, int res_len, int c, int w, int frames,
    int n_sf, int sff, void* stream) {
  const int streams = n * c;
  const dim3 grid((streams + DQ_STREAMS - 1) / DQ_STREAMS, (frames + DQ_FRAMES - 1) / DQ_FRAMES);
  dequant_vbr_kernel<<<grid, DQ_STREAMS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const uint8_t*>(rs), static_cast<const int32_t*>(win_start),
      static_cast<const int32_t*>(wsum), static_cast<const int32_t*>(prefix),
      static_cast<const float*>(sfval), static_cast<const float*>(curve),
      static_cast<const int32_t*>(kmax), static_cast<int16_t*>(out), streams,
      res_len, c, w, frames, n_sf, sff);
  return static_cast<int>(cudaGetLastError());
}
