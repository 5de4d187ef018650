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
//           curve = 0.5 + k*stepfloor[rs] with the k==kmax / k==0 overrides
//   pred  = (sum w_i*h_i) >> 13 (wrapping int32), recon = clamp_i16(pred+dq)
//   w_i  += h_i < 0 ? -(dq >> 4) : dq >> 4, history shifts in recon.
//
// What bounds it on this card: not bytes (a chunk reads ~rs/8 byte and writes
// 2 bytes per sample). As in the CBR kernel, every stream is a chain of
// `frames` dependent LMS steps, and with one block per chunk and C of its
// lanes busy, instruction issue sets the pace before the chain does (see
// PERF.md). Design: the CBR kernel's (fused_decode_cbr.cu): one block per
// chunk, one thread per channel stream, the chunk's residual bytes (<= 65535
// by the u16 chunk_size) staged in shared memory with a 2-byte pad and each
// code read through a 16-bit window. What VBR adds: the chunk's size table
// [W, C] and the scale-factor values of all sizes [9, 2^sfb] are staged too,
// and each thread keeps a running window bit cursor. At each window it reads
// the window's C sizes from shared memory for wsum and its own prefix: O(C)
// reads per window, i.e. O(C/sff) per sample, small beside the sample work
// at the usual C <= 8 and acceptable at 255. The window's curve constants
// are selected by its size. The TPU's MXU one-hot word fetch, group/lane
// layout and VMEM gates have no counterpart: every C 1..255, sfb 1..8 and
// size mix 1..8 runs. Memory safety on malformed input: staged sizes are
// clamped to 1..8, scale factors masked to 2^sfb, and byte indices clamped to
// the staged row (the plain version clamps the same way).
//
// Rounding: the two f32 steps of the dequant curve and of floor(x*c + 0.5)
// are separate roundings in the table build; __fmul_rn/__fadd_rn keep nvcc
// from contracting them into an FMA. The int32 dot wraps like the reference,
// so it is computed in uint32 and reinterpreted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void fused_decode_vbr_kernel(
    const uint8_t* __restrict__ res,    // [n, res_len] packed residuals
    const uint8_t* __restrict__ sf,     // [n, w, c] scale-factor codes
    const uint8_t* __restrict__ rs,     // [n, w, c] residual sizes 1..8
    const int32_t* __restrict__ hist,   // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,    // [n, c, 4] LMS entry weights
    const float* __restrict__ sfval,    // [9, n_sf] scale-factor values by rs
    const float* __restrict__ curve,    // [3, 9] c0, stepfloor, endval by rs
    const int32_t* __restrict__ kmax_g, // [9] kmax by rs
    int16_t* __restrict__ out,          // [n, frames, c] PCM
    int res_len, int c, int w, int frames, int n_sf, int sff) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sfv_s = reinterpret_cast<float*>(smem);  // [9 * n_sf]
  float* curve_s = sfv_s + 9 * n_sf;              // [27]
  int32_t* kmax_s = reinterpret_cast<int32_t*>(curve_s + 27);  // [9]
  uint8_t* rs_s = reinterpret_cast<uint8_t*>(kmax_s + 9);      // [w * c]
  uint8_t* bytes_s = rs_s + w * c;                              // [res_len + 2]
  const int chunk = blockIdx.x;
  const uint8_t* row = res + static_cast<size_t>(chunk) * res_len;
  const uint8_t* rs_row = rs + static_cast<size_t>(chunk) * w * c;
  for (int i = threadIdx.x; i < res_len; i += blockDim.x) bytes_s[i] = row[i];
  if (threadIdx.x < 2) bytes_s[res_len + threadIdx.x] = 0;  // 16-bit window pad
  for (int i = threadIdx.x; i < w * c; i += blockDim.x)
    rs_s[i] = static_cast<uint8_t>(min(max(static_cast<int>(rs_row[i]), 1), 8));
  for (int i = threadIdx.x; i < 9 * n_sf; i += blockDim.x) sfv_s[i] = sfval[i];
  for (int i = threadIdx.x; i < 27; i += blockDim.x) curve_s[i] = curve[i];
  for (int i = threadIdx.x; i < 9; i += blockDim.x) kmax_s[i] = kmax_g[i];
  __syncthreads();

  const int ch = threadIdx.x;
  if (ch >= c) return;
  const size_t st = (static_cast<size_t>(chunk) * c + ch) * 4;
  int32_t h0 = hist[st], h1 = hist[st + 1], h2 = hist[st + 2], h3 = hist[st + 3];
  int32_t w0 = wts[st], w1 = wts[st + 1], w2 = wts[st + 2], w3 = wts[st + 3];
  const uint8_t* sf_row = sf + static_cast<size_t>(chunk) * w * c + ch;
  int16_t* out_row = out + static_cast<size_t>(chunk) * frames * c + ch;
  int cursor = 0;  // bit offset of the window's first code
  for (int wi = 0; wi < w; ++wi) {
    const uint8_t* sizes = rs_s + wi * c;
    int wsum = 0, prefix = 0;
    for (int j = 0; j < c; ++j) {
      const int r = sizes[j];
      wsum += r;
      prefix += j < ch ? r : 0;
    }
    const int rsw = sizes[ch];
    const int mask = (1 << rsw) - 1;
    const float sfv = sfv_s[rsw * n_sf + (sf_row[wi * c] & (n_sf - 1))];
    const float c0 = curve_s[rsw], stepf = curve_s[9 + rsw], endv = curve_s[18 + rsw];
    const int kmax = kmax_s[rsw];
    const int fw = min(sff, frames - wi * sff);
    int bit = cursor + prefix;
    for (int t = 0; t < fw; ++t, bit += wsum) {
      const int idx = min(bit >> 3, res_len);
      const int u16 = (static_cast<int>(bytes_s[idx]) << 8) | bytes_s[idx + 1];
      const int q = (u16 >> (16 - (bit & 7) - rsw)) & mask;
      const int k = q >> 1;
      float cv = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(k), stepf));
      if (k == kmax) cv = endv;
      if (k == 0) cv = c0;
      const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(sfv, cv), 0.5f)));
      const int32_t dq = (q & 1) ? -dq_abs : dq_abs;

      const uint32_t dot = static_cast<uint32_t>(w0) * static_cast<uint32_t>(h0) +
                           static_cast<uint32_t>(w1) * static_cast<uint32_t>(h1) +
                           static_cast<uint32_t>(w2) * static_cast<uint32_t>(h2) +
                           static_cast<uint32_t>(w3) * static_cast<uint32_t>(h3);
      const int32_t pred = static_cast<int32_t>(dot) >> 13;
      const int32_t recon = min(max(pred + dq, -32768), 32767);
      out_row[static_cast<size_t>(wi * sff + t) * c] = static_cast<int16_t>(recon);
      const uint32_t delta = static_cast<uint32_t>(dq >> 4);
      w0 = static_cast<int32_t>(static_cast<uint32_t>(w0) + (h0 < 0 ? 0u - delta : delta));
      w1 = static_cast<int32_t>(static_cast<uint32_t>(w1) + (h1 < 0 ? 0u - delta : delta));
      w2 = static_cast<int32_t>(static_cast<uint32_t>(w2) + (h2 < 0 ? 0u - delta : delta));
      w3 = static_cast<int32_t>(static_cast<uint32_t>(w3) + (h3 < 0 ? 0u - delta : delta));
      h0 = h1;
      h1 = h2;
      h2 = h3;
      h3 = recon;
    }
    cursor += fw * wsum;
  }
}

}  // namespace

extern "C" int sea_fused_decode_vbr(
    const void* res, const void* sf, const void* rs, const void* hist,
    const void* wts, const void* sfval, const void* curve, const void* kmax,
    void* out, int n, int res_len, int c, int w, int frames, int n_sf, int sff,
    void* stream) {
  const int threads = ((c + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (9 * n_sf + 27 + 9) +
                      static_cast<size_t>(w) * c + res_len + 2;
  cudaFuncSetAttribute(fused_decode_vbr_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  fused_decode_vbr_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const uint8_t*>(rs), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(wts), static_cast<const float*>(sfval),
      static_cast<const float*>(curve), static_cast<const int32_t*>(kmax),
      static_cast<int16_t*>(out), res_len, c, w, frames, n_sf, sff);
  return static_cast<int>(cudaGetLastError());
}
