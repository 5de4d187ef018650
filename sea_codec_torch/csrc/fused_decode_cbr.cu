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
// 2 bytes per sample). Every stream is a chain of `frames` dependent steps of
// ~5 instructions, but with one warp per chunk and only C of its 32 lanes
// busy, the in-order issue of each frame's whole instruction stream sets the
// pace first (see PERF.md). Design: one block per chunk, one thread per
// channel stream (chunks and channels are independent: every chunk carries
// its own LMS entry state). The chunk's packed residual bytes (<= 65535 by
// the u16 chunk_size) are staged in shared memory with a cooperative copy,
// so the per-step code fetch is a shared-memory read instead of a global
// load on the chain. The TPU layout (byte-plane transpose, chunk = g*128 +
// lane, VMEM block planning) has no counterpart here.
//
// Rounding: the two f32 steps of the dequant curve and of floor(x*c + 0.5)
// are separate roundings in the table build; __fmul_rn/__fadd_rn keep nvcc
// from contracting them into an FMA. The int32 dot wraps like the reference,
// so it is computed in uint32 and reinterpreted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void fused_decode_cbr_kernel(
    const uint8_t* __restrict__ res,    // [n, res_stride] packed residuals
    const uint8_t* __restrict__ sf,     // [n, w, c] scale-factor codes
    const int32_t* __restrict__ hist,   // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,    // [n, c, 4] LMS entry weights
    const float* __restrict__ sfval,    // [2^sfb] scale-factor values for rs
    int16_t* __restrict__ out,          // [n, frames, c] PCM
    int res_stride, int res_bytes, int c, int w, int frames, int n_sf,
    int rs, int sff, float c0, float stepf, float endv, int kmax) {
  extern __shared__ unsigned char smem[];
  float* sfv_s = reinterpret_cast<float*>(smem);
  uint8_t* bytes_s = smem + sizeof(float) * n_sf;
  const int chunk = blockIdx.x;
  const uint8_t* row = res + static_cast<size_t>(chunk) * res_stride;
  for (int i = threadIdx.x; i < res_bytes; i += blockDim.x) bytes_s[i] = row[i];
  if (threadIdx.x < 2) bytes_s[res_bytes + threadIdx.x] = 0;  // 16-bit window pad
  for (int i = threadIdx.x; i < n_sf; i += blockDim.x) sfv_s[i] = sfval[i];
  __syncthreads();

  const int ch = threadIdx.x;
  if (ch >= c) return;
  const size_t st = (static_cast<size_t>(chunk) * c + ch) * 4;
  int32_t h0 = hist[st], h1 = hist[st + 1], h2 = hist[st + 2], h3 = hist[st + 3];
  int32_t w0 = wts[st], w1 = wts[st + 1], w2 = wts[st + 2], w3 = wts[st + 3];
  const uint8_t* sf_row = sf + static_cast<size_t>(chunk) * w * c + ch;
  int16_t* out_row = out + static_cast<size_t>(chunk) * frames * c + ch;
  const int mask = (1 << rs) - 1;
  float sfv = 0.f;
  for (int f = 0; f < frames; ++f) {
    if (f % sff == 0) sfv = sfv_s[sf_row[(f / sff) * c]];
    const int bit = (f * c + ch) * rs;
    const int idx = bit >> 3;
    const int u16 = (static_cast<int>(bytes_s[idx]) << 8) | bytes_s[idx + 1];
    const int q = (u16 >> (16 - (bit & 7) - rs)) & mask;
    const int k = q >> 1;
    float curve = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(k), stepf));
    if (k == kmax) curve = endv;
    if (k == 0) curve = c0;
    const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(sfv, curve), 0.5f)));
    const int32_t dq = (q & 1) ? -dq_abs : dq_abs;

    const uint32_t dot = static_cast<uint32_t>(w0) * static_cast<uint32_t>(h0) +
                         static_cast<uint32_t>(w1) * static_cast<uint32_t>(h1) +
                         static_cast<uint32_t>(w2) * static_cast<uint32_t>(h2) +
                         static_cast<uint32_t>(w3) * static_cast<uint32_t>(h3);
    const int32_t pred = static_cast<int32_t>(dot) >> 13;
    const int32_t recon = min(max(pred + dq, -32768), 32767);
    out_row[static_cast<size_t>(f) * c] = static_cast<int16_t>(recon);
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
}

}  // namespace

extern "C" int sea_fused_decode_cbr(
    const void* res, const void* sf, const void* hist, const void* wts,
    const void* sfval, void* out, int n, int res_stride, int res_bytes, int c,
    int w, int frames, int n_sf, int rs, int sff, float c0, float stepf,
    float endv, int kmax, void* stream) {
  const int threads = ((c + 31) / 32) * 32;
  const size_t smem = sizeof(float) * n_sf + res_bytes + 2;
  cudaFuncSetAttribute(fused_decode_cbr_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  fused_decode_cbr_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const int32_t*>(hist), static_cast<const int32_t*>(wts),
      static_cast<const float*>(sfval), static_cast<int16_t*>(out), res_stride,
      res_bytes, c, w, frames, n_sf, rs, sff, c0, stepf, endv, kmax);
  return static_cast<int>(cudaGetLastError());
}
