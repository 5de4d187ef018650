// Standalone LMS recurrence for Hopper (sm_90a): dq stream -> int16 PCM.
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_decode.py:92
// lms_decode_lanes (body _decode_kernel; its interpret-mode twin at :192).
// The second half of the two-kernel decode: the dequantized residuals were
// written by a dequant kernel (dequant_cbr.cu, dequant_vbr.cu) or by plain
// tensor code, and every stream (chunk, channel) walks them in time order,
// as in the reference decoder (src/codec/decoder.rs):
//   pred  = (sum w_i*h_i) >> 13 (wrapping int32), recon = clamp_i16(pred+dq)
//   w_i  += h_i < 0 ? -(dq >> 4) : dq >> 4 (arithmetic shift; wrapping add),
//   history shifts in recon.
//
// What bounds it on this card: the dependent chain of one stream (`frames`
// steps of ~5 instructions), not bytes (2 bytes read and 2 written per
// sample). Design: one thread per stream with its eight state words in
// registers. The dq stream is time-major [frames, streams], so a warp's 32
// loads of one frame are one coalesced 64-byte read, and all 32 lanes work
// (the fused kernels keep one warp per chunk and use C lanes of it). A load
// from device memory costs many chain steps, so each thread fetches a batch
// of LMS_BATCH frames into registers one batch ahead of the one it walks:
// the loads of the next batch are in flight during the chain of this one.
// The TPU's layout ([T, R, 128] tiles, time blocks with the state parked in
// VMEM between them, lane padding) has no counterpart: any streams >= 1 and
// frames >= 1, no padding.
//
// Output layout: PCM goes straight to [chunks, frames, channels], the layout
// every caller wants, as the fused kernels write it: a thread's store of one
// frame is 2 bytes at stride `channels`, and a warp's stores of one frame
// touch 32/channels chunks. The alternative (time-major stores and a
// transpose pass) would move every sample twice more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LMS_BATCH = 32;

__global__ void lms_decode_kernel(
    const int16_t* __restrict__ dq,    // [frames, streams] dequantized residuals
    const int32_t* __restrict__ hist,  // [streams, 4] LMS entry history
    const int32_t* __restrict__ wts,   // [streams, 4] LMS entry weights
    int16_t* __restrict__ out,         // [chunks, frames, c] PCM
    int streams, int frames, int c) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= streams) return;
  const size_t st = static_cast<size_t>(s) * 4;
  int32_t h0 = hist[st], h1 = hist[st + 1], h2 = hist[st + 2], h3 = hist[st + 3];
  int32_t w0 = wts[st], w1 = wts[st + 1], w2 = wts[st + 2], w3 = wts[st + 3];
  const int chunk = s / c, ch = s - chunk * c;
  const int16_t* in = dq + s;
  int16_t* out_row = out + static_cast<size_t>(chunk) * frames * c + ch;

  int16_t cur[LMS_BATCH], nxt[LMS_BATCH];
#pragma unroll
  for (int u = 0; u < LMS_BATCH; ++u)
    cur[u] = u < frames ? in[static_cast<size_t>(u) * streams] : int16_t(0);
  for (int f0 = 0; f0 < frames; f0 += LMS_BATCH) {
#pragma unroll
    for (int u = 0; u < LMS_BATCH; ++u) {
      const int f = f0 + LMS_BATCH + u;
      nxt[u] = f < frames ? in[static_cast<size_t>(f) * streams] : int16_t(0);
    }
#pragma unroll
    for (int u = 0; u < LMS_BATCH; ++u) {
      const int f = f0 + u;
      if (f < frames) {
        const int32_t d = cur[u];
        const uint32_t dot = static_cast<uint32_t>(w0) * static_cast<uint32_t>(h0) +
                             static_cast<uint32_t>(w1) * static_cast<uint32_t>(h1) +
                             static_cast<uint32_t>(w2) * static_cast<uint32_t>(h2) +
                             static_cast<uint32_t>(w3) * static_cast<uint32_t>(h3);
        const int32_t pred = static_cast<int32_t>(dot) >> 13;
        const int32_t recon = min(max(pred + d, -32768), 32767);
        out_row[static_cast<size_t>(f) * c] = static_cast<int16_t>(recon);
        const uint32_t delta = static_cast<uint32_t>(d >> 4);
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
#pragma unroll
    for (int u = 0; u < LMS_BATCH; ++u) cur[u] = nxt[u];
  }
}

}  // namespace

extern "C" int sea_lms_decode(
    const void* dq, const void* hist, const void* wts, void* out, int streams,
    int frames, int c, void* stream) {
  // one warp per block spreads few streams over the SMs (a stereo file's
  // 3,100 streams are 97 warps for 132 SMs); wide batches take larger blocks
  const int threads = streams <= 132 * 32 * 16 ? 32 : 128;
  const int blocks = (streams + threads - 1) / threads;
  lms_decode_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(dq), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(wts), static_cast<int16_t*>(out), streams,
      frames, c);
  return static_cast<int>(cudaGetLastError());
}
