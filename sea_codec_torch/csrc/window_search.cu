// Encoder scale-factor search for Hopper (sm_90a).
//
// Replaces the TPU kernel sea_codec_tpu/ops/pallas_encode.py
// run_window_search (built by _make_kernel), in all the forms the encoder
// calls: a constant residual size (CBR, VBR pass 1), per-(window, channel)
// sizes (VBR pass 2), and ranks-only (VBR pass 1). Reference semantics
// (src/codec/encoder_base.rs): for every window of sff frames, each of the
// S = 2^sfb candidate scale factors runs, per sample,
//   predict -> sea_div -> clamp -> zig-zag quantize -> dequant ->
//   reconstruct -> LMS update,
// accumulating a u64 rank = sum(err^2 + weights_penalty). The winner is the
// lexicographic minimum of (rank, (s - prev_sf) mod S) -- the reference's
// first strict minimum in rotated order from the previous winner -- and
// every candidate of the next window restarts from the winner's LMS state.
//
// What bounds it on this card: the serial chain. Windows depend on the
// previous winner, so a channel is one chain of (windows x sff) dependent
// sample steps; candidates and channels are the only parallelism. Design:
// one block per channel, one thread per candidate (S <= 256), and one launch
// walks all windows of all chunks in order, writing each chunk's entry LMS
// state at its first window. The argmin is a warp-shuffle reduction plus a
// shared-memory pass over the warps; the winner's state and codes pass
// through shared memory (codes as a u8 [sff, S] buffer). The TPU kernel's
// VMEM bounds (c <= 128 or 512 lanes, sfb <= 7) do not apply.
//
// Residual sizes: the constants of all eight sizes (scale-factor values and
// reciprocals [9, S], the four curve constants, the zig-zag table with its
// offsets, ~19 KB at S = 256) are staged in shared memory once per block,
// and each window loads its size's into registers, so the sample loop is
// the same for every form. The template parameters select, at compile time,
// whether a window reads its size from rs_in[wi, ch] (else one constant
// size for the launch) and whether the codes are kept (ranks-only skips the
// [sff, S] code stores and the winner's code writes; the codes output is not
// touched). Rank, argmin and state math are the same in every form.
//
// Arithmetic follows the reference's integer widths: sea_div in int64, the
// rank in wrapping u64, the int32 LMS dot and weight updates wrapping
// (computed in uint32). The dequant f32 steps are separate roundings
// (__fmul_rn/__fadd_rn), as in the table build. An optional per-window
// valid-frame count masks ragged tail windows: masked steps add no rank and
// leave the LMS frozen, while their codes are still computed, as in the
// reference kernels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool key_less(unsigned long long r1, int o1,
                                         unsigned long long r2, int o2) {
  return r1 < r2 || (r1 == r2 && o1 < o2);
}

template <bool kVarRs, bool kRanksOnly>
__global__ void window_search_kernel(
    const int16_t* __restrict__ samples,  // [nw*sff, c] interleaved PCM
    const int32_t* __restrict__ n_valid,  // [nw] valid frames, or nullptr
    const uint8_t* __restrict__ rs_in,    // [nw, c] sizes (kVarRs only)
    const int32_t* __restrict__ hist_in,  // [c, 4]
    const int32_t* __restrict__ wts_in,   // [c, 4]
    const int32_t* __restrict__ prev_in,  // [c]
    const float* __restrict__ sfval,      // [9, s] scale-factor values by rs
    const int32_t* __restrict__ recip,    // [9, s] reciprocals by rs
    const float* __restrict__ curve,      // [3, 9] c0, stepfloor, endval by rs
    const int32_t* __restrict__ ints,     // [2, 9] kmax, quant-table offset by rs
    const uint8_t* __restrict__ qtab,     // [qtab_len] zig-zag tables of rs 1..8
    uint8_t* __restrict__ sf_out,         // [nw, c]
    uint8_t* __restrict__ codes_out,      // [nw*sff, c] (unused if kRanksOnly)
    unsigned long long* __restrict__ ranks_out,  // [nw, c]
    int32_t* __restrict__ ehist,          // [ceil(nw/wpc), c, 4]
    int32_t* __restrict__ ewts,           // [ceil(nw/wpc), c, 4]
    int32_t* __restrict__ hist_out,       // [c, 4]
    int32_t* __restrict__ wts_out,        // [c, 4]
    int32_t* __restrict__ prev_out,       // [c]
    int c, int s, int sff, int nw, int wpc, int rs_const, int qtab_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* smp_s = reinterpret_cast<int32_t*>(smem);
  float* sfval_s = reinterpret_cast<float*>(smp_s + sff);
  int32_t* recip_s = reinterpret_cast<int32_t*>(sfval_s + 9 * s);
  float* curve_s = reinterpret_cast<float*>(recip_s + 9 * s);
  int32_t* ints_s = reinterpret_cast<int32_t*>(curve_s + 27);
  uint8_t* qtab_s = reinterpret_cast<uint8_t*>(ints_s + 18);
  uint8_t* qbuf = qtab_s + qtab_len;  // [sff, s] candidate codes
  __shared__ int32_t st_s[8];
  __shared__ unsigned long long warp_rank[8];
  __shared__ int warp_rot[8];
  __shared__ int best_s;
  __shared__ unsigned long long best_rank_s;

  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool active = tid < s;

  for (int i = tid; i < 9 * s; i += blockDim.x) {
    sfval_s[i] = sfval[i];
    recip_s[i] = recip[i];
  }
  for (int i = tid; i < 27; i += blockDim.x) curve_s[i] = curve[i];
  for (int i = tid; i < 18; i += blockDim.x) ints_s[i] = ints[i];
  for (int i = tid; i < qtab_len; i += blockDim.x) qtab_s[i] = qtab[i];
  int32_t h0 = hist_in[ch * 4], h1 = hist_in[ch * 4 + 1];
  int32_t h2 = hist_in[ch * 4 + 2], h3 = hist_in[ch * 4 + 3];
  int32_t w0 = wts_in[ch * 4], w1 = wts_in[ch * 4 + 1];
  int32_t w2 = wts_in[ch * 4 + 2], w3 = wts_in[ch * 4 + 3];
  int prev = prev_in[ch];
  __syncthreads();

  // the residual size's constants, in registers for the sample loop
  float my_sfval, c0, stepf, endv;
  long long my_recip;
  int climit, kmax;
  const uint8_t* qt;  // zig-zag table entry of a zero residual
  auto load_size = [&](int rs) {
    my_sfval = active ? sfval_s[rs * s + tid] : 0.f;
    my_recip = active ? recip_s[rs * s + tid] : 1;
    climit = 1 << rs;
    c0 = curve_s[rs];
    stepf = curve_s[9 + rs];
    endv = curve_s[18 + rs];
    kmax = ints_s[rs];
    qt = qtab_s + ints_s[9 + rs] + climit;
  };
  if (!kVarRs) load_size(rs_const);

  for (int wi = 0; wi < nw; ++wi) {
    int rs_w = 0;
    if (kVarRs) rs_w = rs_in[static_cast<size_t>(wi) * c + ch];
    for (int t = tid; t < sff; t += blockDim.x)
      smp_s[t] = samples[(static_cast<size_t>(wi) * sff + t) * c + ch];
    if (tid == 0 && wi % wpc == 0) {
      const size_t e = (static_cast<size_t>(wi / wpc) * c + ch) * 4;
      ehist[e] = h0; ehist[e + 1] = h1; ehist[e + 2] = h2; ehist[e + 3] = h3;
      ewts[e] = w0; ewts[e + 1] = w1; ewts[e + 2] = w2; ewts[e + 3] = w3;
    }
    __syncthreads();
    const int nv = n_valid ? n_valid[wi] : sff;
    // a size outside 1..8 would index past the staged tables
    if (kVarRs) load_size(min(max(rs_w, 1), 8));

    int32_t a0 = h0, a1 = h1, a2 = h2, a3 = h3;
    int32_t v0 = w0, v1 = w1, v2 = w2, v3 = w3;
    unsigned long long rank = 0;
    if (active) {
      for (int t = 0; t < sff; ++t) {
        const int32_t smp = smp_s[t];
        const uint32_t dot = static_cast<uint32_t>(v0) * static_cast<uint32_t>(a0) +
                             static_cast<uint32_t>(v1) * static_cast<uint32_t>(a1) +
                             static_cast<uint32_t>(v2) * static_cast<uint32_t>(a2) +
                             static_cast<uint32_t>(v3) * static_cast<uint32_t>(a3);
        const int32_t pred = static_cast<int32_t>(dot) >> 13;
        const int32_t residual = smp - pred;
        // sea_div (encoder_base.rs:22-26): round-half-away fixed point
        const long long n = (static_cast<long long>(residual) * my_recip + (1 << 15)) >> 16;
        const int sv = (residual > 0) - (residual < 0);
        const int sn = (n > 0) - (n < 0);
        const int32_t scaled = static_cast<int32_t>(n + (sv - sn));
        const int32_t clamped = min(max(scaled, -climit), climit);
        const int q = qt[clamped];
        if (!kRanksOnly) qbuf[t * s + tid] = static_cast<uint8_t>(q);
        const int k = q >> 1;
        float cv = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(k), stepf));
        if (k == kmax) cv = endv;
        if (k == 0) cv = c0;
        const int dq_abs =
            static_cast<int>(floorf(__fadd_rn(__fmul_rn(my_sfval, cv), 0.5f)));
        const int32_t dq = (q & 1) ? -dq_abs : dq_abs;
        const int32_t recon = min(max(pred + dq, -32768), 32767);
        if (t < nv) {
          const long long err = smp - recon;
          // weights penalty (lms.rs:53-62) of the weights before the update
          const unsigned long long sq =
              static_cast<unsigned long long>(static_cast<long long>(v0) * v0) +
              static_cast<unsigned long long>(static_cast<long long>(v1) * v1) +
              static_cast<unsigned long long>(static_cast<long long>(v2) * v2) +
              static_cast<unsigned long long>(static_cast<long long>(v3) * v3);
          long long p = (static_cast<long long>(sq) >> 18) - 0x8ff;
          if (p < 0) p = 0;
          rank += static_cast<unsigned long long>(err * err) +
                  static_cast<unsigned long long>(p) * static_cast<unsigned long long>(p);
          const uint32_t delta = static_cast<uint32_t>(dq >> 4);
          v0 = static_cast<int32_t>(static_cast<uint32_t>(v0) + (a0 < 0 ? 0u - delta : delta));
          v1 = static_cast<int32_t>(static_cast<uint32_t>(v1) + (a1 < 0 ? 0u - delta : delta));
          v2 = static_cast<int32_t>(static_cast<uint32_t>(v2) + (a2 < 0 ? 0u - delta : delta));
          v3 = static_cast<int32_t>(static_cast<uint32_t>(v3) + (a3 < 0 ? 0u - delta : delta));
          a0 = a1;
          a1 = a2;
          a2 = a3;
          a3 = recon;
        }
      }
    }

    // lexicographic argmin over (rank, rotated candidate index)
    unsigned long long r = active ? rank : ~0ull;
    int o = active ? ((tid - prev) & (s - 1)) : 0x7fffffff;
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long r2 = __shfl_down_sync(kFull, r, off);
      const int o2 = __shfl_down_sync(kFull, o, off);
      if (key_less(r2, o2, r, o)) {
        r = r2;
        o = o2;
      }
    }
    if (lane == 0) {
      warp_rank[warp] = r;
      warp_rot[warp] = o;
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < nwarps; ++i) {
        if (key_less(warp_rank[i], warp_rot[i], r, o)) {
          r = warp_rank[i];
          o = warp_rot[i];
        }
      }
      best_s = (o + prev) & (s - 1);
      best_rank_s = r;
    }
    __syncthreads();
    const int best = best_s;
    if (tid == best) {
      st_s[0] = a0; st_s[1] = a1; st_s[2] = a2; st_s[3] = a3;
      st_s[4] = v0; st_s[5] = v1; st_s[6] = v2; st_s[7] = v3;
    }
    __syncthreads();
    h0 = st_s[0]; h1 = st_s[1]; h2 = st_s[2]; h3 = st_s[3];
    w0 = st_s[4]; w1 = st_s[5]; w2 = st_s[6]; w3 = st_s[7];
    prev = best;
    if (tid == 0) {
      sf_out[static_cast<size_t>(wi) * c + ch] = static_cast<uint8_t>(best);
      ranks_out[static_cast<size_t>(wi) * c + ch] = best_rank_s;
    }
    if (!kRanksOnly) {
      for (int t = tid; t < sff; t += blockDim.x)
        codes_out[(static_cast<size_t>(wi) * sff + t) * c + ch] = qbuf[t * s + best];
    }
    __syncthreads();
  }
  if (tid == 0) {
    hist_out[ch * 4] = h0; hist_out[ch * 4 + 1] = h1;
    hist_out[ch * 4 + 2] = h2; hist_out[ch * 4 + 3] = h3;
    wts_out[ch * 4] = w0; wts_out[ch * 4 + 1] = w1;
    wts_out[ch * 4 + 2] = w2; wts_out[ch * 4 + 3] = w3;
    prev_out[ch] = prev;
  }
}

using KernelFn = decltype(&window_search_kernel<false, false>);

}  // namespace

extern "C" int sea_window_search(
    const void* samples, const void* n_valid, const void* rs_in,
    const void* hist_in, const void* wts_in, const void* prev_in,
    const void* sfval, const void* recip, const void* curve, const void* ints,
    const void* qtab, void* sf_out, void* codes_out, void* ranks_out,
    void* ehist, void* ewts, void* hist_out, void* wts_out, void* prev_out,
    int c, int s, int sff, int nw, int wpc, int rs_const, int ranks_only,
    int qtab_len, void* stream) {
  const bool var_rs = rs_in != nullptr;
  const KernelFn kernel =
      var_rs ? (ranks_only ? window_search_kernel<true, true> : window_search_kernel<true, false>)
             : (ranks_only ? window_search_kernel<false, true> : window_search_kernel<false, false>);
  const int threads = s < 32 ? 32 : s;
  // layout: samples, sfval, recip, curve, ints (4-byte words), then the
  // zig-zag tables and the [sff, s] code buffer
  const size_t smem = sizeof(int32_t) * (sff + 18 * s + 45) + qtab_len +
                      (ranks_only ? 0 : static_cast<size_t>(sff) * s);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<c, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(samples), static_cast<const int32_t*>(n_valid),
      static_cast<const uint8_t*>(rs_in), static_cast<const int32_t*>(hist_in),
      static_cast<const int32_t*>(wts_in), static_cast<const int32_t*>(prev_in),
      static_cast<const float*>(sfval), static_cast<const int32_t*>(recip),
      static_cast<const float*>(curve), static_cast<const int32_t*>(ints),
      static_cast<const uint8_t*>(qtab), static_cast<uint8_t*>(sf_out),
      static_cast<uint8_t*>(codes_out),
      static_cast<unsigned long long*>(ranks_out), static_cast<int32_t*>(ehist),
      static_cast<int32_t*>(ewts), static_cast<int32_t*>(hist_out),
      static_cast<int32_t*>(wts_out), static_cast<int32_t*>(prev_out), c, s,
      sff, nw, wpc, rs_const, qtab_len);
  return static_cast<int>(cudaGetLastError());
}
