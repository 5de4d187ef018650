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
// sample steps; candidates and channels are the only parallelism (one block
// per channel, one thread per candidate: a stereo file at sfb 4 keeps two
// warps of the card busy). A lone warp issues in order: measured, it gets
// through about one instruction in three cycles of such code, so a step
// costs its dependent chain or its instruction count, whichever is longer,
// and a window costs whatever sits between two windows on top. The design
// keeps off the chain, and out of the step, whatever need not be there:
//
// - Samples ahead of the chain. A channel's samples are strided by C in the
//   interleaved input, too narrow for cp.async (4 bytes at least), so every
//   thread loads its share of window w+1 into registers at the top of window
//   w (an ordinary load is asynchronous until its register is read), stores
//   them into the other half of a two-window shared-memory buffer at the end
//   of window w, and the window's closing barrier publishes them. The
//   valid-frame count and the per-window size of w+1 ride along the same
//   way. No global load is waited for between two windows, and the wrapper
//   needs no de-interleaving pass (which would cost the per-chunk VBR
//   launches a launch each). Inputs and outputs are addressed by running
//   pointers: no 64-bit multiply per window.
// - The winner's hand-off. The argmin is three warp reductions (redux.sync
//   min over the rank's high word, its low word among the ties, the rotated
//   index among those), after which every lane knows the winner. With
//   S <= 32 the block is one warp: the eight state words come by
//   __shfl_sync from the winning lane and nothing goes through shared
//   memory; a window has two __syncwarp()s (codes visible, samples
//   visible). With S > 32 the warps' minima and the winner's state pass
//   through double-buffered shared memory: two __syncthreads() a window.
//   sf, rank, codes and chunk-entry states are stores nothing waits for.
// - A shorter step. Where it fits shared memory the quantizer and the
//   dequantizer are one lookup: a table [clamped quotient][candidate] of
//   (dq << 8 | code), built on the host from the bit-exact table code
//   (ops/tables.search_table), candidate-minor so the lanes of a warp fall
//   on different banks. Else (large sfb x rs) the zig-zag load and the f32
//   dequant stay (__fmul_rn/__fadd_rn, separate roundings). sea_div is the
//   high word of one 32x32 multiply: the quotient in half steps, which the
//   table is indexed by (a 64-bit product and shift cost a lone warp ~26
//   cycles, measured); its sign fix folds into the clamp's limits. The
//   unrolled loop carries the dot product from step to step so that one
//   multiply-add, not four, follows the reconstruction.
// - The rank off the issue stream. err^2 < 2^32 is one 32x32->64
//   multiply-add. The weights penalty is zero unless sum(w^2) >= 0x900 << 18,
//   so the step keeps only an f32 running maximum of sum(w^2) (exact as a
//   guard: f32 is off by < 1e-6 relative, the threshold sits 1e-4 below the
//   bound); a candidate whose maximum crosses it repeats its window with the
//   exact u64 penalty. Masked (ragged) windows take that exact loop too.
// - The sample loop unrolled for sff == 20, so that one step's rank and
//   weight arithmetic fills the waits of the next step's chain; any other
//   sff runs the run-time loop.
//
// The template parameters select, at compile time, whether a window reads
// its size from rs_in[wi, ch], whether the codes are kept (ranks-only skips
// the code stores; the codes output is not touched), table or arithmetic
// quantizer, and the unrolled loop. Rank, argmin and state math are the same
// in every form. Arithmetic follows the reference's integer widths: sea_div
// in int64, the rank in wrapping u64, the int32 LMS dot and weight updates
// wrapping (computed in uint32). An optional valid-frame count per window,
// shared by every channel or one per (window, channel) (the corpus encode's
// lanes are files x channels, each with its own length), masks ragged and
// padding windows: masked steps add no rank and leave the LMS frozen, while
// their codes are still computed, as in the reference kernels. A fully
// masked window ranks every candidate 0, so the rotated argmin keeps the
// previous winner and the lane's carry passes through unchanged.
//
// With per-window sizes a launch stages only the table rows of the sizes it
// can meet (rs_lo..rs_hi, which the caller knows: VBR assigns base-1..base+2),
// so a block's shared memory stays a few KB and many lanes share an SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFastSff = 20;
constexpr int kPrefetch = 8;  // sample registers a thread keeps ahead (run-time sff)
// sum(w^2) below this (f32, rounded) means the u64 penalty is exactly 0:
// the penalty starts at 0x900 << 18 = 603,979,776
constexpr float kPenaltyGuard = 603900000.0f;

struct Lms {
  uint32_t a0, a1, a2, a3;  // history, oldest first
  uint32_t v0, v1, v2, v3;  // weights
};

// One residual size's constants for one candidate.
template <bool kTable>
struct Size;

template <>
struct Size<true> {
  int32_t recip14;  // reciprocal << 14
  int climit;
  int tab0;  // byte offset of this candidate's entry of a zero half-step quotient
};

template <>
struct Size<false> {
  int32_t recip14;  // reciprocal << 14
  int climit;
  float sfval, c0, stepf, endv;
  int kmax;
  int qt0;  // index of the zig-zag table's entry of a zero quotient
};

__device__ __forceinline__ int32_t predict(const Lms& m) {
  return static_cast<int32_t>(m.v0 * m.a0 + m.v1 * m.a1 + m.v2 * m.a2 + m.v3 * m.a3) >> 13;
}

// sea_div (encoder_base.rs:22-26), clamp, quantize, dequantize. The
// reference's quotient is n = (v*recip + 2^15) >> 16 for the residual v,
// then n + sign(v) - sign(n), clamped to +-climit. A 64-bit product costs a
// lone warp ~26 cycles on the chain, so the kernel takes the half-step
// quotient n2 = floor(v*recip / 2^15) as the high word of one 32x32
// multiply, (8v) * (recip << 14) (|8v| < 2^23, recip <= 2^16: exact), from
// which n = (n2 + 1) >> 1 exactly. The sign fix moves n only when it is 0
// (recip > 0, so n never has the other sign), to +-1 by v's sign; with the
// clamp that is n in 1..climit for v > 0, -climit..-1 for v < 0, 0 for 0:
// in half steps n2 in 1..2*climit, -2*climit..-2, or 0. The table is indexed
// by the clamped n2 and holds the entry of its n.
template <bool kTable>
__device__ __forceinline__ void quantize(const Size<kTable>& z, const int32_t* tab_s,
                                         const uint8_t* qtab_s, int s4, int32_t smp,
                                         int32_t pred, int& q, int32_t& dq) {
  const int32_t v8 = (smp - pred) * 8;
  const int32_t n2 = __mulhi(v8, z.recip14);
  const int32_t lo = v8 > 0 ? 1 : -2 * z.climit;
  const int32_t hi = v8 < 0 ? -2 : 2 * z.climit;
  const int32_t clamped2 = min(max(n2, lo), hi);
  if constexpr (kTable) {
    const int32_t word = *reinterpret_cast<const int32_t*>(
        reinterpret_cast<const unsigned char*>(tab_s) + (z.tab0 + clamped2 * s4));
    q = word & 0xff;
    dq = word >> 8;
  } else {
    q = qtab_s[z.qt0 + ((clamped2 + 1) >> 1)];
    const int k = q >> 1;
    float cv = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(k), z.stepf));
    if (k == z.kmax) cv = z.endv;
    if (k == 0) cv = z.c0;
    const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(z.sfval, cv), 0.5f)));
    dq = (q & 1) ? -dq_abs : dq_abs;
  }
}

__device__ __forceinline__ void lms_update(Lms& m, int32_t dq, int32_t recon) {
  const uint32_t delta = static_cast<uint32_t>(dq >> 4);
  const uint32_t s0 = static_cast<int32_t>(m.a0) >> 31, s1 = static_cast<int32_t>(m.a1) >> 31;
  const uint32_t s2 = static_cast<int32_t>(m.a2) >> 31, s3 = static_cast<int32_t>(m.a3) >> 31;
  m.v0 += (delta ^ s0) - s0;  // sign(h) * delta, wrapping
  m.v1 += (delta ^ s1) - s1;
  m.v2 += (delta ^ s2) - s2;
  m.v3 += (delta ^ s3) - s3;
  m.a0 = m.a1;
  m.a1 = m.a2;
  m.a2 = m.a3;
  m.a3 = static_cast<uint32_t>(recon);
}

__device__ __forceinline__ float weights_sumsq_f32(const Lms& m) {
  const float f0 = static_cast<float>(static_cast<int32_t>(m.v0));
  const float f1 = static_cast<float>(static_cast<int32_t>(m.v1));
  const float f2 = static_cast<float>(static_cast<int32_t>(m.v2));
  const float f3 = static_cast<float>(static_cast<int32_t>(m.v3));
  return fmaf(f3, f3, fmaf(f2, f2, fmaf(f1, f1, f0 * f0)));
}

// weights penalty (lms.rs:53-62), exact
__device__ __forceinline__ unsigned long long weights_penalty(const Lms& m) {
  const long long v0 = static_cast<int32_t>(m.v0), v1 = static_cast<int32_t>(m.v1);
  const long long v2 = static_cast<int32_t>(m.v2), v3 = static_cast<int32_t>(m.v3);
  const unsigned long long sq =
      static_cast<unsigned long long>(v0 * v0) + static_cast<unsigned long long>(v1 * v1) +
      static_cast<unsigned long long>(v2 * v2) + static_cast<unsigned long long>(v3 * v3);
  long long p = (static_cast<long long>(sq) >> 18) - 0x8ff;
  if (p < 0) p = 0;
  return static_cast<unsigned long long>(p) * static_cast<unsigned long long>(p);
}

__device__ __forceinline__ unsigned long long squared(int32_t err) {  // |err| <= 65535
  const uint32_t e = static_cast<uint32_t>(err < 0 ? -err : err);
  return static_cast<unsigned long long>(e) * e;
}

// kMode: 0 arithmetic quantizer, 1 table, 2 table and the unrolled sff == 20
template <bool kVarRs, bool kRanksOnly, int kMode>
__global__ void __launch_bounds__(256) window_search_kernel(
    const int16_t* __restrict__ samples,  // [nw*sff, c] interleaved PCM
    const int32_t* __restrict__ n_valid,  // [nw] or [nw, c] valid frames, or nullptr
    const uint8_t* __restrict__ rs_in,    // [nw, c] sizes (kVarRs only)
    const int32_t* __restrict__ hist_in,  // [c, 4]
    const int32_t* __restrict__ wts_in,   // [c, 4]
    const int32_t* __restrict__ prev_in,  // [c]
    const float* __restrict__ sfval,      // [9, s] scale-factor values by rs
    const int32_t* __restrict__ recip,    // [9, s] reciprocals by rs
    const float* __restrict__ curve,      // [3, 9] c0, stepfloor, endval by rs
    const int32_t* __restrict__ ints,     // [2, 9] kmax, quant-table offset by rs
    const uint8_t* __restrict__ qtab,     // [qtab_len] zig-zag tables of rs 1..8
    const int32_t* __restrict__ tab,      // [tab_rows, s] (dq << 8 | code) by half-step quotient
    uint8_t* __restrict__ sf_out,         // [nw, c]
    uint8_t* __restrict__ codes_out,      // [nw*sff, c] (unused if kRanksOnly)
    unsigned long long* __restrict__ ranks_out,  // [nw, c]
    int32_t* __restrict__ ehist,          // [ceil(nw/wpc), c, 4]
    int32_t* __restrict__ ewts,           // [ceil(nw/wpc), c, 4]
    int32_t* __restrict__ hist_out,       // [c, 4]
    int32_t* __restrict__ wts_out,        // [c, 4]
    int32_t* __restrict__ prev_out,       // [c]
    int c, int s, int sff, int nw, int wpc, int rs_lo, int rs_hi, int nv_stride, int qtab_len,
    int tab_rows) {
  constexpr bool kTable = kMode != 0;
  constexpr bool kFast = kMode == 2;
  constexpr int kPre = kFast ? 1 : kPrefetch;
  const int s4 = 4 * s;  // a table row's bytes
  // layout (see the launcher's sum): the table or the arithmetic constants,
  // reciprocals, two windows of samples, then the [sff, s] code buffer
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tab_s = reinterpret_cast<int32_t*>(smem);
  float* sfval_s = reinterpret_cast<float*>(smem);
  float* curve_s = sfval_s + 9 * s;
  int32_t* ints_s = reinterpret_cast<int32_t*>(curve_s + 27);
  int32_t* recip_s = kTable ? tab_s + tab_rows * s : ints_s + 18;
  int32_t* smp_s = recip_s + 9 * s;  // [2, sff]
  uint8_t* qtab_s = reinterpret_cast<uint8_t*>(smp_s + 2 * sff);
  uint8_t* qbuf = kTable ? qtab_s : qtab_s + qtab_len;  // [sff, s] candidate codes
  // the warps' minima and the winner's state, double-buffered (s > 32 only)
  __shared__ uint32_t warp_key[2][8][3];
  __shared__ uint32_t st_s[2][8];

  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int cand = tid & (s - 1);  // lanes past s shadow a candidate and never win
  const bool active = tid < s;
  const bool one_warp = bd == 32;

  if constexpr (kTable) {
    // 16 bytes a thread where the staged rows start on a 16-byte boundary
    // (all sizes' rows are 128 KB at sfb 4, staged by one warp per launch)
    const int words = tab_rows * s;
    const int vecs = (reinterpret_cast<uintptr_t>(tab) & 15) == 0 ? words / 4 : 0;
    for (int i = tid; i < vecs; i += bd)
      reinterpret_cast<uint4*>(tab_s)[i] = reinterpret_cast<const uint4*>(tab)[i];
    for (int i = 4 * vecs + tid; i < words; i += bd) tab_s[i] = tab[i];
  } else {
    for (int i = tid; i < 9 * s; i += bd) sfval_s[i] = sfval[i];
    for (int i = tid; i < 27; i += bd) curve_s[i] = curve[i];
    for (int i = tid; i < 18; i += bd) ints_s[i] = ints[i];
    for (int i = tid; i < qtab_len; i += bd) qtab_s[i] = qtab[i];
  }
  for (int i = tid; i < 9 * s; i += bd) recip_s[i] = recip[i] << 14;  // <= 2^16 each
  const int16_t* smp_g = samples + ch;
  for (int t = tid; t < sff; t += bd) smp_s[t] = smp_g[static_cast<size_t>(t) * c];
  Lms lms;
  lms.a0 = hist_in[ch * 4]; lms.a1 = hist_in[ch * 4 + 1];
  lms.a2 = hist_in[ch * 4 + 2]; lms.a3 = hist_in[ch * 4 + 3];
  lms.v0 = wts_in[ch * 4]; lms.v1 = wts_in[ch * 4 + 1];
  lms.v2 = wts_in[ch * 4 + 2]; lms.v3 = wts_in[ch * 4 + 3];
  int prev = prev_in[ch];
  __syncthreads();

  // the residual size's constants, in registers for the sample loop; a size
  // outside rs_lo..rs_hi would index past the staged tables
  Size<kTable> z;
  const int row_base = (4 << rs_lo) + rs_lo - 9;  // the first staged size's first row
  auto load_size = [&](int rs_raw) {
    const int rs = min(max(rs_raw, rs_lo), rs_hi);
    z.recip14 = recip_s[rs * s + cand];
    z.climit = 1 << rs;
    if constexpr (kTable) {
      // row of a zero half-step quotient: the size's offset (2^(rs+2) + rs
      // - 9 rows in the table of all sizes) past the first staged row, plus
      // 2*climit
      const int row0 = (4 << rs) + rs - 9 - row_base;
      z.tab0 = 4 * ((row0 + 2 * z.climit) * s + cand);
    } else {
      z.sfval = sfval_s[rs * s + cand];
      z.c0 = curve_s[rs];
      z.stepf = curve_s[9 + rs];
      z.endv = curve_s[18 + rs];
      z.kmax = ints_s[rs];
      z.qt0 = ints_s[9 + rs] + z.climit;
    }
  };
  if (!kVarRs) load_size(rs_lo);

  // each window's inputs and outputs sit a constant stride after the last
  // window's: running pointers, no 64-bit multiply per window
  const size_t win_stride = static_cast<size_t>(sff) * c;
  const int16_t* smp_next = smp_g + win_stride;                    // window wi+1's samples
  uint8_t* codes_w = kRanksOnly ? nullptr : codes_out + ch;        // window wi's codes
  uint8_t* sf_w = sf_out + ch;
  unsigned long long* rank_w = ranks_out + ch;
  // this lane's valid counts: a window's count sits nv_stride after the last's
  const int32_t* nv_w = n_valid == nullptr ? nullptr : n_valid + (nv_stride == 1 ? 0 : ch);
  int nv_next = nv_w ? nv_w[0] : sff;
  int rs_next = kVarRs ? rs_in[ch] : 0;
  int to_chunk = 0;  // windows until the next chunk-entry snapshot
  for (int wi = 0; wi < nw; ++wi) {
    const int slot = wi & 1;
    const int32_t* smp_w = smp_s + slot * sff;
    const int nv = nv_next;
    if (kVarRs) load_size(rs_next);
    // window wi+1's inputs leave for registers now and are read at the end
    const bool more = wi + 1 < nw;
    int16_t pre[kPre];
    if (more) {
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int t = i * bd + tid;
        pre[i] = t < sff ? smp_next[static_cast<size_t>(t) * c] : int16_t(0);
      }
      if (nv_w) {
        nv_w += nv_stride;
        nv_next = *nv_w;
      }
      if (kVarRs) rs_next = rs_in[static_cast<size_t>(wi + 1) * c + ch];
    }
    if (to_chunk == 0) {
      to_chunk = wpc;
      if (tid == 0) {
        const size_t e = (static_cast<size_t>(wi / wpc) * c + ch) * 4;
        ehist[e] = lms.a0; ehist[e + 1] = lms.a1; ehist[e + 2] = lms.a2; ehist[e + 3] = lms.a3;
        ewts[e] = lms.v0; ewts[e + 1] = lms.v1; ewts[e + 2] = lms.v2; ewts[e + 3] = lms.v3;
      }
    }
    --to_chunk;

    Lms m = lms;
    unsigned long long rank = 0;
    uint8_t* qcol = qbuf + cand;
    bool exact = true;  // whether the exact loop has to run
    if constexpr (kFast) {
      if (nv >= kFastSff) {
        // The unrolled loop carries the dot product instead of recomputing
        // it: with e_i = sign(h_i) as +-1 and delta = dq >> 4, the next dot
        // is sum_{i<3} (v_i + e_i*delta)*h_{i+1} + (v_3 + e_3*delta)*recon
        //   = pp + delta*qq + v3'*recon,
        // where pp and qq need neither this step's code nor its sample: one
        // multiply-add follows recon. All of it wraps in uint32 like the
        // reference's int32 (a ring: the regrouping is exact).
        float worst = 0.f;
        uint32_t dot = m.v0 * m.a0 + m.v1 * m.a1 + m.v2 * m.a2 + m.v3 * m.a3;
        auto sign1 = [](uint32_t h) { return static_cast<uint32_t>(static_cast<int32_t>(h) >> 31) | 1u; };
        uint32_t e0 = sign1(m.a0), e1 = sign1(m.a1), e2 = sign1(m.a2), e3 = sign1(m.a3);
#pragma unroll
        for (int t = 0; t < kFastSff; ++t) {
          const int32_t smp_t = smp_w[t];
          const int32_t pred = static_cast<int32_t>(dot) >> 13;
          const uint32_t pp = m.v0 * m.a1 + m.v1 * m.a2 + m.v2 * m.a3;
          const uint32_t qq = e0 * m.a1 + e1 * m.a2 + e2 * m.a3;
          int q;
          int32_t dq;
          quantize<kTable>(z, tab_s, qtab_s, s4, smp_t, pred, q, dq);
          if (!kRanksOnly) qcol[t * s] = static_cast<uint8_t>(q);
          const int32_t recon = min(max(pred + dq, -32768), 32767);
          rank += squared(smp_t - recon);
          worst = fmaxf(worst, weights_sumsq_f32(m));
          const uint32_t delta = static_cast<uint32_t>(dq >> 4);
          m.v0 += e0 * delta;
          m.v1 += e1 * delta;
          m.v2 += e2 * delta;
          m.v3 += e3 * delta;
          dot = (pp + delta * qq) + m.v3 * static_cast<uint32_t>(recon);
          m.a0 = m.a1; m.a1 = m.a2; m.a2 = m.a3; m.a3 = static_cast<uint32_t>(recon);
          e0 = e1; e1 = e2; e2 = e3; e3 = sign1(m.a3);
        }
        exact = worst >= kPenaltyGuard;
        if (exact) {
          m = lms;
          rank = 0;
        }
      }
    }
    if (exact) {
      for (int t = 0; t < sff; ++t) {
        const int32_t smp = smp_w[t];
        const int32_t pred = predict(m);
        int q;
        int32_t dq;
        quantize<kTable>(z, tab_s, qtab_s, s4, smp, pred, q, dq);
        if (!kRanksOnly) qcol[t * s] = static_cast<uint8_t>(q);
        const int32_t recon = min(max(pred + dq, -32768), 32767);
        if (t < nv) {
          rank += squared(smp - recon) + weights_penalty(m);
          lms_update(m, dq, recon);
        }
      }
    }

    // lexicographic argmin over (rank, rotated candidate index): three warp
    // minima, after which every lane of the warp holds the winner's key
    const uint32_t hi = static_cast<uint32_t>(rank >> 32), lo = static_cast<uint32_t>(rank);
    const uint32_t rot = active ? static_cast<uint32_t>((tid - prev) & (s - 1)) : 0x7fffffffu;
    uint32_t best_hi = __reduce_min_sync(kFull, hi);
    uint32_t best_lo = __reduce_min_sync(kFull, hi == best_hi ? lo : 0xffffffffu);
    uint32_t best_rot =
        __reduce_min_sync(kFull, hi == best_hi && lo == best_lo ? rot : 0xffffffffu);
    const int buf = wi & 1;
    if (!one_warp) {
      if ((tid & 31) == 0) {
        warp_key[buf][tid >> 5][0] = best_hi;
        warp_key[buf][tid >> 5][1] = best_lo;
        warp_key[buf][tid >> 5][2] = best_rot;
      }
      __syncthreads();  // also: every warp's codes of this window are stored
      for (int i = 0; i < (bd >> 5); ++i) {
        const uint32_t h2 = warp_key[buf][i][0], l2 = warp_key[buf][i][1], r2 = warp_key[buf][i][2];
        if (h2 < best_hi || (h2 == best_hi && (l2 < best_lo || (l2 == best_lo && r2 < best_rot)))) {
          best_hi = h2;
          best_lo = l2;
          best_rot = r2;
        }
      }
    } else {
      __syncwarp();  // the lanes' codes of this window are stored
    }
    const int best = (static_cast<int>(best_rot) + prev) & (s - 1);
    prev = best;
    if (tid == 0) {
      *sf_w = static_cast<uint8_t>(best);
      *rank_w = (static_cast<unsigned long long>(best_hi) << 32) | best_lo;
    }
    sf_w += c;
    rank_w += c;
    if (!kRanksOnly) {
      if (kFast) {  // one trip: sff == 20 <= the block's threads
        if (tid < kFastSff) codes_w[static_cast<size_t>(tid) * c] = qbuf[tid * s + best];
      } else {
        for (int t = tid; t < sff; t += bd) codes_w[static_cast<size_t>(t) * c] = qbuf[t * s + best];
      }
      codes_w += win_stride;
    }
    // window wi+1's samples into the other half of the buffer
    if (more) {
      int32_t* dst = smp_s + (slot ^ 1) * sff;
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int t = i * bd + tid;
        if (t < sff) dst[t] = pre[i];
      }
      // a window longer than the registers kept ahead: the rest, waited for
      if (!kFast)
        for (int t = kPre * bd + tid; t < sff; t += bd) dst[t] = smp_next[static_cast<size_t>(t) * c];
      smp_next += win_stride;
    }
    // the winner's state to everyone
    if (one_warp) {
      lms.a0 = __shfl_sync(kFull, m.a0, best); lms.a1 = __shfl_sync(kFull, m.a1, best);
      lms.a2 = __shfl_sync(kFull, m.a2, best); lms.a3 = __shfl_sync(kFull, m.a3, best);
      lms.v0 = __shfl_sync(kFull, m.v0, best); lms.v1 = __shfl_sync(kFull, m.v1, best);
      lms.v2 = __shfl_sync(kFull, m.v2, best); lms.v3 = __shfl_sync(kFull, m.v3, best);
      __syncwarp();  // next window's samples stored, this window's codes read
    } else {
      if (tid == best) {
        st_s[buf][0] = m.a0; st_s[buf][1] = m.a1; st_s[buf][2] = m.a2; st_s[buf][3] = m.a3;
        st_s[buf][4] = m.v0; st_s[buf][5] = m.v1; st_s[buf][6] = m.v2; st_s[buf][7] = m.v3;
      }
      __syncthreads();  // state and next samples stored, this window's codes read
      lms.a0 = st_s[buf][0]; lms.a1 = st_s[buf][1]; lms.a2 = st_s[buf][2]; lms.a3 = st_s[buf][3];
      lms.v0 = st_s[buf][4]; lms.v1 = st_s[buf][5]; lms.v2 = st_s[buf][6]; lms.v3 = st_s[buf][7];
    }
  }
  if (tid == 0) {
    hist_out[ch * 4] = lms.a0; hist_out[ch * 4 + 1] = lms.a1;
    hist_out[ch * 4 + 2] = lms.a2; hist_out[ch * 4 + 3] = lms.a3;
    wts_out[ch * 4] = lms.v0; wts_out[ch * 4 + 1] = lms.v1;
    wts_out[ch * 4 + 2] = lms.v2; wts_out[ch * 4 + 3] = lms.v3;
    prev_out[ch] = prev;
  }
}

using KernelFn = decltype(&window_search_kernel<false, false, 0>);

template <int kMode>
KernelFn pick_form(bool var_rs, bool ranks_only) {
  return var_rs ? (ranks_only ? window_search_kernel<true, true, kMode>
                              : window_search_kernel<true, false, kMode>)
                : (ranks_only ? window_search_kernel<false, true, kMode>
                              : window_search_kernel<false, false, kMode>);
}

// The form, block size and dynamic shared memory of a launch, and the error
// of asking for that shared memory.
struct Launch {
  KernelFn kernel;
  int threads;
  size_t smem;
  cudaError_t err;
};

Launch pick_launch(bool var_rs, bool tab, int s, int sff, int ranks_only, int qtab_len, int tab_rows) {
  const KernelFn kernel = !tab              ? pick_form<0>(var_rs, ranks_only)
                          : sff == kFastSff ? pick_form<2>(var_rs, ranks_only)
                                            : pick_form<1>(var_rs, ranks_only);
  // layout: the table [tab_rows, s], or sfval [9, s] + curve [27] + ints [18]
  // and the zig-zag tables; then recip [9, s], two windows of samples (4-byte
  // words), and the [sff, s] code buffer. The kernel's static 256 bytes count
  // against the block's limit as well: the wrapper's check leaves them room.
  const size_t quantizer = tab ? sizeof(int32_t) * tab_rows * s
                               : sizeof(int32_t) * (9 * s + 45) + qtab_len;
  const size_t smem = quantizer + sizeof(int32_t) * (9 * s + 2 * sff) +
                      (ranks_only ? 0 : static_cast<size_t>(sff) * s);
  return Launch{kernel, s < 32 ? 32 : s, smem, sea_launch::allow_smem(kernel, smem)};
}

}  // namespace

// `tab` is the staged table's first row ([tab_rows, s]: the rows of sizes
// rs_lo..rs_hi, one size's for a constant size rs_lo == rs_hi), or null for
// the arithmetic quantizer. `n_valid` is [nw] (nv_stride 1) or [nw, c]
// (nv_stride c).
extern "C" int sea_window_search(
    const void* samples, const void* n_valid, const void* rs_in,
    const void* hist_in, const void* wts_in, const void* prev_in,
    const void* sfval, const void* recip, const void* curve, const void* ints,
    const void* qtab, const void* tab, void* sf_out, void* codes_out,
    void* ranks_out, void* ehist, void* ewts, void* hist_out, void* wts_out,
    void* prev_out, int c, int s, int sff, int nw, int wpc, int rs_lo, int rs_hi,
    int nv_stride, int ranks_only, int qtab_len, int tab_rows, void* stream) {
  const Launch l = pick_launch(rs_in != nullptr, tab != nullptr, s, sff, ranks_only, qtab_len, tab_rows);
  const cudaError_t err = l.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  l.kernel<<<c, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(samples), static_cast<const int32_t*>(n_valid),
      static_cast<const uint8_t*>(rs_in), static_cast<const int32_t*>(hist_in),
      static_cast<const int32_t*>(wts_in), static_cast<const int32_t*>(prev_in),
      static_cast<const float*>(sfval), static_cast<const int32_t*>(recip),
      static_cast<const float*>(curve), static_cast<const int32_t*>(ints),
      static_cast<const uint8_t*>(qtab), static_cast<const int32_t*>(tab),
      static_cast<uint8_t*>(sf_out), static_cast<uint8_t*>(codes_out),
      static_cast<unsigned long long*>(ranks_out), static_cast<int32_t*>(ehist),
      static_cast<int32_t*>(ewts), static_cast<int32_t*>(hist_out),
      static_cast<int32_t*>(wts_out), static_cast<int32_t*>(prev_out), c, s,
      sff, nw, wpc, rs_lo, rs_hi, nv_stride, qtab_len, tab_rows);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the launch these arguments select that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
extern "C" int sea_window_search_blocks_per_sm(int var_rs, int tab, int s, int sff, int ranks_only,
                                               int qtab_len, int tab_rows) {
  const Launch l = pick_launch(var_rs != 0, tab != 0, s, sff, ranks_only, qtab_len, tab_rows);
  if (l.err != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return blocks;
}
