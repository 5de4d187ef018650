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
// then the LMS recurrence (decode_ring.cuh).
//
// What bounds it on this card: not bytes (a chunk reads ~rs/8 byte and writes
// 2 bytes per sample) but, as in the CBR kernel, one stream's chain of
// `frames` dependent LMS steps. Design: the shared recurrence ring of
// decode_ring.cuh (32 / C chunks a block, recurrence warps that walk only the
// chain); only the producer differs from the CBR kernel's. For each tile the
// producer warps first build, in shared memory, the addressing of the windows
// the tile touches, per chunk of the block: a warp per chunk reads the
// windows' sizes and scale factors (contiguous in device memory), scans the
// sizes across channels (a segmented warp scan over the [windows, C] entries)
// for each entry's prefix and each window's wsum, then scans fiw * wsum across
// windows for their first bits, starting from the chunk's bit cursor, which
// it carries from tile to tile. An entry holds (prefix | size << 16, the scale
// factor's value), a window (start bit, wsum). Then each producer thread
// takes groups of four consecutive samples of a chunk: their codes follow
// each other in the bit stream, so it computes the group's first bit from
// the tables, reads the <= 39 bits from there once, straight from device
// memory, walks them with each sample's size, dequantizes with the size's
// curve constants and stores the four values into the dq ring. No packed row is staged, so a row of any length
// decodes; the tables fit shared memory for every sfb 1..8, sff 1..255 and
// C 1..255 (ops/fused_decode_vbr.py sizes them as the launcher does). The
// TPU's MXU one-hot word fetch, group/lane layout and VMEM gates have no
// counterpart.
//
// Malformed input: sizes are clamped to 1..8 and scale factors masked to
// 2^sfb as they are read, and bytes at or past the row's end read as zero,
// so no read leaves the row; the plain version (decode_vbr_plain) cleans the
// tables the same way and pads the row with zeros.
//
// Rounding: the two f32 steps of the dequant curve and of floor(x*c + 0.5)
// are separate roundings in the table build; __fmul_rn/__fadd_rn keep nvcc
// from contracting them into an FMA.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_ring.cuh"

namespace {

using namespace decode_ring;

constexpr unsigned kFull = 0xFFFFFFFFu;

// these producers set the kernel's pace: it keeps all fifteen producer warps
// rather than leave the recurrence warp's scheduler to it (decode_ring.cuh)
constexpr bool kIsolate = false;

// Inclusive scan of v over the warp's lanes, each lane summing only the
// lanes at most `span` below it: a segmented scan whose segment starts
// `span` lanes down.
__device__ __forceinline__ int warp_scan(int v, int lane, int span) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (span >= off) v += u;
  }
  return v;
}

struct VbrProducer {
  const Ring& r;
  const uint8_t* __restrict__ res;
  const uint8_t* __restrict__ sf;
  const uint8_t* __restrict__ rs;
  const float* sfv_s;    // [9, n_sf] scale-factor values by size
  const float4* curve_s; // [9] (c0, stepfloor, endval, kmax as int bits) by size
  int2* rows_s;          // [group, nwmax] (first bit, bits per frame) of a window
  int2* ents_s;          // [group, nwmax, c] (prefix | size << 16, sf value bits)
  int* cursor_s;         // [group] first bit of the tile's first window
  int res_len, w, n_sf, sff, nwmax;
  FastDiv div_c, div_sff;
  // this tile's frames and its first frame's place in its window, set by prepare()
  int nf, off;

  __device__ void prepare(int i) {
    const int c = r.c;
    const int lane = r.ptid & 31, pwarp = r.ptid >> 5, pwarps = r.prod_threads >> 5;
    if (i > 0) producer_sync(r.prod_threads);  // every sample of tile i-1 is in its slot
    const int f0 = i * r.tile;
    nf = min(r.tile, r.frames - f0);
    const int wa = f0 / sff;  // the tile's windows wa .. wa + nw - 1
    const int nw = (f0 + nf - 1) / sff - wa + 1;
    off = f0 - wa * sff;
    const int n_e = nw * c;
    for (int k = pwarp; k < r.chunks; k += pwarps) {
      const size_t tab = (static_cast<size_t>(r.chunk0 + k) * w + wa) * c;
      int2* ents = ents_s + k * nwmax * c;
      int2* rows = rows_s + k * nwmax;
      // sizes and scale factors -> entries; the sizes' scan per window
      int carry = 0;
      for (int base = 0; base < n_e; base += 32) {
        const int e = base + lane;
        const int wl = div_c(e), ch = e - wl * c;
        const bool valid = e < n_e;
        const int size = valid ? min(max(static_cast<int>(rs[tab + e]), 1), 8) : 0;
        const int code = valid ? sf[tab + e] & (n_sf - 1) : 0;
        int incl = warp_scan(size, lane, min(lane, ch));
        if (ch > lane) incl += carry;  // the window's row began in an earlier pass
        if (valid) {
          const float v = sfv_s[size * n_sf + code];
          ents[e] = make_int2((incl - size) | (size << 16), __float_as_int(v));
          if (ch == c - 1) rows[wl].y = incl;
        }
        carry = __shfl_sync(kFull, incl, 31);
      }
      __syncwarp();
      // the windows' first bits: the cursor plus the scan of fiw * wsum
      int run = cursor_s[k];
      for (int base = 0; base < nw; base += 32) {
        const int wl = base + lane;
        const int v = wl < nw ? min(sff, r.frames - (wa + wl) * sff) * rows[wl].y : 0;
        const int incl = warp_scan(v, lane, lane);
        if (wl < nw) rows[wl].x = run + incl - v;
        run += __shfl_sync(kFull, incl, 31);
      }
      __syncwarp();
      // the next tile starts in this tile's last window or in the one after
      if (lane == 0) cursor_s[k] = (f0 + r.tile) / sff - wa == nw ? run : rows[nw - 1].x;
      __syncwarp();
    }
    producer_sync(r.prod_threads);  // the tables are complete
  }

  // A group is four consecutive samples of a chunk: their codes follow each
  // other in the bit stream (in frame-major order every code starts where
  // the last one ended, across windows too), so a group reads its <= 39
  // bits once and walks them, each code's size and scale factor from its
  // entry. kGroups groups a thread at a time, all their byte loads issued
  // before any store.
  __device__ void fill(int, int16_t* slot) {
    constexpr int kGroups = 2;
    const int c = r.c;
    const int nsamp = nf * c;
    const int groups = (nsamp + 3) / 4, total = r.chunks * groups;
    const FastDiv div_g(groups);
    for (int base = r.ptid; base < total; base += kGroups * r.prod_threads) {
      unsigned long long buf[kGroups];
      int k[kGroups], j0[kGroups], ch[kGroups], wl[kGroups], t[kGroups], pos[kGroups];
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int idx = min(base + u * r.prod_threads, total - 1);  // past the end: the last again, not stored
        k[u] = div_g(idx);
        j0[u] = 4 * (idx - k[u] * groups);
        const int fl = div_c(j0[u]);
        ch[u] = j0[u] - fl * c;
        const int x = fl + off;
        wl[u] = div_sff(x);
        t[u] = x - wl[u] * sff;
        const int2 row = rows_s[k[u] * nwmax + wl[u]];
        const int bit = row.x + t[u] * row.y + (ents_s[(k[u] * nwmax + wl[u]) * c + ch[u]].x & 0xFFFF);
        pos[u] = bit & 7;
        const uint8_t* src = res + static_cast<size_t>(r.chunk0 + k[u]) * res_len + (bit >> 3);
        const int room = res_len - (bit >> 3);  // bytes at or past the row's end read as zero
        buf[u] = 0;
#pragma unroll
        for (int b = 0; b < 5; ++b)
          buf[u] |= static_cast<unsigned long long>(b < room ? src[b] : 0) << (56 - 8 * b);
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        if (base + u * r.prod_threads >= total) break;
        __align__(8) int16_t vals[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (j0[u] + v >= nsamp) break;
          const int2 ent = ents_s[(k[u] * nwmax + wl[u]) * c + ch[u]];
          const int size = ent.x >> 16;
          const int q = static_cast<int>(buf[u] >> (64 - pos[u] - size)) & ((1 << size) - 1);
          pos[u] += size;
          const float4 cv = curve_s[size];
          const int kq = q >> 1;
          float curve = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(kq), cv.y));
          if (kq == __float_as_int(cv.w)) curve = cv.z;
          if (kq == 0) curve = cv.x;
          const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(__int_as_float(ent.y), curve), 0.5f)));
          vals[v] = static_cast<int16_t>((q & 1) ? -dq_abs : dq_abs);
          if (++ch[u] == c) {
            ch[u] = 0;
            if (++t[u] == sff) {
              t[u] = 0;
              ++wl[u];
            }
          }
        }
        int16_t* dst = slot + k[u] * r.sub + j0[u];
        if (j0[u] + 4 <= nsamp) {
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(vals);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (j0[u] + v < nsamp) dst[v] = vals[v];
        }
      }
    }
  }
};

__global__ void __launch_bounds__(kMaxWarps * 32) fused_decode_vbr_kernel(
    const uint8_t* __restrict__ res,    // [n, res_len] packed residuals
    const uint8_t* __restrict__ sf,     // [n, w, c] scale-factor codes
    const uint8_t* __restrict__ rs,     // [n, w, c] residual sizes 1..8
    const int32_t* __restrict__ hist,   // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,    // [n, c, 4] LMS entry weights
    const float* __restrict__ sfval,    // [9, n_sf] scale-factor values by rs
    const float* __restrict__ curve,    // [3, 9] c0, stepfloor, endval by rs
    const int32_t* __restrict__ kmax,   // [9] kmax by rs
    int16_t* __restrict__ out,          // [n, frames, c] PCM
    int n, int res_len, int c, int w, int frames, int n_sf, int sff, int tile,
    int group, int rec_warps, int nwmax) {
  // the rings (dq in the PCM ring's layout), then the curve constants, the
  // scale-factor values, the windows, the entries and the cursors
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const Ring r = make_ring(smem, n, c, frames, tile, group, group * (tile * c + kPad), rec_warps, kIsolate,
                         &rest);
  float4* curve_s = reinterpret_cast<float4*>(rest);
  float* sfv_s = reinterpret_cast<float*>(curve_s + 9);
  int2* rows_s = reinterpret_cast<int2*>(sfv_s + 9 * n_sf);
  int2* ents_s = rows_s + group * nwmax;
  int* cursor_s = reinterpret_cast<int*>(ents_s + group * nwmax * c);
  for (int i = threadIdx.x; i < 9 * n_sf; i += blockDim.x) sfv_s[i] = sfval[i];
  if (threadIdx.x < 9) {
    const int i = threadIdx.x;
    curve_s[i] = make_float4(curve[i], curve[9 + i], curve[18 + i], __int_as_float(kmax[i]));
  }
  if (threadIdx.x < group) cursor_s[threadIdx.x] = 0;
  __syncthreads();
  if (r.ptid >= 0) {
    VbrProducer p{r, res, sf, rs, sfv_s, curve_s, rows_s, ents_s, cursor_s, res_len, w, n_sf, sff,
                  nwmax, FastDiv(c), FastDiv(sff), 0, 0};
    produce(r, out, p);
  } else if (threadIdx.x < r.rec_threads) {
    recurrence(r, hist, wts, r.sub, c);
  }
}

}  // namespace

// `tile` (frames per tile, a multiple of 32), `group` (chunks per block) and
// `nwmax` (windows a tile can touch) come from the wrapper, which sizes the
// shared memory by them too.
extern "C" int sea_fused_decode_vbr(
    const void* res, const void* sf, const void* rs, const void* hist,
    const void* wts, const void* sfval, const void* curve, const void* kmax,
    void* out, int n, int res_len, int c, int w, int frames, int n_sf, int sff,
    int tile, int group, int nwmax, void* stream) {
  const int rec_warps = (group * c + 31) / 32;
  const int threads = 32 * block_warps(rec_warps, producer_warps(group * c, rec_warps, kIsolate), kIsolate);
  const size_t ring = kBarrierBytes + 2 * kSlots * static_cast<size_t>(group) * (tile * c + kPad) * sizeof(int16_t);
  const size_t smem = ring + sizeof(float4) * 9 + sizeof(float) * 9 * n_sf +
                      sizeof(int2) * static_cast<size_t>(group) * nwmax * (1 + c) + sizeof(int) * group;
  cudaFuncSetAttribute(fused_decode_vbr_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int blocks = (n + group - 1) / group;
  fused_decode_vbr_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const uint8_t*>(rs), static_cast<const int32_t*>(hist),
      static_cast<const int32_t*>(wts), static_cast<const float*>(sfval),
      static_cast<const float*>(curve), static_cast<const int32_t*>(kmax),
      static_cast<int16_t*>(out), n, res_len, c, w, frames, n_sf, sff, tile, group,
      rec_warps, nwmax);
  return static_cast<int>(cudaGetLastError());
}
