// VBR full-chunk row serializer for Hopper (sm_90a): a slab's lane-packed
// VBR search outputs -> finished container rows, on the card.
//
// Replaces no TPU kernel: the JAX package packs VBR rows on the host
// (sea_codec_tpu/batch.py serialize_full_chunks, through its native
// packer), and so did the port before this kernel, after downloading the
// search's codes (~3.5x the bytes of the finished rows) and while the card
// idled. The host function stays (batch.serialize_full_chunks) and the
// tests hold this kernel's plain version to it.
//
// The row, as serialize_full_chunks makes it (src/codec/chunk.rs:215-278):
// the 4-byte header [type 2, sfb << 4 | residual_size, sff, 0x5A]; per
// channel the LMS history then weights, i16 LE (int32 cut to its low 16
// bits); the W x C scale factors at sfb bits; the W x C relative sizes
// (size - residual_size + 1) at 2 bits; the fpc x C residuals, frame-major
// and channel-minor, each at its window's size for its channel. Each
// section starts on a byte and is packed MSB-first, its last partial byte
// left-aligned. Every full chunk has the same section lengths (the sizes'
// counts are fixed per full chunk); only where a residual lands inside its
// section depends on the data. With S the exclusive prefix sum of the
// sizes over the chunk's (window, channel) items, window-major,
//   bit(frame f, channel ch) = sff * S[w, 0] + t * (S[w + 1, 0] - S[w, 0])
//                              + S[w, ch] - S[w, 0],   w = f / sff, t = f % sff,
// so one block scan of the sizes addresses every code: no per-code width
// array exists.
//
// What bounds it on this card: bytes, ~0.4 GB a library call of codes read
// and rows written (0.12 ms at 3.35 TB/s); its operations are a few dozen
// integer instructions a code. A block reads only its file's C bytes of
// each frame's lane row, so the 32-byte sectors of a frame are shared by
// the blocks of one chunk index: blocks are ordered chunk-major and
// file-minor, so that the files of a chunk run together and those sectors
// come from L2, not from device memory, once each.
//
// Design: one block per (file, chunk) row, assembled in dynamic shared
// memory (a row is at most 65,535 bytes, the header's u16 chunk_size, so
// it fits for every legal configuration) and stored once, coalesced, in
// aligned 32-bit words. The header and LMS words are plain stores (the
// sections after them start on a word); every packed section is ORed into
// shared memory by runs: a thread packs several consecutive items (<= 32
// bits, contiguous in the stream) in a register and ORs them into the <= 2
// words they touch, atomically, since neighbouring runs share words. The
// residuals go a tile of windows at a time (at most kTileItems items), so
// that the scan's table fits beside the row for 1..255 channels. Memory
// safety on malformed input: sizes clamp to 1..8 for the residual widths,
// values mask to their width, and no bit lands past the row.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileItems = 4096;  // (window, channel) items of a residual tile
constexpr int kRun = 4;           // residual codes a thread packs into one run
constexpr uint32_t kChunkTypeVbr = 2;

// ORs `nbits` (<= 32) bits, right-aligned in `v` and MSB first, into the
// row at stream bit `bit`. The row's words hold its bytes in stream order.
__device__ __forceinline__ void put_bits(uint32_t* row, uint32_t nwords, uint32_t bit, uint32_t v, int nbits) {
  if (nbits == 0) return;
  const uint32_t q = bit >> 5;
  const unsigned long long x = static_cast<unsigned long long>(v) << (64 - nbits - static_cast<int>(bit & 31));
  const uint32_t hi = static_cast<uint32_t>(x >> 32), lo = static_cast<uint32_t>(x);
  // a stream word's first byte is its most significant: byte-swap into the
  // little-endian word
  if (hi != 0 && q < nwords) atomicOr(row + q, __byte_perm(hi, 0, 0x0123));
  if (lo != 0 && q + 1 < nwords) atomicOr(row + q + 1, __byte_perm(lo, 0, 0x0123));
}

// Item i of a chunk's (window, channel) table, window-major, from the
// lane-packed array whose window rows are `b` lanes apart.
__device__ __forceinline__ uint32_t item(const uint8_t* t, int b, int c, int i) {
  const int w = i / c;
  return t[static_cast<size_t>(w) * b + (i - w * c)];
}

// Packs `n` items of a constant `width` (item i = value(i)) from stream
// bit `base`, 32 / width items a run.
template <typename Value>
__device__ __forceinline__ void pack_fixed(uint32_t* row, uint32_t nwords, uint32_t base, int n, int width,
                                           Value value) {
  const int per = 32 / width;
  const int runs = (n + per - 1) / per;
  const uint32_t mask = (1u << width) - 1u;
  for (int r = threadIdx.x; r < runs; r += blockDim.x) {
    const int i0 = r * per, i1 = min(i0 + per, n);
    uint32_t v = 0;
    for (int i = i0; i < i1; ++i) v = (v << width) | (value(i) & mask);
    put_bits(row, nwords, base + static_cast<uint32_t>(i0) * width, v, (i1 - i0) * width);
  }
}

// s[i] = the tile's sizes (clamped to 1..8) summed over its items before i,
// window-major; s[n] = their total. `sz` is the tile's first window row.
__device__ void scan_sizes(const uint8_t* sz, int b, int c, int n, int* s, int* warp_sums) {
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(static_cast<int>(threadIdx.x) * per, n), i1 = min(i0 + per, n);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += min(max(static_cast<int>(item(sz, b, c, i)), 1), 8);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;  // inclusive scan of the threads' sums, within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kWarps) warp_sums[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    s[i] = run;
    run += min(max(static_cast<int>(item(sz, b, c, i)), 1), 8);
  }
  if (threadIdx.x == kThreads - 1) s[n] = warp_sums[kWarps - 1];
}

__global__ void __launch_bounds__(kThreads) serialize_vbr_kernel(
    const uint8_t* __restrict__ sf,      // [nc, w, b] scale factors
    const uint8_t* __restrict__ codes,   // [nc, w * sff, b] residual codes
    const uint8_t* __restrict__ sizes,   // [nc, w, b] residual sizes
    const int32_t* __restrict__ ehist,   // [nc, b, 4] each chunk's entry LMS history
    const int32_t* __restrict__ ewts,    // [nc, b, 4] and weights
    uint8_t* __restrict__ rows,          // [n_files, nc, chunk_size]
    int nc, int n_files, int c, int w, int sff, int sfb, int residual_size, int chunk_size,
    int tile_w) {
  extern __shared__ __align__(16) uint32_t row[];  // the row's words, then the tile's scan
  __shared__ int warp_sums[kWarps];
  const int k = blockIdx.x / n_files, j = blockIdx.x - k * n_files;
  const int b = n_files * c, lane0 = j * c, fpc = w * sff;
  const uint32_t nwords = static_cast<uint32_t>((chunk_size + 3) / 4 + 1);
  int* scan = reinterpret_cast<int*>(row + nwords);
  for (uint32_t i = threadIdx.x; i < nwords; i += kThreads) row[i] = 0;
  __syncthreads();

  // the header and the LMS state: whole words, which no section below touches
  if (threadIdx.x == 0)
    row[0] = kChunkTypeVbr | ((static_cast<uint32_t>(sfb << 4 | residual_size) & 0xFFu) << 8) |
             ((static_cast<uint32_t>(sff) & 0xFFu) << 16) | (0x5Au << 24);
  for (int i = threadIdx.x; i < 4 * c; i += kThreads) {
    const int ch = i >> 2, q = i & 3;  // values 2q, 2q + 1 of (history[4], weights[4])
    const int32_t* v = (q < 2 ? ehist : ewts) + (static_cast<size_t>(k) * b + lane0 + ch) * 4 + (q & 1) * 2;
    row[1 + i] = (static_cast<uint32_t>(v[0]) & 0xFFFFu) | (static_cast<uint32_t>(v[1]) << 16);
  }

  const int items = w * c;
  const uint8_t* sf_k = sf + static_cast<size_t>(k) * w * b + lane0;
  const uint8_t* sz_k = sizes + static_cast<size_t>(k) * w * b + lane0;
  const uint32_t sf_bit = 8u * (4 + 16 * c);
  const uint32_t rel_bit = sf_bit + 8u * ((items * sfb + 7) / 8);
  const uint32_t res_bit = rel_bit + 8u * ((items * 2 + 7) / 8);
  pack_fixed(row, nwords, sf_bit, items, sfb, [&](int i) { return item(sf_k, b, c, i); });
  pack_fixed(row, nwords, rel_bit, items, 2,
             [&](int i) { return item(sz_k, b, c, i) - static_cast<uint32_t>(residual_size) + 1u; });

  // the residuals, a tile of windows at a time
  int before = 0;  // sizes summed over the tiles before
  for (int w0 = 0; w0 < w; w0 += tile_w) {
    const int tw = min(tile_w, w - w0), n = tw * c;
    scan_sizes(sz_k + static_cast<size_t>(w0) * b, b, c, n, scan, warp_sums);
    __syncthreads();
    const uint32_t base = res_bit + static_cast<uint32_t>(sff) * static_cast<uint32_t>(before);
    const uint8_t* cd = codes + (static_cast<size_t>(k) * fpc + static_cast<size_t>(w0) * sff) * b + lane0;
    const int ncodes = tw * sff * c;
    for (int r = threadIdx.x * kRun; r < ncodes; r += kThreads * kRun) {
      int f = r / c, ch = r - f * c;  // frame in the tile, channel
      int wl = f / sff, t = f - wl * sff;
      const int* s = scan + wl * c;
      const uint32_t bit = base + static_cast<uint32_t>(sff * s[0] + t * (s[c] - s[0]) + s[ch] - s[0]);
      const int r1 = min(r + kRun, ncodes);
      uint32_t v = 0;
      int nbits = 0;
      for (int i = r; i < r1; ++i) {
        const int at = wl * c + ch;
        const int width = scan[at + 1] - scan[at];
        v = (v << width) | (static_cast<uint32_t>(cd[static_cast<size_t>(f) * b + ch]) & ((1u << width) - 1u));
        nbits += width;
        if (++ch == c) {
          ch = 0;
          ++f;
          if (++t == sff) {
            t = 0;
            ++wl;
          }
        }
      }
      put_bits(row, nwords, bit, v, nbits);
    }
    before += scan[n];
    __syncthreads();  // the next tile rewrites the scan
  }

  // the row out: a few bytes up to an aligned address, then aligned words
  // funnel-shifted out of the shared row, then the last bytes
  uint8_t* dst = rows + (static_cast<size_t>(j) * nc + k) * chunk_size;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(row);
  const int head = min(static_cast<int>((4 - (reinterpret_cast<uintptr_t>(dst) & 3)) & 3), chunk_size);
  const int mid = (chunk_size - head) >> 2;
  if (static_cast<int>(threadIdx.x) < head) dst[threadIdx.x] = bytes[threadIdx.x];
  uint32_t* dst_w = reinterpret_cast<uint32_t*>(dst + head);
  for (int m = threadIdx.x; m < mid; m += kThreads) {
    const int s = head + 4 * m;
    dst_w[m] = __funnelshift_r(row[s >> 2], row[(s >> 2) + 1], (s & 3) * 8);
  }
  for (int i = head + 4 * mid + threadIdx.x; i < chunk_size; i += kThreads) dst[i] = bytes[i];
}

}  // namespace

// rows [n_files, nc, chunk_size] from the lane-packed outputs of nc chunks
// of n_files files of c channels (lane = file * c + channel), w windows of
// sff frames a chunk. chunk_size <= 65535 (the wrapper checks it).
extern "C" int sea_serialize_vbr(const void* sf, const void* codes, const void* sizes, const void* ehist,
                                 const void* ewts, void* rows, int nc, int n_files, int c, int w, int sff,
                                 int sfb, int residual_size, int chunk_size, void* stream) {
  if (nc == 0 || n_files == 0) return 0;
  const int tile_w = std::max(1, std::min(w, kTileItems / c));
  const size_t nwords = static_cast<size_t>((chunk_size + 3) / 4 + 1);
  const size_t smem = (nwords + static_cast<size_t>(tile_w) * c + 1) * sizeof(uint32_t);
  const cudaError_t err = sea_launch::allow_smem(serialize_vbr_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>(nc) * static_cast<unsigned int>(n_files);
  serialize_vbr_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sf), static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(sizes),
      static_cast<const int32_t*>(ehist), static_cast<const int32_t*>(ewts), static_cast<uint8_t*>(rows), nc,
      n_files, c, w, sff, sfb, residual_size, chunk_size, tile_w);
  return static_cast<int>(cudaGetLastError());
}
