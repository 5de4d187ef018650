// The recurrence ring shared by the three decode kernels for Hopper (sm_90a):
// fused_decode_cbr.cu, fused_decode_vbr.cu and lms_decode.cu.
//
// Every decode ends in the LMS recurrence, per (chunk, channel) stream, as in
// the reference decoder (src/codec/decoder.rs):
//   pred  = (sum w_i*h_i) >> 13 (wrapping int32), recon = clamp_i16(pred+dq)
//   w_i  += h_i < 0 ? -(dq >> 4) : dq >> 4 (wrapping), history shifts in recon.
// A stream is a chain of `frames` dependent steps and a chunk holds only C
// streams, so what bounds these kernels is the chain, walked by a thread that
// issues in order: whatever else that thread has to issue lengthens every
// step. The kernels differ only in how the dq values are made (unpack and
// dequantize CBR or VBR codes, or copy a dq stream), so the rest lives here:
//   - a block decodes `group` = 32 / C chunks (one from 17 channels on), so
//     that its (chunk, channel) streams fill one warp;
//   - recurrence warps, one thread per stream, read dq from a shared-memory
//     ring kBatch frames at a time into registers, walk only the chain and
//     the weight step, and write PCM into a shared-memory ring;
//   - producer warps fill the dq ring a tile of `tile` frames at a time (the
//     kernel's Producer: producer_cbr.cuh, producer_vbr.cuh, which the
//     two-kernel decode's dequant prologs share, or a copy of the dq stream)
//     and copy finished PCM tiles to the output, which is
//     contiguous per chunk and tile, 8 bytes a thread;
//   - the two meet at mbarriers: a full/empty pair per slot, kSlots slots for
//     dq and as many for PCM, so the producers' tile t+1 and the write-out of
//     tile t-1 run under the recurrence of tile t.
// The PCM ring holds one sub-tile [tile, C] per chunk, kPad int16 apart from
// a multiple of 64 bytes, so that the lanes of a recurrence warp write to
// different banks. The dq ring's layout is the kernel's: per-chunk sub-tiles
// like the PCM ring (CBR, VBR), or rows of the block's streams side by side
// (the copied dq stream); recurrence() takes it as two strides.
//
// Shared memory of a block, in this order: the barriers (kBarrierBytes), the
// dq ring (kSlots slots of dq_slot int16, dq_slot a multiple of 8), the PCM
// ring (kSlots slots of group sub-tiles of tile*C + kPad int16), then what the
// kernel adds. Each part keeps 16-byte alignment.
//
// Arithmetic: the int32 dot and the weight step wrap like the reference, so
// they are computed in uint32; sign(h)*delta is (delta ^ m) - m, m = h >> 31.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace decode_ring {

using namespace decode_tiles;

constexpr int kBatch = 32;   // frames a recurrence thread holds in registers
constexpr int kSlots = 2;    // ring depth, dq tiles and PCM tiles alike
constexpr int kPad = 4;      // int16 between the PCM ring's sub-tiles
constexpr int kBarrierBytes = 4 * kSlots * 8;
constexpr int kMaxWarps = 16;  // recurrence and producer warps of a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The warps of a block: the recurrence warps, then the producers. A warp
// issues on its SM's sub-partition (warp index mod 4). A kernel whose
// producers have time to spare asks for its one recurrence warp's scheduler
// to be left to it (`isolate`, each kernel's constant kIsolate): warps 4, 8
// and 12 then stay idle, so that no producer takes the issue slots the chain
// waits for (measured with scripts/torch_kernel_profile.py --idle-warps on
// and off; PERF.md §6). A kernel whose producers set the pace keeps all
// fifteen.
__host__ __device__ inline bool isolated(int rec_warps, bool isolate) {
  return isolate && rec_warps == 1;
}

__host__ __device__ inline bool idle_warp(int w, int rec_warps, bool isolate) {
  return isolated(rec_warps, isolate) && w > 0 && w % 4 == 0;
}

// idle warps below warp w
__host__ __device__ inline int idle_below(int w, int rec_warps, bool isolate) {
  return isolated(rec_warps, isolate) ? (w - 1) / 4 : 0;
}

// Producer warps: one per two streams, as many as the block's warps leave.
inline int producer_warps(int streams, int rec_warps, bool isolate) {
  const int room = kMaxWarps - rec_warps - idle_below(kMaxWarps, rec_warps, isolate);
  const int warps = (streams + 1) / 2;
  return warps < room ? warps : room;
}

// warps to launch for them, idle ones included
inline int block_warps(int rec_warps, int prod_warps, bool isolate) {
  int w = rec_warps;
  for (int p = 0; p < prod_warps; ++w)
    if (!idle_warp(w, rec_warps, isolate)) ++p;
  return w;
}

// The ring of a block: its tile geometry (tiles.cuh; `sub` is also the PCM
// ring's sub-tile), the barriers and the two rings.
struct Ring : Tiles {
  uint64_t* bars;   // dq full, dq empty, PCM full, PCM empty; kSlots each
  int16_t* dq;      // kSlots slots of dq_slot int16
  int16_t* pcm;     // kSlots slots of group sub-tiles of `sub` int16
  int dq_slot, pcm_slot;
  int ntiles;
  int rec_threads;

  __device__ uint64_t* dq_full(int s) const { return bars + s; }
  __device__ uint64_t* dq_empty(int s) const { return bars + kSlots + s; }
  __device__ uint64_t* pcm_full(int s) const { return bars + 2 * kSlots + s; }
  __device__ uint64_t* pcm_empty(int s) const { return bars + 3 * kSlots + s; }
};

// Lay out the rings at the start of `smem` for this block, launched with
// block_warps(rec_warps, ..., isolate) warps; *rest points past them. Thread 0
// initialises the barriers: __syncthreads() before use.
__device__ __forceinline__ Ring make_ring(unsigned char* smem, int n, int c, int frames,
                                          int tile, int group, int dq_slot, int rec_warps,
                                          bool isolate, unsigned char** rest) {
  Ring r;
  r.bars = reinterpret_cast<uint64_t*>(smem);
  r.dq = reinterpret_cast<int16_t*>(smem + kBarrierBytes);
  r.dq_slot = dq_slot;
  r.sub = tile * c + kPad;
  r.pcm_slot = group * r.sub;
  r.pcm = r.dq + kSlots * dq_slot;
  r.c = c;
  r.tile = tile;
  r.frames = frames;
  r.ntiles = (frames + tile - 1) / tile;
  r.chunk0 = blockIdx.x * group;
  r.chunks = min(group, n - r.chunk0);
  r.rec_threads = rec_warps * 32;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  r.prod_threads = 32 * (warps - rec_warps - idle_below(warps, rec_warps, isolate));
  r.ptid = warp < rec_warps || idle_warp(warp, rec_warps, isolate)
               ? -1
               : 32 * (warp - rec_warps - idle_below(warp, rec_warps, isolate)) + threadIdx.x % 32;
  *rest = reinterpret_cast<unsigned char*>(r.pcm + kSlots * r.pcm_slot);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(r.dq_full(i), r.prod_threads);
      mbar_init(r.dq_empty(i), r.rec_threads);
      mbar_init(r.pcm_full(i), r.rec_threads);
      mbar_init(r.pcm_empty(i), r.prod_threads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return r;
}

// ---- recurrence warps: one thread per (chunk, channel) stream ----
// Thread (k, ch) = (tid / C, tid % C) reads its dq of frame f in a slot at
// k * dq_chunk + ch + f * dq_frame. Lanes past the block's streams only keep
// the barriers' counts.
__device__ __forceinline__ void recurrence(const Ring& r, const int32_t* __restrict__ hist,
                                           const int32_t* __restrict__ wts, int dq_chunk,
                                           int dq_frame) {
  const int c = r.c;
  const int k = threadIdx.x / c, ch = threadIdx.x - k * c;
  const bool live = k < r.chunks;
  uint32_t h0 = 0, h1 = 0, h2 = 0, h3 = 0, w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  if (live) {
    const size_t st = (static_cast<size_t>(r.chunk0 + k) * c + ch) * 4;
    h0 = hist[st]; h1 = hist[st + 1]; h2 = hist[st + 2]; h3 = hist[st + 3];
    w0 = wts[st]; w1 = wts[st + 1]; w2 = wts[st + 2]; w3 = wts[st + 3];
  }
  auto step = [&](int32_t dq, int16_t* pcm) {
    const int32_t pred = static_cast<int32_t>(w0 * h0 + w1 * h1 + w2 * h2 + w3 * h3) >> 13;
    const int32_t recon = min(max(pred + dq, -32768), 32767);
    *pcm = static_cast<int16_t>(recon);
    const uint32_t delta = static_cast<uint32_t>(dq >> 4);
    const uint32_t m0 = static_cast<int32_t>(h0) >> 31, m1 = static_cast<int32_t>(h1) >> 31;
    const uint32_t m2 = static_cast<int32_t>(h2) >> 31, m3 = static_cast<int32_t>(h3) >> 31;
    w0 += (delta ^ m0) - m0;
    w1 += (delta ^ m1) - m1;
    w2 += (delta ^ m2) - m2;
    w3 += (delta ^ m3) - m3;
    h0 = h1; h1 = h2; h2 = h3; h3 = static_cast<uint32_t>(recon);
  };
  for (int t = 0; t < r.ntiles; ++t) {
    const int slot = t % kSlots;
    mbar_wait(r.dq_full(slot), (t / kSlots) & 1);
    if (t >= kSlots) mbar_wait(r.pcm_empty(slot), ((t / kSlots) - 1) & 1);
    if (live) {
      const int nf = min(r.tile, r.frames - t * r.tile);
      const int16_t* src = r.dq + slot * r.dq_slot + k * dq_chunk + ch;
      int16_t* dst = r.pcm + slot * r.pcm_slot + k * r.sub + ch;
      for (int fb = 0; fb < nf; fb += kBatch) {
        int32_t d[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) d[u] = src[(fb + u) * dq_frame];  // inside the slot: tile % kBatch == 0
        if (fb + kBatch <= nf) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) step(d[u], dst + (fb + u) * c);
        } else {
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (fb + u < nf) step(d[u], dst + (fb + u) * c);
        }
      }
    }
    mbar_arrive(r.dq_empty(slot));
    mbar_arrive(r.pcm_full(slot));
  }
}

// ---- producer warps: PCM tile t from the ring to out [n, frames, c] ----
__device__ __forceinline__ void copy_out(const Ring& r, int t, int ptid, int16_t* __restrict__ out) {
  const int slot = t % kSlots;
  mbar_wait(r.pcm_full(slot), (t / kSlots) & 1);
  const int f0 = t * r.tile;
  const int nsamp = min(r.tile, r.frames - f0) * r.c;
  const size_t chunk_elems = static_cast<size_t>(r.frames) * r.c;
  const int nvec = nsamp / 4;
  const int16_t* src = r.pcm + slot * r.pcm_slot;
  // a chunk's tile is contiguous in the output: 8 bytes a thread where the
  // chunk starts on an 8-byte boundary (its tiles then do too)
  for (int idx = ptid; idx < r.chunks * nvec; idx += r.prod_threads) {
    const int k = idx / nvec, v = idx - k * nvec;
    const size_t base = (r.chunk0 + k) * chunk_elems + static_cast<size_t>(f0) * r.c;
    const int16_t* s = src + k * r.sub + 4 * v;
    if ((base & 3) == 0) {
      reinterpret_cast<uint2*>(out + base)[v] = *reinterpret_cast<const uint2*>(s);
    } else {
      int16_t* d = out + base + 4 * v;
      d[0] = s[0]; d[1] = s[1]; d[2] = s[2]; d[3] = s[3];
    }
  }
  const int rest = nsamp - nvec * 4;
  for (int idx = ptid; idx < r.chunks * rest; idx += r.prod_threads) {
    const int k = idx / rest, j = nvec * 4 + (idx - k * rest);
    out[(r.chunk0 + k) * chunk_elems + static_cast<size_t>(f0) * r.c + j] = src[k * r.sub + j];
  }
  mbar_arrive(r.pcm_empty(slot));
}

// The producers' loop. For tile i the kernel's Producer does, in order,
// prepare(i) (work that needs no ring slot) and fill(i, slot), which writes
// the dq of tile i into the slot in the kernel's layout; then the PCM of tile
// i - 1 goes out.
template <class Producer>
__device__ __forceinline__ void produce(const Ring& r, int16_t* __restrict__ out, Producer& p) {
  for (int i = 0; i <= r.ntiles; ++i) {
    if (i < r.ntiles) {
      const int slot = i % kSlots;
      p.prepare(i);
      if (i >= kSlots) mbar_wait(r.dq_empty(slot), ((i / kSlots) - 1) & 1);
      p.fill(i, r.dq + slot * r.dq_slot);
      mbar_arrive(r.dq_full(slot));
    }
    if (i >= 1) copy_out(r, i - 1, r.ptid, out);
  }
}

}  // namespace decode_ring
