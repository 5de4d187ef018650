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
// 2 bytes per sample) but the recurrence: a stream is a chain of `frames`
// dependent steps (the dot's last multiply-add, a shift, an add, the clamp),
// and a chunk holds only C streams. Whatever else the thread that walks the
// chain has to issue (unpack, dequant, scattered 2-byte stores) lengthens
// every step, because a lone warp pays each instruction's latency in order.
//
// Design: the frame's work is split by whether it is on the chain. A block
// decodes up to 32 / C chunks (one chunk from 17 channels on), with two kinds
// of warps that never reconverge:
//   - recurrence warps, one thread per (chunk, channel) stream, so that up
//     to 16 channels a block's streams fill one warp: one chunk a block left
//     2 of 32 lanes busy on stereo and twelve such warps, each with its
//     producers, contending for an SM. They read dq from a shared-memory
//     ring 32 frames at a time into registers, walk only the chain and the
//     weight step, and write PCM into a shared-memory tile;
//   - producer warps (one per two streams) unpack and dequantize a tile of T
//     frames x C channels of each chunk at a time. Eight consecutive codes
//     are exactly rs bytes, so a thread reads one byte-aligned group straight
//     from device memory (no staged row: a row of any length decodes),
//     dequantizes its eight samples and stores them into the ring. They also
//     copy finished PCM tiles from shared memory to the output, which is
//     contiguous per chunk and tile, 8 bytes a thread.
// The two meet at mbarriers (a full/empty pair per ring slot, two slots for
// dq and two for PCM), so the dequant of tile t+1 and the write-out of tile
// t-1 run under the recurrence of tile t. A slot holds one sub-tile per
// chunk, 8 bytes apart from a multiple of 64, so the lanes of the recurrence
// warp read different banks. The TPU layout (byte-plane transpose, chunk =
// g*128 + lane, VMEM block planning) has no counterpart.
//
// Rounding: the two f32 steps of the dequant curve and of floor(x*c + 0.5)
// are separate roundings in the table build; __fmul_rn/__fadd_rn keep nvcc
// from contracting them into an FMA. The int32 dot and the weight step wrap
// like the reference, so they are computed in uint32; the weight step's
// sign(h)*delta is (delta ^ m) - m with m = h >> 31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 32;   // frames a recurrence thread holds in registers
constexpr int kSlots = 2;    // ring depth, dq tiles and PCM tiles alike
constexpr int kPad = 4;      // int16 between a slot's sub-tiles: the lanes of a warp on different banks

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

__global__ void __launch_bounds__(512) fused_decode_cbr_kernel(
    const uint8_t* __restrict__ res,    // [n, res_stride] packed residuals
    const uint8_t* __restrict__ sf,     // [n, w, c] scale-factor codes
    const int32_t* __restrict__ hist,   // [n, c, 4] LMS entry history
    const int32_t* __restrict__ wts,    // [n, c, 4] LMS entry weights
    const float* __restrict__ sfval,    // [2^sfb] scale-factor values for rs
    int16_t* __restrict__ out,          // [n, frames, c] PCM
    int n, int res_stride, int res_bytes, int c, int w, int frames, int n_sf,
    int rs, int sff, int tile, int group, int rec_warps, float c0, float stepf,
    float endv, int kmax) {
  // layout: dq ring, PCM ring (each kSlots slots of `group` sub-tiles of
  // tile*c + kPad int16, 8-byte aligned), scale-factor values, the barriers
  extern __shared__ __align__(16) unsigned char smem[];
  const int sub = tile * c + kPad;
  const int slot_elems = group * sub;
  int16_t* dq_s = reinterpret_cast<int16_t*>(smem);
  int16_t* pcm_s = dq_s + kSlots * slot_elems;
  float* sfv_s = reinterpret_cast<float*>(pcm_s + kSlots * slot_elems);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sfv_s + n_sf);
  uint64_t* dq_full = bars;                 // producers -> recurrence
  uint64_t* dq_empty = bars + kSlots;       // recurrence -> producers
  uint64_t* pcm_full = bars + 2 * kSlots;   // recurrence -> producers
  uint64_t* pcm_empty = bars + 3 * kSlots;  // producers -> recurrence

  const int chunk0 = blockIdx.x * group;         // this block's first chunk
  const int chunks = min(group, n - chunk0);     // and how many it decodes
  const int rec_threads = rec_warps * 32;
  const int prod_threads = blockDim.x - rec_threads;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(dq_full + i, prod_threads);
      mbar_init(dq_empty + i, rec_threads);
      mbar_init(pcm_full + i, rec_threads);
      mbar_init(pcm_empty + i, prod_threads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < n_sf; i += blockDim.x) sfv_s[i] = sfval[i];
  __syncthreads();
  const int ntiles = (frames + tile - 1) / tile;
  const size_t chunk_elems = static_cast<size_t>(frames) * c;

  if (threadIdx.x >= rec_threads) {
    // ---- producers: unpack + dequant into the dq ring, PCM tiles out ----
    const int ptid = threadIdx.x - rec_threads;
    const int mask = (1 << rs) - 1;
    for (int i = 0; i <= ntiles; ++i) {
      if (i < ntiles) {
        const int slot = i % kSlots;
        if (i >= kSlots) mbar_wait(dq_empty + slot, ((i / kSlots) - 1) & 1);
        const int f0 = i * tile;
        const int nsamp = min(tile, frames - f0) * c;
        const int groups = (nsamp + 7) / 8;  // of eight codes, per chunk
        for (int idx = ptid; idx < chunks * groups; idx += prod_threads) {
          const int k = idx / groups, g = idx - k * groups;
          const uint8_t* row = res + static_cast<size_t>(chunk0 + k) * res_stride;
          const uint8_t* sf_row = sf + static_cast<size_t>(chunk0 + k) * w * c;
          // eight codes = rs bytes at a byte boundary, MSB first
          const int byte0 = ((f0 * c) / 8 + g) * rs;
          unsigned long long bits = 0;
          for (int b = 0; b < rs; ++b) {
            const int at = byte0 + b;
            const unsigned long long v = at < res_bytes ? row[at] : 0;
            bits |= v << (56 - 8 * b);
          }
          int fl = (g * 8) / c;  // frame within the tile, then its channel
          int ch = g * 8 - fl * c;
          int win = (f0 + fl) / sff;
          int fin = (f0 + fl) - win * sff;  // frame within its window
          __align__(8) int16_t vals[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int q = static_cast<int>(bits >> (64 - rs * (u + 1))) & mask;
            const int wi = min(win, w - 1);  // a partial group runs past the chunk
            const float sfv = sfv_s[sf_row[wi * c + ch] & (n_sf - 1)];
            const int kq = q >> 1;
            float curve = __fadd_rn(0.5f, __fmul_rn(static_cast<float>(kq), stepf));
            if (kq == kmax) curve = endv;
            if (kq == 0) curve = c0;
            const int dq_abs = static_cast<int>(floorf(__fadd_rn(__fmul_rn(sfv, curve), 0.5f)));
            vals[u] = static_cast<int16_t>((q & 1) ? -dq_abs : dq_abs);
            if (++ch == c) {
              ch = 0;
              if (++fin == sff) {
                fin = 0;
                ++win;
              }
            }
          }
          uint2* dst = reinterpret_cast<uint2*>(dq_s + slot * slot_elems + k * sub + g * 8);
          dst[0] = reinterpret_cast<const uint2*>(vals)[0];
          dst[1] = reinterpret_cast<const uint2*>(vals)[1];
        }
        mbar_arrive(dq_full + slot);
      }
      if (i >= 1) {
        // a chunk's tile of PCM is contiguous in the output: 8 bytes a thread
        // where the chunk starts on an 8-byte boundary (its tiles then do too)
        const int t = i - 1;
        const int slot = t % kSlots;
        mbar_wait(pcm_full + slot, (t / kSlots) & 1);
        const int f0 = t * tile;
        const int nsamp = min(tile, frames - f0) * c;
        const int nvec = nsamp / 4;
        for (int idx = ptid; idx < chunks * nvec; idx += prod_threads) {
          const int k = idx / nvec, v = idx - k * nvec;
          const size_t base = (chunk0 + k) * chunk_elems;
          if ((base & 3) == 0) {
            reinterpret_cast<uint2*>(out + base + static_cast<size_t>(f0) * c)[v] =
                reinterpret_cast<const uint2*>(pcm_s + slot * slot_elems + k * sub)[v];
          } else {
            const int16_t* src = pcm_s + slot * slot_elems + k * sub + 4 * v;
            int16_t* dst = out + base + static_cast<size_t>(f0) * c + 4 * v;
            dst[0] = src[0]; dst[1] = src[1]; dst[2] = src[2]; dst[3] = src[3];
          }
        }
        const int rest = nsamp - nvec * 4;
        for (int idx = ptid; idx < chunks * rest; idx += prod_threads) {
          const int k = idx / rest, j = nvec * 4 + (idx - k * rest);
          out[(chunk0 + k) * chunk_elems + static_cast<size_t>(f0) * c + j] =
              pcm_s[slot * slot_elems + k * sub + j];
        }
        mbar_arrive(pcm_empty + slot);
      }
    }
  } else {
    // ---- recurrence: one thread per channel stream, the chain only ----
    // a block of several chunks (c <= 16) has one recurrence warp whose lanes
    // are (chunk, channel); else thread = channel of the block's one chunk
    const int k = threadIdx.x / c, ch = threadIdx.x - k * c;
    const bool live = k < chunks;  // idle lanes only keep the barriers' counts
    uint32_t h0 = 0, h1 = 0, h2 = 0, h3 = 0, w0 = 0, w1 = 0, w2 = 0, w3 = 0;
    if (live) {
      const size_t st = (static_cast<size_t>(chunk0 + k) * c + ch) * 4;
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
    for (int t = 0; t < ntiles; ++t) {
      const int slot = t % kSlots;
      mbar_wait(dq_full + slot, (t / kSlots) & 1);
      if (t >= kSlots) mbar_wait(pcm_empty + slot, ((t / kSlots) - 1) & 1);
      if (live) {
        const int nf = min(tile, frames - t * tile);
        const int16_t* src = dq_s + slot * slot_elems + k * sub + ch;
        int16_t* dst = pcm_s + slot * slot_elems + k * sub + ch;
        for (int fb = 0; fb < nf; fb += kBatch) {
          int32_t d[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) d[u] = src[(fb + u) * c];  // inside the sub-tile: tile % kBatch == 0
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
      mbar_arrive(dq_empty + slot);
      mbar_arrive(pcm_full + slot);
    }
  }
}

}  // namespace

// `tile` (frames per tile, a multiple of 32) and `group` (chunks per block:
// as many as give one warp of streams, 1 from 17 channels on) come from the
// wrapper, which sizes the shared memory by them too.
extern "C" int sea_fused_decode_cbr(
    const void* res, const void* sf, const void* hist, const void* wts,
    const void* sfval, void* out, int n, int res_stride, int res_bytes, int c,
    int w, int frames, int n_sf, int rs, int sff, int tile, int group, float c0,
    float stepf, float endv, int kmax, void* stream) {
  const int streams = group * c;
  const int rec_warps = (streams + 31) / 32;
  // a producer warp for every 2 streams: at 32 streams a block the producers
  // set the pace (measured: 8 warps 0.178 ms, 15 warps 0.151 ms at [1550, 5120, 2])
  int prod_warps = (streams + 1) / 2;
  if (prod_warps > 16 - rec_warps) prod_warps = 16 - rec_warps;
  const int threads = 32 * (rec_warps + prod_warps);
  const size_t smem = 2 * kSlots * static_cast<size_t>(group) * (tile * c + kPad) * sizeof(int16_t) +
                      sizeof(float) * n_sf + 4 * kSlots * sizeof(uint64_t);
  cudaFuncSetAttribute(fused_decode_cbr_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int blocks = (n + group - 1) / group;
  fused_decode_cbr_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(res), static_cast<const uint8_t*>(sf),
      static_cast<const int32_t*>(hist), static_cast<const int32_t*>(wts),
      static_cast<const float*>(sfval), static_cast<int16_t*>(out), n, res_stride,
      res_bytes, c, w, frames, n_sf, rs, sff, tile, group, rec_warps, c0, stepf, endv, kmax);
  return static_cast<int>(cudaGetLastError());
}
