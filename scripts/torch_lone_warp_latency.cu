// Dependent-issue latencies of a lone warp on one CUDA card: what one step of
// a serial chain costs when nothing else runs on the SM, the situation of
// the window search (one warp per channel) and of a decode recurrence.
//
// Build and run on a machine with the card and the CUDA toolkit:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o lone_warp_latency \
//       scripts/torch_lone_warp_latency.cu && ./lone_warp_latency
//   nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
// Each line is clock64() cycles per iteration of a loop whose iterations
// depend on each other through the named instructions (4,096 iterations,
// one block of 32 threads, second launch timed). "IADD" shows the compiler
// folding a trivial chain; the two "indep" lines show what independent
// instructions beside a chain cost.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
#define N 4096
template <int OP>
__global__ void k(int* out, int a, int b, long long* cyc, int indep) {
  __shared__ int tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) tab[i] = (i * 7 + 3) & 1023;
  __syncthreads();
  int x = a + threadIdx.x, y = b, z = a ^ b, w = 5;
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < N; ++i) {
    if (OP == 0) x = x * y + z;                       // IMAD
    if (OP == 1) x = (x >> 13) + y;                   // SHF+IADD or LEA.HI
    if (OP == 2) x = min(max(x, -b), b + i);          // 2 VIMNMX
    if (OP == 3) x = tab[x & 1023];                   // LOP + LDS
    if (OP == 4) { long long p = (long long)x * y + 32768; x = (int)(p >> 16); }  // IMAD.WIDE + SHF
    if (OP == 5) x = x + y;                           // IADD
    if (OP == 6) { x = x * y + z; w = w * y + z; }    // two independent IMAD chains
    if (OP == 7) { x = x * y + z; w = w + y; z ^= w; } // IMAD + 2 independent ALU
    if (OP == 8) x = __shfl_sync(0xffffffffu, x, (x + 1) & 31);  // SHFL
    if (OP == 9) x = __reduce_min_sync(0xffffffffu, (unsigned)x) + threadIdx.x;  // REDUX
  }
  long long t1 = clock64();
  out[threadIdx.x] = x + w + z;
  if (threadIdx.x == 0) cyc[OP] = t1 - t0;
}
int main() {
  int* out; long long* cyc; cudaMalloc(&out, 4096); cudaMallocManaged(&cyc, 128);
  const char* names[] = {"IMAD", "SHF+IADD", "2xVIMNMX", "LOP+LDS", "IMAD.WIDE+SHF64", "IADD", "2 indep IMAD", "IMAD+2ALU indep", "SHFL", "REDUX"};
#define RUN(OP) k<OP><<<1, 32>>>(out, 3, 1001, cyc, 0); cudaDeviceSynchronize(); k<OP><<<1, 32>>>(out, 3, 1001, cyc, 0); cudaDeviceSynchronize(); printf("%-18s %.2f cycles per iteration\n", names[OP], (double)cyc[OP] / N);
  RUN(0) RUN(1) RUN(2) RUN(3) RUN(4) RUN(5) RUN(6) RUN(7) RUN(8) RUN(9)
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
