// What the kernels' C launchers share: asking for more dynamic shared memory
// than a block gets by default, once.

#pragma once

#include <cstddef>
#include <cuda_runtime.h>
#include <mutex>

namespace sea_launch {

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device. cudaFuncSetAttribute costs a launch tens of microseconds of host
// time, so it is called only above the 48 KB a block may take without
// asking, and only when the (kernel, device) pair has not been granted as
// much already: the grants are kept here (up to kGrants pairs; more ask on
// every launch). On failure the error is returned and cleared from the
// thread's last error, so that the next launcher does not report it again.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  constexpr size_t kDefaultSmem = 48 * 1024;
  constexpr int kGrants = 64;
  struct Grant {
    const void* kernel;
    int device;
    size_t smem;
  };
  static Grant grants[kGrants];
  static int used = 0;
  static std::mutex mu;
  if (smem <= kDefaultSmem) return cudaSuccess;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  std::lock_guard<std::mutex> lock(mu);
  Grant* g = nullptr;
  for (int i = 0; i < used; ++i)
    if (grants[i].kernel == fn && grants[i].device == device) g = &grants[i];
  if (g != nullptr && g->smem >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (g == nullptr && used < kGrants) g = &grants[used++];
  if (g != nullptr) *g = Grant{fn, device, smem};
  return cudaSuccess;
}

}  // namespace sea_launch
