// Helpers shared by the LSTM kernels (lstm.cu: the "streamed" sequence
// kernels and the parameter-gradient reduction; lstm_cluster.cu: the
// "cluster" sequence kernels). lstm.cu's header describes the variants.
#pragma once

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j_lstm {

// Dynamic shared memory a block may use on Hopper (232,448 bytes).
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kMaxSharedFloats = kMaxSharedBytes / 4;

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Copy 4 bytes from global to shared memory asynchronously; when !ok
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Raise a kernel's dynamic shared-memory limit past the default 48 KB once
// per device and size: `granted` (one array per kernel, zero-initialised)
// remembers the largest size set on each device, so a launch calls
// cudaFuncSetAttribute only when it asks for more than any launch before.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t grant_smem(Kernel kernel, size_t bytes,
                              std::atomic<size_t>* granted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && granted[dev].load() >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < kMaxDevices) {
    size_t was = granted[dev].load();
    while (was < bytes && !granted[dev].compare_exchange_weak(was, bytes)) {
    }
  }
  return e;
}

}  // namespace dl4j_lstm
