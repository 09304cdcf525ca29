// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu,
// attention_wgmma.cu): element types, packed shared-memory reads, cp.async,
// row reductions, tile staging and launch plumbing. attention.cu's header
// describes the kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dl4j_attn {

constexpr int kThreads = 256;   // the forward, the wide and SIMT kernels
constexpr int TX = 16;          // lanes that share a row of a score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- element types --------------------------------------------------------
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Four consecutive elements of shared memory (a 4-element-aligned pack) as
// f32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---- cp.async ---------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy kBytes (16, 8 or 4) from global to shared memory asynchronously; when
// !ok nothing is read and the destination is zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const int n = ok ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- reductions over the lanes that share a row ----------------------------
__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_max16(float v) {
  v = row_max8(v);
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
}

__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float row_sum16(float v) {
  v = row_sum8(v);
  return v + __shfl_xor_sync(0xffffffffu, v, 8);
}

// ---- tiles in shared memory -------------------------------------------------
// The padded head dimension (a multiple of 4) and the shared-memory row
// stride in elements: a multiple of 4 whose count of packs is odd, so
// neighbouring rows start on other banks.
__host__ __device__ __forceinline__ int fwd_dpad(int Dh) {
  return (Dh + 3) & ~3;
}
__host__ __device__ __forceinline__ int fwd_stride(int Dh) {
  const int dpad = fwd_dpad(Dh);
  return dpad + ((dpad & 7) == 0 ? 4 : 0);
}

// Stage rows [r0, r0 + rows) of a source with n rows of Dh elements (row
// stride ld) into a shared tile with row stride DP, in the source's type.
// `vec`: one cp.async per pack of 4 elements, zero-filled past n.
// Otherwise element by element, zero-filled past n and in the columns
// [Dh, Dpad); the caller's next barrier publishes those stores.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0,
                                           int rows, int n, long long ld,
                                           int Dh, int DP, bool vec) {
  const int dpad = fwd_dpad(Dh);
  if (vec) {
    const int packs = dpad >> 2;
    for (int e = threadIdx.x; e < rows * packs; e += kThreads) {
      const int r = e / packs;
      const int c = (e - r * packs) << 2;
      const int t = r0 + r;
      const bool ok = t < n;
      cp_async<4 * sizeof(T)>(dst + r * DP + c, ok ? src + t * ld + c : src,
                              ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * dpad; e += kThreads) {
      const int r = e / dpad;
      const int c = e - r * dpad;
      const int t = r0 + r;
      dst[r * DP + c] =
          (t < n && c < Dh) ? src[t * ld + c] : from_f32<T>(0.0f);
    }
  }
}

// Stage n_rows floats of a per-row statistic (L or D), zero past n.
__device__ __forceinline__ void stage_stat(float* dst, const float* src,
                                           int r0, int rows, int n) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool ok = r0 + r < n;
    cp_async<4>(dst + r, ok ? src + r0 + r : src, ok);
  }
}

// ---- launch plumbing --------------------------------------------------------
// Raise a kernel's dynamic shared-memory limit to `bytes` when that and its
// static shared memory need more than the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes,
                              size_t static_bytes = 0) {
  if (bytes + static_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

template <typename T>
inline bool packs_aligned(int Dh, long long ld, const void* p) {
  const uintptr_t a = 4 * sizeof(T);
  return Dh % 4 == 0 && ld % 4 == 0 && (uintptr_t)p % a == 0;
}

// A problem the kernels take: every extent positive, B * H on gridDim.x.
inline bool bad_shape(int B, int T, int S, int H, int Dh) {
  return B < 1 || T < 1 || S < 1 || H < 1 || Dh < 1 ||
         (long long)B * H > 2147483647LL;
}

}  // namespace dl4j_attn

// The element type for a dtype code: 0 float32, 1 bfloat16, 2 float16.
// Every CALL returns.
#define DL4J_BY_DTYPE(CALL)                       \
  switch (dtype) {                                \
    case 0: CALL(float)                           \
    case 1: CALL(__nv_bfloat16)                   \
    case 2: CALL(__half)                          \
    default: return (int)cudaErrorInvalidValue;   \
  }
