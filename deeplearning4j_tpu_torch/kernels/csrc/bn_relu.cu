// Training-mode BatchNorm + ReLU kernels for Hopper (sm_90a): the forward
// (batch statistics, normalisation, scale and shift, ReLU in one launch)
// and the backward (the ReLU mask fused with the three BN reductions).
//
// Replaces the TPU kernels of deeplearning4j_tpu/kernels/bn_relu.py:
//   * _fwd_kernel (reached through _fwd_call's pl.pallas_call);
//   * _bwd_kernel (reached through _bwd_call's pl.pallas_call).
//
// x is [N, C] (an NHWC activation flattened to [N*H*W, C]) in float32,
// bfloat16 or float16; gamma, beta, mean and var are [C] float32; every sum
// and every product is float32, and y / dx come back in x's dtype. Per
// channel, exactly _fwd_kernel's and _bwd_kernel's equations:
//
//   mean = sum(x) / n;  var = sum((x - mean)^2) / n   (two passes, biased)
//   inv = 1 / sqrt(var + eps)
//   y = max((x - mean) * inv * gamma + beta, 0)
//
//   xhat = (x - mean) * inv;  dyr = dy where xhat * gamma + beta > 0, else 0
//   dg = sum(dyr * xhat);  db = sum(dyr)
//   dx = (gamma * inv / n) * (n * dyr - db - xhat * dg)
//
// What bounds them: both are per-channel column reductions with a handful
// of FLOPs per element, so the bytes bound them: the forward must read x
// and write y (4 bytes an element in bf16), the backward read x and dy and
// write dx (6 bytes). At the BN-MLP's shapes (N = 128, C = 1024, bf16) that
// is 0.5-0.75 MB, well under a microsecond of HBM time: a launch's fixed
// cost is the floor there.
//
// What the design does about it: the TPU kernel keeps a channel block's
// whole batch in VMEM and reduces over it in one grid step; on the card a
// block of 256 threads owns 32 contiguous channels and loops over all N
// rows, so there is no cap on N and no reduction across blocks (no
// atomics: every sum is taken in a fixed order, bit-equal run to run).
// Lanes sit on neighbouring channels and load 16 bytes each (8 bf16 / f16
// or 4 f32 channels) where C and the pointers allow it, else one element;
// a warp covers 4-32 rows at once and the 8 warps stride over the rows.
// Per-thread partial sums are combined by warp shuffles and then across
// warps through shared memory. The forward reads x three times (mean,
// centred variance, output) and the backward twice; the re-reads come from
// the 50 MB L2 (x is 8 MB at N = 4096, C = 1024 bf16). A channel tail is
// guarded instead of padded (the TPU pads C to 128 and var with 1s). At
// C = 1024 the grid has 32 blocks on 132 SMs; splitting N across a cluster
// with a DSMEM reduction is left for later work. The elementwise chains use
// the _rn intrinsics so that no FMA contraction changes their rounding
// against the plain PyTorch version.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 32;   // channels per block

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// V consecutive elements of T, moved as one (16-byte when V * sizeof(T) is
// 16) load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The thread's place in its block: V channels at `slot * V` of the block's
// 32, rows `rslot`, `rslot + kRows`, ...
template <int V>
struct Layout {
  static constexpr int kLanesPerRow = kChannels / V;
  static constexpr int kRows = kThreads / kLanesPerRow;   // rows per pass
  int slot, rslot, c;
  bool live;
  __device__ Layout(int C) {
    slot = threadIdx.x % kLanesPerRow;
    rslot = threadIdx.x / kLanesPerRow;
    c = blockIdx.x * kChannels + slot * V;
    live = c < C;   // V divides C, so a pack is wholly inside or outside
  }
};

// Sums acc[0..V) (and acc2 when kTwo) over every thread of the block that
// holds the same channels; the block's totals land in out[kChannels] (and
// out2), then every thread reads back its own channels' totals.
template <int V, bool kTwo>
__device__ __forceinline__ void block_channel_sums(float* acc, float* acc2,
                                                   float (*red)[kChannels],
                                                   float (*red2)[kChannels],
                                                   float* out, float* out2) {
  constexpr int kLanes = Layout<V>::kLanesPerRow;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int slot = threadIdx.x % kLanes;
#pragma unroll
  for (int off = kLanes; off < 32; off *= 2) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if (kTwo) acc2[j] += __shfl_xor_sync(0xffffffffu, acc2[j], off);
    }
  }
  if (lane < kLanes) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[warp][slot * V + j] = acc[j];
      if (kTwo) red2[warp][slot * V + j] = acc2[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < kChannels) {
    float s = 0.0f, s2 = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      s += red[w][threadIdx.x];
      if (kTwo) s2 += red2[w][threadIdx.x];
    }
    out[threadIdx.x] = s;
    if (kTwo) out2[threadIdx.x] = s2;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc[j] = out[slot * V + j];
    if (kTwo) acc2[j] = out2[slot * V + j];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ var_out,
                   int N, int C, float eps) {
  using P = Pack<T, V>;
  __shared__ float red[kWarps][kChannels];
  __shared__ float tot[kChannels];
  const Layout<V> L(C);
  constexpr int kRows = Layout<V>::kRows;
  const float n = (float)N;

  // pass 1: the mean
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (L.live) {
#pragma unroll 4
    for (int r = L.rslot; r < N; r += kRows) {
      const P p = *reinterpret_cast<const P*>(x + (size_t)r * C + L.c);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += to_f32(p.v[j]);
    }
  }
  block_channel_sums<V, false>(acc, nullptr, red, nullptr, tot, nullptr);
  float mean[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = __fdiv_rn(acc[j], n);
  __syncthreads();   // tot is reused below

  // pass 2: the centred variance
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (L.live) {
#pragma unroll 4
    for (int r = L.rslot; r < N; r += kRows) {
      const P p = *reinterpret_cast<const P*>(x + (size_t)r * C + L.c);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(to_f32(p.v[j]), mean[j]);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
      }
    }
  }
  block_channel_sums<V, false>(acc, nullptr, red, nullptr, tot, nullptr);
  if (!L.live) return;
  float inv[V], g[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float var = __fdiv_rn(acc[j], n);
    inv[j] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
    g[j] = gamma[L.c + j];
    b[j] = beta[L.c + j];
    if (L.rslot == 0) {
      mean_out[L.c + j] = mean[j];
      var_out[L.c + j] = var;
    }
  }

  // pass 3: y = max((x - mean) * inv * gamma + beta, 0)
#pragma unroll 4
  for (int r = L.rslot; r < N; r += kRows) {
    const size_t off = (size_t)r * C + L.c;
    const P p = *reinterpret_cast<const P*>(x + off);
    P q;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float t = __fmul_rn(__fsub_rn(to_f32(p.v[j]), mean[j]), inv[j]);
      t = __fadd_rn(__fmul_rn(t, g[j]), b[j]);
      q.v[j] = from_f32<T>(t < 0.0f ? 0.0f : t);   // NaN passes, as relu
    }
    *reinterpret_cast<P*>(y + off) = q;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float* __restrict__ mean_in,
                   const float* __restrict__ var_in,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dg_out, float* __restrict__ db_out,
                   int N, int C, float eps) {
  using P = Pack<T, V>;
  __shared__ float red[kWarps][kChannels];
  __shared__ float red2[kWarps][kChannels];
  __shared__ float tot[kChannels];
  __shared__ float tot2[kChannels];
  const Layout<V> L(C);
  constexpr int kRows = Layout<V>::kRows;
  const float n = (float)N;

  float mean[V], inv[V], g[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = L.live ? L.c + j : 0;
    mean[j] = mean_in[c];
    inv[j] = __frcp_rn(__fsqrt_rn(__fadd_rn(var_in[c], eps)));
    g[j] = gamma[c];
    b[j] = beta[c];
  }

  // pass 1: dg = sum(dyr * xhat), db = sum(dyr), the ReLU mask recomputed
  float sg[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sb[j] = 0.0f;
  if (L.live) {
#pragma unroll 4
    for (int r = L.rslot; r < N; r += kRows) {
      const size_t off = (size_t)r * C + L.c;
      const P px = *reinterpret_cast<const P*>(x + off);
      const P pd = *reinterpret_cast<const P*>(dy + off);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(px.v[j]), mean[j]),
                                   inv[j]);
        const float pre = __fadd_rn(__fmul_rn(xh, g[j]), b[j]);
        const float d = pre > 0.0f ? to_f32(pd.v[j]) : 0.0f;
        sg[j] = __fadd_rn(sg[j], __fmul_rn(d, xh));
        sb[j] += d;
      }
    }
  }
  block_channel_sums<V, true>(sg, sb, red, red2, tot, tot2);
  if (!L.live) return;
  float k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    k[j] = __fdiv_rn(__fmul_rn(g[j], inv[j]), n);
    if (L.rslot == 0) {
      dg_out[L.c + j] = sg[j];
      db_out[L.c + j] = sb[j];
    }
  }

  // pass 2: dx = (gamma * inv / n) * (n * dyr - db - xhat * dg)
#pragma unroll 4
  for (int r = L.rslot; r < N; r += kRows) {
    const size_t off = (size_t)r * C + L.c;
    const P px = *reinterpret_cast<const P*>(x + off);
    const P pd = *reinterpret_cast<const P*>(dy + off);
    P q;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = __fmul_rn(__fsub_rn(to_f32(px.v[j]), mean[j]),
                                 inv[j]);
      const float pre = __fadd_rn(__fmul_rn(xh, g[j]), b[j]);
      const float d = pre > 0.0f ? to_f32(pd.v[j]) : 0.0f;
      const float t = __fsub_rn(__fsub_rn(__fmul_rn(n, d), sb[j]),
                                __fmul_rn(xh, sg[j]));
      q.v[j] = from_f32<T>(__fmul_rn(k[j], t));
    }
    *reinterpret_cast<P*>(dx + off) = q;
  }
}

template <typename T, int V>
int launch_fwd(const void* x, const float* gamma, const float* beta, void* y,
               float* mean, float* var, int N, int C, float eps,
               void* stream) {
  const int blocks = (C + kChannels - 1) / kChannels;
  bn_relu_fwd_kernel<T, V><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mean, var, N,
      C, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* x, const float* gamma, const float* beta,
               const float* mean, const float* var, const void* dy, void* dx,
               float* dg, float* db, int N, int C, float eps, void* stream) {
  const int blocks = (C + kChannels - 1) / kChannels;
  bn_relu_bwd_kernel<T, V><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), gamma, beta, mean, var,
      static_cast<const T*>(dy), static_cast<T*>(dx), dg, db, N, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. wide: 1 when C is a multiple of
// the 16-byte pack (4 f32 or 8 bf16 / f16 channels) and every [N, C]
// pointer is 16-byte aligned, else 0 (one element per load). Returns a CUDA
// error code, or cudaErrorInvalidValue for an unknown dtype.
extern "C" int dl4j_bn_relu_fwd(const void* x, const float* gamma,
                                const float* beta, void* y, float* mean,
                                float* var, int N, int C, float eps,
                                int dtype, int wide, void* stream) {
  switch (dtype * 2 + (wide ? 1 : 0)) {
    case 0: return launch_fwd<float, 1>(x, gamma, beta, y, mean, var, N, C, eps, stream);
    case 1: return launch_fwd<float, 4>(x, gamma, beta, y, mean, var, N, C, eps, stream);
    case 2: return launch_fwd<__nv_bfloat16, 1>(x, gamma, beta, y, mean, var, N, C, eps, stream);
    case 3: return launch_fwd<__nv_bfloat16, 8>(x, gamma, beta, y, mean, var, N, C, eps, stream);
    case 4: return launch_fwd<__half, 1>(x, gamma, beta, y, mean, var, N, C, eps, stream);
    case 5: return launch_fwd<__half, 8>(x, gamma, beta, y, mean, var, N, C, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dl4j_bn_relu_bwd(const void* x, const float* gamma,
                                const float* beta, const float* mean,
                                const float* var, const void* dy, void* dx,
                                float* dg, float* db, int N, int C, float eps,
                                int dtype, int wide, void* stream) {
  switch (dtype * 2 + (wide ? 1 : 0)) {
    case 0: return launch_bwd<float, 1>(x, gamma, beta, mean, var, dy, dx, dg, db, N, C, eps, stream);
    case 1: return launch_bwd<float, 4>(x, gamma, beta, mean, var, dy, dx, dg, db, N, C, eps, stream);
    case 2: return launch_bwd<__nv_bfloat16, 1>(x, gamma, beta, mean, var, dy, dx, dg, db, N, C, eps, stream);
    case 3: return launch_bwd<__nv_bfloat16, 8>(x, gamma, beta, mean, var, dy, dx, dg, db, N, C, eps, stream);
    case 4: return launch_bwd<__half, 1>(x, gamma, beta, mean, var, dy, dx, dg, db, N, C, eps, stream);
    case 5: return launch_bwd<__half, 8>(x, gamma, beta, mean, var, dy, dx, dg, db, N, C, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
