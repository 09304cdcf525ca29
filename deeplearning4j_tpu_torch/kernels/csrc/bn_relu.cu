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
// cost and one round trip to device memory are the floor there; at
// N = 4096 it is 16-24 MB, 5-7.5 us at 3.35 TB/s.
//
// Two variants, picked per call from the shape alone by
// kernels/bn_relu.py:bn_plan (which mirrors resident_bytes below):
//
//   * "resident" (bn_relu_fwd_resident_kernel, bn_relu_bwd_resident_kernel):
//     a CTA of 256 threads owns one 32-byte row segment of channels (16
//     bf16 / f16 or 8 f32 channels: one sector a row) and `rows` rows of
//     it; a thread-block cluster of n CTAs (n <= 8, portable) splits N
//     between its ranks, so C = 1024 at N = 4096 runs 64 x 2 = 128 CTAs on
//     the 132 SMs (the streamed grid ran 32). Each CTA copies its slab of
//     x (and dy) into shared memory once, with 16-byte cp.async in four
//     commit groups, summing each group as it lands; every thread reads
//     back only the packs it copied itself, so no barrier guards the slab.
//     (Not TMA: a tensor map is encoded on the host for each call, where
//     the launch path already outweighs the kernel at N = 128, and a slab
//     is a column of 32-byte row segments, one bulk copy each.)
//     The CTA's per-channel partials (warp shuffles, then the 8 warps in
//     order) go to every rank through DSMEM after one cluster barrier and
//     are added in rank order, so every CTA holds the same total bit for
//     bit; one thread a channel then takes the IEEE-rounded division and
//     square root (software sequences, slowest on zeros) and shares the
//     result through shared memory, instead of every thread repeating
//     them for its 4-8 channels on the forward's critical path. The forward does this twice (the mean, then the centred
//     variance from the resident slab: two passes, as _fwd_kernel) and
//     writes y from shared memory; the backward once (dgamma and dbeta
//     together) and writes dx from shared memory. Device memory then sees
//     what the bound counts: x read once and y written once, or x and dy
//     read once and dx written once. A final split cluster barrier
//     (arrive after the last DSMEM read, wait before exit) keeps a CTA's
//     shared memory alive while a peer may still read it. With n = 1 the
//     cluster barriers are __syncthreads. What bounds it: at N = 128 the
//     launch and one load's latency; at N = 4096 the slab's bytes, loaded
//     before the first reduction can finish and written after the last
//     (load, reduce and store do not overlap across phases). Rows are
//     reserved in multiples of 128, so a CTA holds up to 7168 rows (the
//     forward) or 3584 (the backward: x and dy) in its 227 KB: N up to
//     57,344 or 28,672 at n = 8.
//   * "streamed" (bn_relu_fwd_kernel, bn_relu_bwd_kernel, the first port's):
//     a block of 256 threads owns 32 contiguous channels and loops over all
//     N rows, re-reading x from L2 (three passes forward, two backward), so
//     N has no cap. Taken only where a resident slab does not fit a
//     cluster of 8 (N above those limits); the BN layer's tier (JAX's
//     _block_c) sends such N only at C <= 18 (the backward) or C <= 9 (the
//     forward).
//
// Both: no atomics, every sum in a fixed order, so reruns are bit-equal
// (the two variants add in different orders). Lanes sit on neighbouring
// channels and move 16 bytes each (8 bf16 / f16 or 4 f32 channels) where C
// and the pointers allow it, else one element (the resident variant then
// copies with plain loads and stores, not cp.async). A channel tail is
// guarded instead of padded (the TPU pads C to 128 and var with 1s). The
// elementwise chains use the _rn intrinsics so that no FMA contraction
// changes their rounding against the plain PyTorch version; NaN passes the
// ReLU as in jnp.maximum.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// "resident": the slab in shared memory, N split across a cluster
// ---------------------------------------------------------------------------
constexpr int kSegBytes = 32;              // a CTA's row segment: one sector
constexpr int kMaxGroup = kSegBytes / 2;   // its channels at most (2-byte T)
constexpr int kRowQuantum = 128;           // slab rows are reserved in these
constexpr int kStages = 4;                 // cp.async groups a slab lands in
constexpr int kMaxCluster = 8;             // CTAs of a cluster: portable
// red [2][kWarps][kMaxGroup], part [2][kMaxGroup], tot [2][kMaxGroup]
constexpr int kScratchFloats = 2 * kWarps * kMaxGroup + 4 * kMaxGroup;
constexpr int kScratchBytes = kScratchFloats * 4;

// One slab of `rows` rows of a 32-byte segment, in bytes: every layout
// below (16-byte packs, 128 rows a pass; or single elements, 16 or 32 rows
// a pass) fits in it.
__host__ __device__ inline long long slab_bytes(int rows) {
  return (long long)((rows + kRowQuantum - 1) / kRowQuantum) * kRowQuantum *
         kSegBytes;
}

// Dynamic shared memory of one resident CTA: kernels/bn_relu.py:
// resident_bytes must agree.
__host__ __device__ inline long long resident_bytes(int rows, bool backward) {
  return kScratchBytes + (backward ? 2 : 1) * slab_bytes(rows);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Wait until stage s of kStages has landed (groups after it may not have).
__device__ __forceinline__ void cp_async_wait_stage(int s) {
  switch (kStages - 1 - s) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The thread's place in a resident CTA: V channels at `slot * V` of the
// CTA's kGroup, rows r0 + rslot, r0 + rslot + kRows, ... of the CTA's
// [r0, r0 + rows) (rank `rank` of a cluster of n); its k-th pack sits at
// slab[k * kThreads + threadIdx.x], so every thread reads back only what
// it copied.
template <typename T, int V>
struct Resident {
  static constexpr int kGroup = kSegBytes / (int)sizeof(T);
  static constexpr int kLanes = kGroup / V;              // threads a row
  static constexpr int kRows = kThreads / kLanes;        // rows a pass
  int slot, rslot, rank, c0, c, packs;
  bool live;
  size_t first, stride;   // element offsets: first pack, between packs
  __device__ Resident(int N, int C, int rows, int n_cl) {
    slot = threadIdx.x % kLanes;
    rslot = threadIdx.x / kLanes;
    rank = blockIdx.x % n_cl;
    c0 = (blockIdx.x / n_cl) * kGroup;
    c = c0 + slot * V;
    live = c < C;   // V divides C, so a pack is wholly inside or outside
    const int r0 = rank * rows + rslot;
    const int r_end = min(N, rank * rows + rows);
    packs = live && r0 < r_end ? (r_end - r0 + kRows - 1) / kRows : 0;
    first = packs ? (size_t)r0 * C + c : 0;
    stride = (size_t)kRows * C;
  }
};

// The cluster's per-channel totals of acc (and acc2 when kTwo), the same
// in every CTA bit for bit: warp shuffles over the threads of a slot, then
// the CTA's warps in order; with n > 1 CTAs, each CTA's partials go to
// `part` and, after one cluster barrier (which also orders those writes
// before every peer's reads), every CTA adds all ranks' partials in rank
// order through DSMEM. One thread a channel then stores finish(which, ch,
// total) into tot[which * kMaxGroup + ch] (which = 1 for acc2): the
// per-channel scalar math runs once a channel, not in every thread that
// holds the channel.
template <typename T, int V, bool kTwo, typename Finish>
__device__ __forceinline__ void channel_totals(cg::cluster_group& cl,
                                               int n_cl, float* acc,
                                               float* acc2, float* red,
                                               float* part, float* tot,
                                               Finish finish) {
  using R = Resident<T, V>;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int slot = threadIdx.x % R::kLanes;
#pragma unroll
  for (int off = R::kLanes; off < 32; off *= 2) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if constexpr (kTwo)
        acc2[j] += __shfl_xor_sync(0xffffffffu, acc2[j], off);
    }
  }
  if (lane < R::kLanes) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[warp * kMaxGroup + slot * V + j] = acc[j];
      if constexpr (kTwo)
        red[(kWarps + warp) * kMaxGroup + slot * V + j] = acc2[j];
    }
  }
  __syncthreads();
  const int which = threadIdx.x / kMaxGroup, ch = threadIdx.x % kMaxGroup;
  const bool mine = which < (kTwo ? 2 : 1) && ch < R::kGroup;
  const int i = which * kMaxGroup + ch;
  if (mine) {
    const float* r = red + which * kWarps * kMaxGroup + ch;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += r[w * kMaxGroup];
    if (n_cl > 1) part[i] = s;
    else tot[i] = finish(which, ch, s);
  }
  if (n_cl > 1) {
    cl.sync();
    if (mine) {
      float s = 0.0f;
      for (int q = 0; q < n_cl; ++q) s += *cl.map_shared_rank(part + i, q);
      tot[i] = finish(which, ch, s);
    }
  }
  __syncthreads();
}

// Copy the thread's packs of `src` (and `src2`) into slab (and slab2),
// run before() (the per-channel loads, whose latency then overlaps the
// copies'), and call take(k) on each pack once it has landed: 16-byte
// cp.async in kStages commit groups where V > 1, plain loads and stores
// for single elements.
template <typename T, int V, bool kTwo, typename Before, typename Take>
__device__ __forceinline__ void load_slab(const Resident<T, V>& R,
                                          const T* src, const T* src2,
                                          Pack<T, V>* slab, Pack<T, V>* slab2,
                                          Before before, Take take) {
  using P = Pack<T, V>;
  const int t = threadIdx.x;
  if constexpr (V > 1) {
    const int per = (R.packs + kStages - 1) / kStages;
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int k1 = min(R.packs, (s + 1) * per);
      for (int k = s * per; k < k1; ++k) {
        cp_async16(&slab[k * kThreads + t], src + k * R.stride);
        if constexpr (kTwo)
          cp_async16(&slab2[k * kThreads + t], src2 + k * R.stride);
      }
      dl4j_lstm::cp_async_commit();
    }
    before();
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      cp_async_wait_stage(s);
      const int k1 = min(R.packs, (s + 1) * per);
      for (int k = s * per; k < k1; ++k) take(k);
    }
  } else {
    before();
#pragma unroll 4
    for (int k = 0; k < R.packs; ++k) {
      slab[k * kThreads + t] = *reinterpret_cast<const P*>(src + k * R.stride);
      if constexpr (kTwo)
        slab2[k * kThreads + t] =
            *reinterpret_cast<const P*>(src2 + k * R.stride);
      take(k);
    }
  }
}

// Grid: n * ceil(C / kGroup) CTAs along x, clusters of n along x (rank =
// blockIdx.x % n); `rows` rows a CTA, rows * n >= N.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_fwd_resident_kernel(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            T* __restrict__ y, float* __restrict__ mean_out,
                            float* __restrict__ var_out, int N, int C,
                            int rows, int n_cl, float eps) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* part = red + 2 * kWarps * kMaxGroup;
  float* tot = part + 2 * kMaxGroup;
  P* slab = reinterpret_cast<P*>(smem + kScratchBytes);
  cg::cluster_group cl = cg::this_cluster();
  const Resident<T, V> R(N, C, rows, n_cl);
  const int t = threadIdx.x;
  const float n = (float)N;
  // pass 1: the mean, summed as the slab lands (gamma and beta loaded
  // meanwhile)
  float acc[V], g[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  load_slab<T, V, false>(
      R, x + R.first, nullptr, slab, nullptr,
      [&] {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          g[j] = R.live ? gamma[R.c + j] : 0.0f;
          b[j] = R.live ? beta[R.c + j] : 0.0f;
        }
      },
      [&](int k) {
        const P p = slab[k * kThreads + t];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += to_f32(p.v[j]);
      });
  // tot[0, kGroup) = mean; rank 0 writes it out
  channel_totals<T, V, false>(
      cl, n_cl, acc, nullptr, red, part, tot, [&](int, int ch, float s) {
        const int c = R.c0 + ch;
        if (c >= C) return 0.0f;
        const float m = __fdiv_rn(s, n);
        if (R.rank == 0) mean_out[c] = m;
        return m;
      });
  float mean[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = tot[R.slot * V + j];

  // pass 2: the centred variance, from the resident slab
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  for (int k = 0; k < R.packs; ++k) {
    const P p = slab[k * kThreads + t];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = __fsub_rn(to_f32(p.v[j]), mean[j]);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
    }
  }
  // tot[kMaxGroup, kMaxGroup + kGroup) = 1 / sqrt(var + eps); rank 0
  // writes var out
  channel_totals<T, V, false>(
      cl, n_cl, acc, nullptr, red, part + kMaxGroup, tot + kMaxGroup,
      [&](int, int ch, float s) {
        const int c = R.c0 + ch;
        if (c >= C) return 0.0f;
        const float var = __fdiv_rn(s, n);
        if (R.rank == 0) var_out[c] = var;
        return __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
      });
  if (n_cl > 1) cluster_arrive();   // this CTA's DSMEM reads are done
  float inv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) inv[j] = tot[kMaxGroup + R.slot * V + j];

  // pass 3: y = max((x - mean) * inv * gamma + beta, 0) from the slab
  T* dst = y + R.first;
  for (int k = 0; k < R.packs; ++k) {
    const P p = slab[k * kThreads + t];
    P q;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = __fmul_rn(__fsub_rn(to_f32(p.v[j]), mean[j]), inv[j]);
      v = __fadd_rn(__fmul_rn(v, g[j]), b[j]);
      q.v[j] = from_f32<T>(v < 0.0f ? 0.0f : v);   // NaN passes, as relu
    }
    *reinterpret_cast<P*>(dst + k * R.stride) = q;
  }
  if (n_cl > 1) cluster_wait();   // no peer reads this CTA's part any more
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_resident_kernel(const T* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ mean_in,
                            const float* __restrict__ var_in,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ dg_out,
                            float* __restrict__ db_out, int N, int C,
                            int rows, int n_cl, float eps) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* part = red + 2 * kWarps * kMaxGroup;
  float* tot = part + 2 * kMaxGroup;
  P* sx = reinterpret_cast<P*>(smem + kScratchBytes);
  P* sd = reinterpret_cast<P*>(smem + kScratchBytes + slab_bytes(rows));
  cg::cluster_group cl = cg::this_cluster();
  const Resident<T, V> R(N, C, rows, n_cl);
  const int t = threadIdx.x;
  const float n = (float)N;

  // pass 1, as the slabs land (the per-channel vectors loaded meanwhile):
  // dg = sum(dyr * xhat), db = sum(dyr), the ReLU mask recomputed
  float mean[V], inv[V], g[V], b[V], sg[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sb[j] = 0.0f;
  load_slab<T, V, true>(R, x + R.first, dy + R.first, sx, sd, [&] {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = R.live ? R.c + j : 0;
      mean[j] = mean_in[c];
      inv[j] = __frcp_rn(__fsqrt_rn(__fadd_rn(var_in[c], eps)));
      g[j] = gamma[c];
      b[j] = beta[c];
    }
  }, [&](int k) {
    const P px = sx[k * kThreads + t];
    const P pd = sd[k * kThreads + t];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = __fmul_rn(__fsub_rn(to_f32(px.v[j]), mean[j]), inv[j]);
      const float pre = __fadd_rn(__fmul_rn(xh, g[j]), b[j]);
      const float d = pre > 0.0f ? to_f32(pd.v[j]) : 0.0f;
      sg[j] = __fadd_rn(sg[j], __fmul_rn(d, xh));
      sb[j] += d;
    }
  });
  // tot = dg | db; rank 0 writes them out
  channel_totals<T, V, true>(
      cl, n_cl, sg, sb, red, part, tot, [&](int which, int ch, float s) {
        const int c = R.c0 + ch;
        if (R.rank == 0 && c < C) (which ? db_out : dg_out)[c] = s;
        return s;
      });
  if (n_cl > 1) cluster_arrive();   // this CTA's DSMEM reads are done
  float k_[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sg[j] = tot[R.slot * V + j];
    sb[j] = tot[kMaxGroup + R.slot * V + j];
    k_[j] = __fdiv_rn(__fmul_rn(g[j], inv[j]), n);
  }

  // pass 2: dx = (gamma * inv / n) * (n * dyr - db - xhat * dg), from the
  // slabs
  T* dst = dx + R.first;
  for (int k = 0; k < R.packs; ++k) {
    const P px = sx[k * kThreads + t];
    const P pd = sd[k * kThreads + t];
    P q;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = __fmul_rn(__fsub_rn(to_f32(px.v[j]), mean[j]), inv[j]);
      const float pre = __fadd_rn(__fmul_rn(xh, g[j]), b[j]);
      const float d = pre > 0.0f ? to_f32(pd.v[j]) : 0.0f;
      const float v = __fsub_rn(__fsub_rn(__fmul_rn(n, d), sb[j]),
                                __fmul_rn(xh, sg[j]));
      q.v[j] = from_f32<T>(__fmul_rn(k_[j], v));
    }
    *reinterpret_cast<P*>(dst + k * R.stride) = q;
  }
  if (n_cl > 1) cluster_wait();   // no peer reads this CTA's part any more
}

// A plan the resident kernels take: kernels/bn_relu.py:bn_plan's.
bool bad_resident(int N, int C, int rows, int n_cl, int group, bool backward) {
  if (N < 1 || C < 1 || rows < 1 || n_cl < 1 || n_cl > kMaxCluster)
    return true;
  if ((long long)rows * n_cl < N) return true;
  if ((long long)(C + group - 1) / group * n_cl > 2147483647LL) return true;
  return resident_bytes(rows, backward) > dl4j_lstm::kMaxSharedBytes;
}

// Launch a resident kernel: one plain launch for n = 1, else clusters of
// n along x. The shared-memory limit is raised once per device and size
// (dl4j_lstm::grant_smem).
template <typename... KArgs, typename... Args>
int launch_resident(void (*kernel)(KArgs...), std::atomic<size_t>* granted,
                    int n_cl, int groups, size_t bytes, void* stream,
                    Args... args) {
  cudaError_t e = dl4j_lstm::grant_smem(kernel, bytes, granted);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_cl == 1) {
    kernel<<<groups, kThreads, bytes, s>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * n_cl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_fwd_resident(const void* x, const float* gamma, const float* beta,
                        void* y, float* mean, float* var, int N, int C,
                        int rows, int n_cl, float eps, void* stream) {
  static std::atomic<size_t> granted[dl4j_lstm::kMaxDevices];
  constexpr int G = Resident<T, V>::kGroup;
  if (bad_resident(N, C, rows, n_cl, G, false))
    return (int)cudaErrorInvalidValue;
  return launch_resident(&bn_relu_fwd_resident_kernel<T, V>, granted, n_cl,
                         (C + G - 1) / G, (size_t)resident_bytes(rows, false),
                         stream, static_cast<const T*>(x), gamma, beta,
                         static_cast<T*>(y), mean, var, N, C, rows, n_cl,
                         eps);
}

template <typename T, int V>
int launch_bwd_resident(const void* x, const float* gamma, const float* beta,
                        const float* mean, const float* var, const void* dy,
                        void* dx, float* dg, float* db, int N, int C,
                        int rows, int n_cl, float eps, void* stream) {
  static std::atomic<size_t> granted[dl4j_lstm::kMaxDevices];
  constexpr int G = Resident<T, V>::kGroup;
  if (bad_resident(N, C, rows, n_cl, G, true))
    return (int)cudaErrorInvalidValue;
  return launch_resident(&bn_relu_bwd_resident_kernel<T, V>, granted, n_cl,
                         (C + G - 1) / G, (size_t)resident_bytes(rows, true),
                         stream, static_cast<const T*>(x), gamma, beta, mean,
                         var, static_cast<const T*>(dy), static_cast<T*>(dx),
                         dg, db, N, C, rows, n_cl, eps);
}


// ---- "streamed" launches ----
template <typename T, int V>
int launch_streamed_fwd(const void* x, const float* gamma, const float* beta,
                        void* y, float* mean, float* var, int N, int C,
                        float eps, void* stream) {
  const int blocks = (C + kChannels - 1) / kChannels;
  bn_relu_fwd_kernel<T, V><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mean, var, N,
      C, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_streamed_bwd(const void* x, const float* gamma, const float* beta,
                        const float* mean, const float* var, const void* dy,
                        void* dx, float* dg, float* db, int N, int C,
                        float eps, void* stream) {
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
#define DL4J_FWD(k, T, V)                                                    \
  case k:                                                                    \
    return launch_streamed_fwd<T, V>(x, gamma, beta, y, mean, var, N, C,     \
                                     eps, stream);
    DL4J_FWD(0, float, 1) DL4J_FWD(1, float, 4)
    DL4J_FWD(2, __nv_bfloat16, 1) DL4J_FWD(3, __nv_bfloat16, 8)
    DL4J_FWD(4, __half, 1) DL4J_FWD(5, __half, 8)
#undef DL4J_FWD
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dl4j_bn_relu_bwd(const void* x, const float* gamma,
                                const float* beta, const float* mean,
                                const float* var, const void* dy, void* dx,
                                float* dg, float* db, int N, int C, float eps,
                                int dtype, int wide, void* stream) {
  switch (dtype * 2 + (wide ? 1 : 0)) {
#define DL4J_BWD(k, T, V)                                                    \
  case k:                                                                    \
    return launch_streamed_bwd<T, V>(x, gamma, beta, mean, var, dy, dx, dg,  \
                                     db, N, C, eps, stream);
    DL4J_BWD(0, float, 1) DL4J_BWD(1, float, 4)
    DL4J_BWD(2, __nv_bfloat16, 1) DL4J_BWD(3, __nv_bfloat16, 8)
    DL4J_BWD(4, __half, 1) DL4J_BWD(5, __half, 8)
#undef DL4J_BWD
    default: return (int)cudaErrorInvalidValue;
  }
}

// The resident variant: `rows` rows a CTA, clusters of n_cl CTAs splitting
// N (kernels/bn_relu.py:bn_plan). dtype and wide as above; wide = 0 takes
// single-element copies (plain loads) instead of 16-byte cp.async.
extern "C" int dl4j_bn_relu_fwd_resident(const void* x, const float* gamma,
                                         const float* beta, void* y,
                                         float* mean, float* var, int N,
                                         int C, int rows, int n_cl,
                                         float eps, int dtype, int wide,
                                         void* stream) {
  switch (dtype * 2 + (wide ? 1 : 0)) {
#define DL4J_FWD(k, T, V)                                                    \
  case k:                                                                    \
    return launch_fwd_resident<T, V>(x, gamma, beta, y, mean, var, N, C,     \
                                     rows, n_cl, eps, stream);
    DL4J_FWD(0, float, 1) DL4J_FWD(1, float, 4)
    DL4J_FWD(2, __nv_bfloat16, 1) DL4J_FWD(3, __nv_bfloat16, 8)
    DL4J_FWD(4, __half, 1) DL4J_FWD(5, __half, 8)
#undef DL4J_FWD
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dl4j_bn_relu_bwd_resident(const void* x, const float* gamma,
                                         const float* beta,
                                         const float* mean, const float* var,
                                         const void* dy, void* dx, float* dg,
                                         float* db, int N, int C, int rows,
                                         int n_cl, float eps, int dtype,
                                         int wide, void* stream) {
  switch (dtype * 2 + (wide ? 1 : 0)) {
#define DL4J_BWD(k, T, V)                                                    \
  case k:                                                                    \
    return launch_bwd_resident<T, V>(x, gamma, beta, mean, var, dy, dx, dg,  \
                                     db, N, C, rows, n_cl, eps, stream);
    DL4J_BWD(0, float, 1) DL4J_BWD(1, float, 4)
    DL4J_BWD(2, __nv_bfloat16, 1) DL4J_BWD(3, __nv_bfloat16, 8)
    DL4J_BWD(4, __half, 1) DL4J_BWD(5, __half, 8)
#undef DL4J_BWD
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory of one CTA, in bytes, as the kernels take it: the resident
// kernels' dynamic carve-up for `rows` rows (resident = 1), or the streamed
// kernels' static arrays (resident = 0; rows unused), or a negative CUDA
// error. kernels/bn_relu.py:bn_plan must agree.
extern "C" long long dl4j_bn_relu_plan_bytes(int resident, int rows,
                                             int backward) {
  if (resident) return resident_bytes(rows, backward != 0);
  cudaFuncAttributes a;
  const cudaError_t e =
      backward
          ? cudaFuncGetAttributes(&a, bn_relu_bwd_kernel<__nv_bfloat16, 8>)
          : cudaFuncGetAttributes(&a, bn_relu_fwd_kernel<__nv_bfloat16, 8>);
  return e == cudaSuccess ? (long long)a.sharedSizeBytes : -(long long)e;
}
