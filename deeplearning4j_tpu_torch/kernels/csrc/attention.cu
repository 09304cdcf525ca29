// Flash attention for Hopper (sm_90a): softmax attention over [B, T, H, Dh]
// query and [B, S, H, Dh] key/value tensors, every head in one launch,
// forward and backward, in float32, bfloat16 or float16 (q, k, v, o and do
// all of one type), head dimensions up to 256. Three kernels:
//
//   flash_fwd_kernel<T, kLse, R, C, NV>  the forward; with kLse it also
//                                        writes the per-row logsumexp the
//                                        backward reads
//   flash_bwd_dq_kernel<T, NC, RB>       dq, and D = rowsum(do * o) on the
//                                        way
//   flash_bwd_dkv_kernel<T, NC, RB>      dk and dv
//
// They replace the TPU kernels of deeplearning4j_tpu/kernels/attention.py:
// `_make_kernel` through `_flash_fwd_impl`'s pl.pallas_call (kLse = false
// is its primal mode, emit_lse=False; kLse = true is emit_lse=True, what
// `_flash_fwd` runs under jax.grad), and `_make_dq_kernel` /
// `_make_dkv_kernel` through `_flash_bwd_impl`'s two pallas_calls. Same
// math per (batch, head):
//
//   s   = (q @ k^T) * sm_scale, masked to -inf where kv >= S (ragged tail)
//         or, when causal, where kv > q (top-left diagonal)
//   forward: online softmax over kv tiles: running row max m, row sum l and
//   an f32 accumulator; a -inf running max counts as 0 (m_safe) and its
//   correction factor as 0, exactly as the TPU kernel does
//   out = acc / max(l, 1e-30),  L = m_safe + log(max(l, 1e-30))
//   backward (`_bwd_masks`: q < T, kv < S and, causal, kv <= q):
//   p  = exp(s - L) masked to 0,  D = rowsum(do * o)
//   ds = p * (do @ v^T - D) * sm_scale
//   dq = ds @ k,  dk = ds^T @ q,  dv = p^T @ do
//
// Types, as the TPU kernels' `preferred_element_type=jnp.float32`: every
// input is converted to f32 as it is read, all arithmetic is f32, and o,
// dq, dk and dv are written in the inputs' type. The logsumexp and D are
// f32 [B, H, T] (row (b * H + h) * T + t): one float per query row, where
// the TPU kernel keeps a lane-replicated [B, Tp, 128] block and slices
// lane 0.
//
// What bounds them: operations. At the LM's training shapes (B = 64, H = 6,
// T = S = 256, Dh = 64, causal: 32,896 live (q, kv) pairs per (b, h)) the
// forward does 4 Dh FLOPs per live pair (3.2 GFLOP), dq 6 Dh (4.9 GFLOP:
// s, do v^T, ds k) and dk/dv 8 Dh (6.5 GFLOP: s, do v^T, p^T do, ds^T q),
// against about 126 MB of f32 q/k/v/o/do, so each is above the float32
// ridge of the card (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). The
// arithmetic runs on the CUDA cores in f32: TF32 tensor-core products keep
// about three decimal digits, too few for the comparison of the trained
// model with the CPU. bf16 inputs take the same f32 path (correct, not
// fast); a bf16 wgmma design is later work.
//
// The forward (redesigned): what held the first design back was shared-
// memory traffic (12 scalar loads per 32 FMAs in q k^T), synchronous K/V
// loads, and 24 blocks on 132 SMs at one sequence. Now:
//   * 256 threads as 16 row groups (ty) x 16 lanes (tx): a thread owns R
//     query rows (ty + 16 i), C kv columns of the score tile (tx + 16 c)
//     and NV packs of 4 output columns (4 (tx + 16 n)). A tile is BQ = 16 R
//     queries by BK = 16 C keys. Q, K and V sit row-major in shared memory
//     in the input type, rows padded so that a row stride in 4-element
//     packs is odd: the 8 (f32, 16-byte reads) or 16 (2-byte types, 8-byte
//     reads) lanes of one shared-memory phase read 8 or 16 neighbouring K
//     rows on distinct banks, and Q is a broadcast. Every operand is read
//     as a pack of 4 along the head dimension, so q k^T does R C 4 FMAs per
//     R + C pack loads (R = C = 4: 64 per 8), and p v the same.
//   * K/V tiles are double-buffered with cp.async (16 bytes a copy for f32,
//     8 for 2-byte types, zero-filled past S): tile j + 1 is in flight while
//     tile j is computed. Rows whose packs are not aligned (a head
//     dimension not a multiple of 4, or an unaligned pointer) are copied
//     element by element instead, with the same tile order.
//   * Base-2 softmax: log2 e is folded into the scale, exp2f throughout,
//     and L is turned back to the natural log on write (m_safe ln 2 +
//     log(max(l, 1e-30))), so the backward, the plain version and the JAX
//     contract are unchanged.
//   * P goes through shared memory once per tile (the thread that owns a
//     probability is not the one that needs it in p v on the CUDA cores),
//     written as scalars on distinct banks and read back as packs of 4.
//   * The q-tile height is picked at launch: BQ = 64 where that gives at
//     least two blocks per SM, else 32 or 16, so a bucket of one sequence
//     spreads over 96 blocks instead of 24. q-tile indices run in reverse
//     so the longest causal rows start first; the causal loop stops at the
//     diagonal, so dead tiles are never loaded (the TPU kernel's `live`).
//   * Head dimensions up to 64, 128 and 256 take NV = 1, 2 and 4; above 128
//     the key tile is 32 rows and the query tile at most 32, so f32 tiles
//     fit the 227 KB a block may use (172,544 bytes at Dh = 256).
//
// The backward (the PR 4 design, now typed and up to Dh = 256):
//   * Tiles of 64 rows. The dq grid is (ceil(T / BQ), B * H): a block owns a
//     q tile of one (batch, head) and loops over kv tiles, stopping at the
//     causal diagonal. The dk/dv grid is (ceil(S / BK), B * H), kv-major as
//     the TPU's second grid: a block owns a kv tile and loops over q tiles
//     from the diagonal on. The TPU's sequential grid axis that carried the
//     accumulators in VMEM becomes this loop, and the accumulators live in
//     registers.
//   * No atomics: every output element is summed by one thread of one
//     block in a fixed order, so the gradients are the same run to run.
//     dk/dv recompute s and do v^T rather than share them with dq, as the
//     TPU kernel's two grids do.
//   * 128 threads as a 16 x 8 grid: a thread owns RB rows (ty + 16 i) and 8
//     columns (tx + 8 j) of the score tile, and the same RB rows times Dh / 8
//     columns (tx + 8 c) of its accumulators. The 8 threads that share a
//     row are 8 neighbouring lanes of one warp.
//   * Tiles are converted to f32 as they are staged, in dynamic shared
//     memory with rows padded to an odd stride (8 NC + 1, the padding
//     columns zero), so a warp's column reads hit distinct banks. The own
//     tile is 16 RB rows: RB = 4 (64 rows) up to Dh = 128, where the four
//     [64][8 NC + 1] tiles plus the probability tiles take 150,784 bytes
//     (dq) and 169,472 bytes (dk/dv); RB = 2 (32 rows) above, where 64-row
//     own tiles would need 263 KB: 206,720 and 216,320 bytes at Dh = 256.
//     Above 48 KB a launch first raises the kernel's limit with
//     cudaFuncSetAttribute (a block may use 232,448 bytes).
//   * D = rowsum(do * o) is folded into the dq kernel's preamble (a warp
//     per row, lanes over Dh) and written out for the dk/dv kernel, which
//     runs after it on the same stream.
//
// q/k/v/o/do and the gradients are read and written with their row stride
// (H * Dh for the layer's contiguous [B, T, H, Dh] projections), so no head
// transpose or copy is needed around the launches.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point takes the element type as a code (0 float32, 1 bfloat16, 2
// float16), launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // backward: rows of the looped-over q tile
constexpr int BK = 64;        // backward: rows of the looped-over kv tile
constexpr int NTHREADS = 128; // backward
constexpr int PS = BK + 8;    // backward probability-tile row stride
constexpr int kFwdThreads = 256;
constexpr int TX = 16;        // forward: lanes that share a query row
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

// ---- cp.async ---------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy kBytes (16 or 8) from global to shared memory asynchronously; when
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

__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_max16(float v) {
  v = row_max8(v);
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
}

__device__ __forceinline__ float row_sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v + __shfl_xor_sync(0xffffffffu, v, 8);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// The forward's padded head dimension (a multiple of 4) and its shared-
// memory row stride in elements: a multiple of 4 whose count of packs is
// odd, so neighbouring rows start on other banks.
__host__ __device__ __forceinline__ int fwd_dpad(int Dh) {
  return (Dh + 3) & ~3;
}
__host__ __device__ __forceinline__ int fwd_stride(int Dh) {
  const int dpad = fwd_dpad(Dh);
  return dpad + ((dpad & 7) == 0 ? 4 : 0);
}

// Stage rows [r0, r0 + rows) of a source with n rows of Dh elements (row
// stride ld) into a shared tile with row stride DP. `vec`: one cp.async per
// pack of 4 elements, zero-filled past n. Otherwise element by element,
// zero-filled past n and in the columns [Dh, Dpad).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0,
                                           int rows, int n, long long ld,
                                           int Dh, int DP, bool vec) {
  const int dpad = fwd_dpad(Dh);
  if (vec) {
    const int packs = dpad >> 2;
    for (int e = threadIdx.x; e < rows * packs; e += kFwdThreads) {
      const int r = e / packs;
      const int c = (e - r * packs) << 2;
      const int t = r0 + r;
      const bool ok = t < n;
      cp_async<4 * sizeof(T)>(dst + r * DP + c, ok ? src + t * ld + c : src,
                              ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * dpad; e += kFwdThreads) {
      const int r = e / dpad;
      const int c = e - r * dpad;
      const int t = r0 + r;
      dst[r * DP + c] =
          (t < n && c < Dh) ? src[t * ld + c] : from_f32<T>(0.0f);
    }
  }
}

// The forward for one query tile of BQ = 16 R rows of one (batch, head),
// looping over key tiles of BK = 16 C rows. The head dimension is at most
// 64 NV. kLse: also write the row logsumexp to lse[(b * H + h) * T + t].
// The primal instantiation never touches `lse` (the last parameter, so the
// others keep their places). scale2 = sm_scale * log2 e.
template <typename T, bool kLse, int R, int C, int NV>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Tq, int S,
                 int H, int Dh, long long ldq, long long ldk, long long ldv,
                 long long ldo, int causal, float scale2, int vec,
                 float* __restrict__ lse) {
  constexpr int TBQ = 16 * R;
  constexpr int TBK = TX * C;
  constexpr int TPS = TBK + 16;   // P row stride: 2 rows x 16 lanes on
                                  // distinct banks
  const int dpad = fwd_dpad(Dh);
  const int DP = fwd_stride(Dh);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [TBQ][DP]
  T* Ks = Qs + TBQ * DP;                    // [2][TBK][DP]
  T* Vs = Ks + 2 * TBK * DP;                // [2][TBK][DP]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * TBK * DP);   // [TBQ][TPS]

  const int tid = threadIdx.x;
  const int tx = tid & (TX - 1);
  const int ty = tid / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const T* qb = q + (long long)b * Tq * ldq + (long long)h * Dh;
  const T* kb = k + (long long)b * S * ldk + (long long)h * Dh;
  const T* vb = v + (long long)b * S * ldv + (long long)h * Dh;
  T* ob = o + (long long)b * Tq * ldo + (long long)h * Dh;

  int n_tiles = (S + TBK - 1) / TBK;
  if (causal) n_tiles = min(n_tiles, (q0 + TBQ - 1) / TBK + 1);

  stage_rows(Qs, qb, q0, TBQ, Tq, ldq, Dh, DP, vec);
  stage_rows(Ks, kb, 0, TBK, S, ldk, Dh, DP, vec);
  stage_rows(Vs, vb, 0, TBK, S, ldv, Dh, DP, vec);
  cp_async_commit();

  float m[R], l[R], acc[R][NV][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
  }

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < n_tiles) {   // the next tile into the other buffer
      const int nxt = (jt + 1) * TBK;
      stage_rows(Ks + (buf ^ 1) * TBK * DP, kb, nxt, TBK, S, ldk, Dh, DP,
                 vec);
      stage_rows(Vs + (buf ^ 1) * TBK * DP, vb, nxt, TBK, S, ldv, Dh, DP,
                 vec);
    }
    cp_async_commit();
    cp_async_wait<1>();   // everything but the newest group has landed
    __syncthreads();
    const T* Kt = Ks + buf * TBK * DP;
    const T* Vt = Vs + buf * TBK * DP;

    float sc[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) sc[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < dpad; d += 4) {
      float4 qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = ld4(Qs + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = ld4(Kt + (tx + TX * c) * DP + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sc[i][c] = fmaf(qv[i].x, kv[c].x, sc[i][c]);
          sc[i][c] = fmaf(qv[i].y, kv[c].y, sc[i][c]);
          sc[i][c] = fmaf(qv[i].z, kv[c].z, sc[i][c]);
          sc[i][c] = fmaf(qv[i].w, kv[c].w, sc[i][c]);
        }
    }

    const int k0 = jt * TBK;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + 16 * i;
      const int tq = q0 + row;
      bool ok[C];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int kv_idx = k0 + tx + TX * c;
        ok[c] = kv_idx < S && (!causal || kv_idx <= tq);
        sc[i][c] = ok[c] ? sc[i][c] * scale2 : -INFINITY;
        mx = fmaxf(mx, sc[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = ok[c] ? exp2f(sc[i][c] - m_safe) : 0.0f;
        Ps[row * TPS + tx + TX * c] = p;
        rs += p;
      }
      const float corr = m[i] == -INFINITY ? 0.0f : exp2f(m[i] - m_safe);
      m[i] = m_new;
      l[i] = l[i] * corr + row_sum16(rs);
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int s = 0; s < TBK; s += 4) {
      float pv[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * TPS + s);
        pv[i][0] = p4.x;
        pv[i][1] = p4.y;
        pv[i][2] = p4.z;
        pv[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int d0 = 4 * (tx + TX * n);
          if (d0 < dpad) {
            const float4 vv = ld4(Vt + (s + u) * DP + d0);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc[i][n][0] = fmaf(pv[i][u], vv.x, acc[i][n][0]);
              acc[i][n][1] = fmaf(pv[i][u], vv.y, acc[i][n][1]);
              acc[i][n][2] = fmaf(pv[i][u], vv.z, acc[i][n][2]);
              acc[i][n][3] = fmaf(pv[i][u], vv.w, acc[i][n][3]);
            }
          }
        }
      }
    }
    __syncthreads();   // every reader is done with this buffer and Ps
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + TX * n) + e;
        if (d < Dh) ob[t * ldo + d] = from_f32<T>(acc[i][n][e] / denom);
      }
    }
    if constexpr (kLse) {
      // the 16 lanes of a row hold the same m and l; m is in base 2
      if (tx == 0) {
        const float m_safe = m[i] == -INFINITY ? 0.0f : m[i];
        lse[(long long)blockIdx.y * Tq + t] = m_safe * kLn2 + logf(denom);
      }
    }
  }
}

// Rows [r0, r0 + rows) of a row-major tile source (row stride ld, head
// offset applied) into shared memory as f32 with row stride DP = 8 NC + 1:
// rows >= n and columns >= Dh are zero (the padding column 8 NC is never
// read).
template <int NC, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int rows, int n, long long ld,
                                          int Dh) {
  constexpr int DP = 8 * NC + 1;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NTHREADS / 32) {
    const int t = r0 + r;
    for (int d = lane; d < 8 * NC; d += 32)
      dst[r * DP + d] = (t < n && d < Dh) ? to_f32(src[t * ld + d]) : 0.0f;
  }
}

// dq (and D) for one q tile of 16 RB rows of one (batch, head), looping
// over 64-row kv tiles up to the causal diagonal.
template <typename T, int NC, int RB>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ dsum, int Tq, int S, int H, int Dh,
                    long long ld, int causal, float sm_scale) {
  constexpr int DP = 8 * NC + 1;
  constexpr int OWN = 16 * RB;
  extern __shared__ float smem[];
  float* Qs = smem;             // [OWN][DP]
  float* dOs = Qs + OWN * DP;   // [OWN][DP]
  float* Ks = dOs + OWN * DP;   // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][DP]
  float* dSs = Vs + BK * DP;    // [OWN][PS]
  float* Ds = dSs + OWN * PS;   // [OWN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * OWN;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * Tq;

  load_rows<NC>(Qs, q + qoff, q0, OWN, Tq, ld, Dh);
  load_rows<NC>(dOs, dout + qoff, q0, OWN, Tq, ld, Dh);
  __syncthreads();
  // D = rowsum(do * o): a warp per row, lanes over the head dimension
  for (int r = warp; r < OWN; r += NTHREADS / 32) {
    const int t = q0 + r;
    float part = 0.0f;
    if (t < Tq)
      for (int d = lane; d < Dh; d += 32)
        part = fmaf(dOs[r * DP + d], to_f32(o[qoff + t * ld + d]), part);
    part = warp_sum(part);
    if (lane == 0) {
      Ds[r] = part;
      if (t < Tq) dsum[roff + t] = part;
    }
  }
  __syncthreads();

  float Lr[RB], Dr[RB], acc[RB][NC];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int t = q0 + ty + 16 * i;
    Lr[i] = t < Tq ? lse[roff + t] : 0.0f;
    Dr[i] = Ds[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + OWN - 1) / BK + 1);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the last tile's readers are done with Ks/Vs/dSs
    load_rows<NC>(Ks, k + koff, k0, BK, S, ld, Dh);
    load_rows<NC>(Vs, v + koff, k0, BK, S, ld, Dh);
    __syncthreads();

    float sc[RB][8], dp[RB][8];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < Dh; ++d) {
      float qv[RB], gv[RB], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        gv[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(tx + 8 * j) * DP + d];
        vv[j] = Vs[(tx + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int row = ty + 16 * i;
      const int tq = q0 + row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kv_idx = k0 + tx + 8 * j;
        const bool ok = tq < Tq && kv_idx < S && (!causal || kv_idx <= tq);
        const float p = ok ? expf(sc[i][j] * sm_scale - Lr[i]) : 0.0f;
        dSs[row * PS + tx + 8 * j] = p * (dp[i][j] - Dr[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < BK; ++s) {
      float dsv[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) dsv[i] = dSs[(ty + 16 * i) * PS + s];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = Ks[s * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RB; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < Dh) dq[qoff + t * ld + d] = from_f32<T>(acc[i][c]);
    }
  }
}

// dk and dv for one kv tile of 16 RB rows of one (batch, head), looping
// over 64-row q tiles from the causal diagonal on (the TPU kernel's live =
// i bq + bq - 1 >= j bk).
template <typename T, int NC, int RB>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int S, int H, int Dh,
                     long long ld, int causal, float sm_scale) {
  constexpr int DP = 8 * NC + 1;
  constexpr int OWN = 16 * RB;
  extern __shared__ float smem[];
  float* Ks = smem;             // [OWN][DP]
  float* Vs = Ks + OWN * DP;    // [OWN][DP]
  float* Qs = Vs + OWN * DP;    // [BQ][DP]
  float* dOs = Qs + BQ * DP;    // [BQ][DP]
  float* Ps = dOs + BQ * DP;    // [OWN][PS]  p^T
  float* dSs = Ps + OWN * PS;   // [OWN][PS]  ds^T
  float* Ls = dSs + OWN * PS;   // [BQ]
  float* Ds = Ls + BQ;          // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 7;     // q columns tx + 8 j, output columns tx + 8 c
  const int ty = tid >> 3;    // kv rows ty + 16 i
  const int k0 = blockIdx.x * OWN;   // low tiles have the most causal work
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * Tq;

  load_rows<NC>(Ks, k + koff, k0, OWN, S, ld, Dh);
  load_rows<NC>(Vs, v + koff, k0, OWN, S, ld, Dh);

  float gk[RB][NC], gv[RB][NC];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.0f;

  const int n_q = (Tq + BQ - 1) / BQ;
  for (int it = causal ? k0 / BQ : 0; it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last tile's readers are done with Qs/dOs/Ps/...
    load_rows<NC>(Qs, q + qoff, q0, BQ, Tq, ld, Dh);
    load_rows<NC>(dOs, dout + qoff, q0, BQ, Tq, ld, Dh);
    for (int r = tid; r < BQ; r += NTHREADS) {
      const int t = q0 + r;
      Ls[r] = t < Tq ? lse[roff + t] : 0.0f;
      Ds[r] = t < Tq ? dsum[roff + t] : 0.0f;
    }
    __syncthreads();

    float st[RB][8], dpt[RB][8];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < Dh; ++d) {
      float kv[RB], vv[RB], qv[8], gq[8];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        kv[i] = Ks[(ty + 16 * i) * DP + d];
        vv[i] = Vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = Qs[(tx + 8 * j) * DP + d];
        gq[j] = dOs[(tx + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(gq[j], vv[i], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int row = ty + 16 * i;
      const int skv = k0 + row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j;
        const int tq = q0 + col;
        const bool ok = tq < Tq && skv < S && (!causal || skv <= tq);
        const float p = ok ? expf(st[i][j] * sm_scale - Ls[col]) : 0.0f;
        Ps[row * PS + col] = p;
        dSs[row * PS + col] = p * (dpt[i][j] - Ds[col]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BQ; ++t) {
      float pv[RB], dsv[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        pv[i] = Ps[(ty + 16 * i) * PS + t];
        dsv[i] = dSs[(ty + 16 * i) * PS + t];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = dOs[t * DP + tx + 8 * c];
        const float qq = Qs[t * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          gv[i][c] = fmaf(pv[i], g, gv[i][c]);
          gk[i][c] = fmaf(dsv[i], qq, gk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < Dh) {
        dk[koff + s * ld + d] = from_f32<T>(gk[i][c]);
        dv[koff + s * ld + d] = from_f32<T>(gv[i][c]);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// Query rows per thread for the forward: the tallest q tile (16 R rows,
// R <= max_r) that still gives two blocks per SM, else R = 1.
int pick_rows(int Tq, int BH, int max_r) {
  const long long want = 2LL * sm_count();
  for (int r = max_r; r > 1; r >>= 1)
    if ((long long)((Tq + 16 * r - 1) / (16 * r)) * BH >= want) return r;
  return 1;
}

template <typename T>
bool packs_aligned(int Dh, long long ld, const void* p) {
  const uintptr_t a = 4 * sizeof(T);
  return Dh % 4 == 0 && ld % 4 == 0 && (uintptr_t)p % a == 0;
}

template <typename T, bool kLse, int R, int C, int NV>
int launch_fwd_cfg(const T* q, const T* k, const T* v, T* o, float* lse,
                   int B, int Tq, int S, int H, int Dh, long long ldq,
                   long long ldk, long long ldv, long long ldo, int causal,
                   float sm_scale, int vec, cudaStream_t stream) {
  constexpr int TBQ = 16 * R, TBK = TX * C;
  const size_t smem = sizeof(T) * (size_t)(TBQ + 4 * TBK) * fwd_stride(Dh) +
                      sizeof(float) * (size_t)TBQ * (TBK + 16);
  auto kernel = flash_fwd_kernel<T, kLse, R, C, NV>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Tq + TBQ - 1) / TBQ, B * H);
  kernel<<<grid, kFwdThreads, smem, stream>>>(q, k, v, o, Tq, S, H, Dh, ldq,
                                              ldk, ldv, ldo, causal,
                                              sm_scale * kLog2e, vec, lse);
  return (int)cudaGetLastError();
}

template <typename T, bool kLse>
int launch_fwd(const void* q_, const void* k_, const void* v_, void* o_,
               float* lse, int B, int Tq, int S, int H, int Dh,
               long long ldq, long long ldk, long long ldv, long long ldo,
               int causal, float sm_scale, cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* o = static_cast<T*>(o_);
  const int vec = packs_aligned<T>(Dh, ldq, q) &&
                  packs_aligned<T>(Dh, ldk, k) &&
                  packs_aligned<T>(Dh, ldv, v);
#define DL4J_FWD(R, C, NV)                                                    \
  launch_fwd_cfg<T, kLse, R, C, NV>(q, k, v, o, lse, B, Tq, S, H, Dh, ldq,    \
                                    ldk, ldv, ldo, causal, sm_scale, vec, st)
  if (Dh <= 128) {
    const int r = pick_rows(Tq, B * H, 4);
    if (Dh <= 64) {
      if (r == 4) return DL4J_FWD(4, 4, 1);
      if (r == 2) return DL4J_FWD(2, 4, 1);
      return DL4J_FWD(1, 4, 1);
    }
    if (r == 4) return DL4J_FWD(4, 4, 2);
    if (r == 2) return DL4J_FWD(2, 4, 2);
    return DL4J_FWD(1, 4, 2);
  }
  if (pick_rows(Tq, B * H, 2) == 2) return DL4J_FWD(2, 2, 4);
  return DL4J_FWD(1, 2, 4);
#undef DL4J_FWD
}

template <typename T, int NC, int RB>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dq, float* dsum,
              int B, int Tq, int S, int H, int Dh, long long ld, int causal,
              float sm_scale, cudaStream_t stream) {
  constexpr int OWN = 16 * RB;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * OWN + 2 * BK) * (8 * NC + 1) +
                       (size_t)OWN * PS + OWN);
  auto kernel = flash_bwd_dq_kernel<T, NC, RB>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Tq + OWN - 1) / OWN, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), dsum, Tq, S, H,
      Dh, ld, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int NC, int RB>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dsum,
               void* dk, void* dv, int B, int Tq, int S, int H, int Dh,
               long long ld, int causal, float sm_scale,
               cudaStream_t stream) {
  constexpr int OWN = 16 * RB;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * OWN + 2 * BQ) * (8 * NC + 1) +
                       (size_t)2 * OWN * PS + 2 * BQ);
  auto kernel = flash_bwd_dkv_kernel<T, NC, RB>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + OWN - 1) / OWN, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, S, H, Dh, ld, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int T, int S, int H, int Dh) {
  return B < 1 || T < 1 || S < 1 || H < 1 || Dh < 1 || Dh > 256 ||
         B * H > 65535;
}

// The backward instantiation for a head dimension: NC = ceil(Dh / 8)
// rounded up to 1, 2, 4, 8, 16 or 32; 64-row own tiles up to Dh = 128,
// 32-row ones above.
#define DL4J_BY_HEAD_DIM(CALL)       \
  if (Dh <= 8) return CALL(1, 4);    \
  if (Dh <= 16) return CALL(2, 4);   \
  if (Dh <= 32) return CALL(4, 4);   \
  if (Dh <= 64) return CALL(8, 4);   \
  if (Dh <= 128) return CALL(16, 4); \
  return CALL(32, 2);

// The element type for a dtype code: 0 float32, 1 bfloat16, 2 float16.
// Every CALL returns.
#define DL4J_BY_DTYPE(CALL)                       \
  switch (dtype) {                                \
    case 0: CALL(float)                           \
    case 1: CALL(__nv_bfloat16)                   \
    case 2: CALL(__half)                          \
    default: return (int)cudaErrorInvalidValue;   \
  }

}  // namespace

// q [B, T, H, Dh] and o [B, T, H, Dh] with row strides ldq / ldo (elements
// between consecutive t), k / v [B, S, H, Dh] with ldk / ldv; the head
// dimension is contiguous and a batch is T (or S) rows. 1 <= Dh <= 256.
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int T,
                                   int S, int H, int Dh, long long ldq,
                                   long long ldk, long long ldv,
                                   long long ldo, int causal, float sm_scale,
                                   int dtype, void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_FWD(TYPE)                                                     \
  return launch_fwd<TYPE, false>(q, k, v, o, nullptr, B, T, S, H, Dh, ldq, \
                                 ldk, ldv, ldo, causal, sm_scale, st);
  DL4J_BY_DTYPE(DL4J_FWD)
#undef DL4J_FWD
}

// The forward that also writes lse [B, H, T] (f32): what the backward reads.
extern "C" int dl4j_flash_attn_fwd_lse(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int T, int S, int H, int Dh,
                                       long long ld, int causal,
                                       float sm_scale, int dtype,
                                       void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_FWD_LSE(TYPE)                                                \
  return launch_fwd<TYPE, true>(q, k, v, o, lse, B, T, S, H, Dh, ld, ld, \
                                ld, ld, causal, sm_scale, st);
  DL4J_BY_DTYPE(DL4J_FWD_LSE)
#undef DL4J_FWD_LSE
}

// dq [B, T, H, Dh] (in the inputs' type) and dsum = rowsum(do * o)
// [B, H, T] (f32) from q, o, do [B, T, H, Dh], k, v [B, S, H, Dh] and lse
// [B, H, T]; every row stride ld.
extern "C" int dl4j_flash_attn_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const float* lse,
                                      void* dq, float* dsum, int B, int T,
                                      int S, int H, int Dh, long long ld,
                                      int causal, float sm_scale, int dtype,
                                      void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_DQ_NC(NC, RB)                                                  \
  launch_dq<TYPE_, NC, RB>(q, k, v, o, dout, lse, dq, dsum, B, T, S, H, Dh, \
                           ld, causal, sm_scale, st)
#define DL4J_DQ(TYPE) \
  {                   \
    using TYPE_ = TYPE; \
    DL4J_BY_HEAD_DIM(DL4J_DQ_NC) \
  }
  DL4J_BY_DTYPE(DL4J_DQ)
#undef DL4J_DQ
#undef DL4J_DQ_NC
}

// dk, dv [B, S, H, Dh] (in the inputs' type) from q, do [B, T, H, Dh], k, v
// [B, S, H, Dh], lse and dsum [B, H, T]; every row stride ld.
extern "C" int dl4j_flash_attn_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* dsum,
                                       void* dk, void* dv, int B, int T,
                                       int S, int H, int Dh, long long ld,
                                       int causal, float sm_scale, int dtype,
                                       void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_DKV_NC(NC, RB)                                                 \
  launch_dkv<TYPE_, NC, RB>(q, k, v, dout, lse, dsum, dk, dv, B, T, S, H,   \
                            Dh, ld, causal, sm_scale, st)
#define DL4J_DKV(TYPE) \
  {                    \
    using TYPE_ = TYPE; \
    DL4J_BY_HEAD_DIM(DL4J_DKV_NC) \
  }
  DL4J_BY_DTYPE(DL4J_DKV)
#undef DL4J_DKV
#undef DL4J_DKV_NC
}
