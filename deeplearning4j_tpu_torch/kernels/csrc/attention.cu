// Flash attention for Hopper (sm_90a): softmax attention over [B, T, H, Dh]
// query and [B, S, H, Dh] key/value tensors, every head in one launch,
// forward and backward, in float32, bfloat16 or float16 (q, k, v, o and do
// all of one type), at any head dimension. Three files:
//
//   attention.cu         the forward flash_fwd_kernel<T, kLse, R, C, NV>
//                        (Dh <= 256; with kLse it also writes the per-row
//                        logsumexp the backward reads), and the "wide"
//                        kernels for Dh > 256: flash_fwd_wide_kernel,
//                        flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel
//   attention_bwd.cu     the "simt" backward: flash_bwd_dq_simt and
//                        flash_bwd_dkv_simt, on the CUDA cores, any type,
//                        Dh <= 256
//   attention_wgmma.cu   the "wgmma" backward: flash_bwd_dq_wgmma and
//                        flash_bwd_dkv_wgmma, on the tensor cores, bfloat16
//                        and float16 at Dh a multiple of 16 up to 256 with
//                        16-byte aligned rows and pointers
//
// `kernels/attention.py:backward_variant` picks the backward variant from
// the dtype, the head dimension, the row stride and the pointers'
// alignment. They replace the TPU kernels of
// deeplearning4j_tpu/kernels/attention.py: `_make_kernel` through
// `_flash_fwd_impl`'s pl.pallas_call (kLse = false is its primal mode,
// emit_lse=False; kLse = true is emit_lse=True, what `_flash_fwd` runs
// under jax.grad), and `_make_dq_kernel` / `_make_dkv_kernel` through
// `_flash_bwd_impl`'s two pallas_calls. Same math per (batch, head):
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
// product is summed in f32, p and ds are f32, and o, dq, dk and dv are
// written in the inputs' type. The logsumexp and D are f32 [B, H, T] (row
// (b * H + h) * T + t): one float per query row, where the TPU kernel keeps
// a lane-replicated [B, Tp, 128] block and slices lane 0. Every kernel puts
// B * H on gridDim.x (up to 2^31 - 1) and its tiles on gridDim.y; causal
// q-tile walks run in reverse so the longest rows start first. Each kernel
// runs base-2 exponentials (log2 e folded into the scale and into L once
// per row) and tests the mask only on tiles that cross the causal diagonal
// or a ragged tail. No atomics: every output element is summed by one
// thread of one block in a fixed order, so reruns are bit-equal. D =
// rowsum(do * o) is formed in the dq kernel's preamble and written out for
// the dk/dv kernel, which runs after it on the same stream; dk/dv recompute
// s and do v^T rather than share them with dq, as the TPU kernel's two
// grids do.
//
// What bounds them, at the LM's training shape (B = 64, H = 6, T = S = 256,
// Dh = 64, causal: 32,896 live (q, kv) pairs per (b, h)): the forward does
// 4 Dh FLOPs per live pair (3.2 GFLOP), dq 6 Dh (4.9 GFLOP: s, do v^T,
// ds k) and dk/dv 8 Dh (6.5 GFLOP), against 75-126 MB of q/k/v/o/do.
//   * f32: operations (the card's f32 ridge is 20 FLOP/byte). They run on
//     the CUDA cores: TF32 tensor-core products keep about three decimal
//     digits, too few for the trained model's comparison with the CPU.
//   * bf16 / f16 on the tensor cores: bytes (989 TFLOP/s over 3.35 TB/s is
//     295 FLOP/byte; dq and dk/dv do about 90 per byte).
//
// The forward: 256 threads as 16 row groups (ty) x 16 lanes
// (tx); a thread owns R query rows (ty + 16 i), C kv columns of the score
// tile (tx + 16 c) and NV packs of 4 output columns. Q, K and V sit
// row-major in shared memory in the input type, rows padded so that a row
// stride in 4-element packs is odd (neighbouring rows on distinct banks),
// and every operand is read as a pack of 4 along the head dimension (R C 4
// FMAs per R + C pack loads). K/V tiles are double-buffered with cp.async
// (16 bytes a copy for f32, 8 for 2-byte types, zero-filled past S); rows
// whose packs are not aligned are copied element by element in the same
// tile order. P goes through shared memory once per tile. The q-tile
// height is picked at launch (BQ = 64 where that gives two blocks per SM,
// else 32 or 16); Dh up to 64, 128 and 256 takes NV = 1, 2 and 4.
//
// The "simt" backward (attention_bwd.cu) follows the forward: the same
// thread grid, R x C register micro-tiles of the score tile, operands read
// as packs of 4 from rows padded to an odd pack stride, tiles staged in the
// input type through a two-stage cp.async ring over the looped-over axis
// (kv tiles in dq; q, do, L and D tiles in dk/dv) while the block's own
// tile is loaded once, and P and dS through shared memory once per tile.
// Own-tile heights keep two blocks (16 warps) resident on an SM at Dh <=
// 128. What bounds it: the f32 CUDA cores, and shared-memory operand
// traffic (12 pack loads per 64 FMAs in s and do v^T, 8 per 64 in the
// accumulating products).
//
// The "wgmma" backward (attention_wgmma.cu): one consumer warpgroup owns 64
// rows and runs wgmma.mma_async m64n64k16 with f32 accumulators in
// registers; a producer warp keeps TMA loads of the looped-over tiles in
// flight through a two-stage mbarrier ring. Tiles land in the 128-byte
// swizzled layout the matrix descriptors name, as 64-column panels, through
// 4-D tensor maps over [B, T, H, Dh] (a ragged tail and the head columns
// past Dh read zeros). p and ds enter their products as hi + lo pairs in
// the input type (hi = round(x), lo = round(x - hi): two wgmmas, about
// 2^-16 relative), so the kernel keeps the f32 variant's limits. dq: S = Q
// K^T and dP = dO V^T from shared memory, then dQ += dS K with dS as the
// register A operand and K as an MN-major B. dk/dv: S^T = K Q^T and dP^T =
// V dO^T, so P^T and dS^T come out in the accumulator layout and feed dV
// += P^T dO and dK += dS^T Q as register A operands (FlashAttention-3's
// arrangement). Above 64 (dk/dv) or 128 (dq) head columns a block owns one
// slice of the output columns and recomputes the scores. What bounds it:
// the tensor cores issue one warpgroup's chain at a time, so latency
// between the score products, the exponentials and the accumulating
// products; the mbarrier ring hides the loads.
//
// The "wide" kernels (Dh > 256, in this file): a simple path. Each block
// owns 32 rows and a slice of at most 256 output columns (gridDim.z), and
// recomputes the scores it needs over the whole head dimension, streamed
// through shared memory 32 columns at a time as f32; ceil(Dh / 256) blocks
// recompute the same scores. No public configuration has such heads.
//
// q/k/v/o/do and the gradients are read and written with their row stride
// (H * Dh for the layer's contiguous [B, T, H, Dh] projections), so no head
// transpose or copy is needed around the launches.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point takes the element type as a code (0 float32, 1 bfloat16, 2
// float16), launches on the caller's stream and returns cudaGetLastError().

#include "attention_common.cuh"

using namespace dl4j_attn;

namespace {

// The forward for one query tile of BQ = 16 R rows of one (batch, head),
// looping over key tiles of BK = 16 C rows; grid (B * H, q tiles). The
// head dimension is at most 64 NV. kLse: also write the row logsumexp to
// lse[(b * H + h) * T + t]. The primal instantiation never touches `lse`
// (the last parameter, so the others keep their places). scale2 = sm_scale
// * log2 e.
template <typename T, bool kLse, int R, int C, int NV>
__global__ void __launch_bounds__(kThreads)
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
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TBQ;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
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
        lse[(long long)blockIdx.x * Tq + t] = m_safe * kLn2 + logf(denom);
      }
    }
  }
}

// ---- the wide kernels (Dh > 256) -------------------------------------------
constexpr int kWR = 32;     // rows a block owns, and rows of a looped tile
constexpr int kWS = 33;     // row stride of the [32][32] f32 tiles
constexpr int kWOut = 256;  // output columns a block owns (gridDim.z)
// static shared memory of the wide forward, dq and dk/dv kernels
constexpr size_t kWFwdStatic = 3 * sizeof(float) * kWR * kWS;
constexpr size_t kWDqStatic = 5 * sizeof(float) * kWR * kWS;
constexpr size_t kWDkvStatic = sizeof(float) * (6 * kWR * kWS + 2 * kWR);

// Columns [d0, d0 + 32) of rows [r0, r0 + 32) of a source with n rows
// (row stride ld) into a [32][kWS] f32 tile; zero past n and past Dh.
template <typename T>
__device__ __forceinline__ void wide_chunk(float* dst, const T* src, int r0,
                                           int n, long long ld, int d0,
                                           int Dh) {
  for (int e = threadIdx.x; e < kWR * 32; e += kThreads) {
    const int r = e >> 5, c = e & 31, t = r0 + r, d = d0 + c;
    dst[r * kWS + c] = (t < n && d < Dh) ? to_f32(src[t * ld + d]) : 0.0f;
  }
}

// The block's output columns [oc0, oc0 + kWOut) of rows [r0, r0 + 32) into
// a [32][kWOut] f32 slab; zero past n and past Dh.
template <typename T>
__device__ __forceinline__ void wide_slab(float* dst, const T* src, int r0,
                                          int n, long long ld, int oc0,
                                          int Dh) {
  for (int e = threadIdx.x; e < kWR * kWOut; e += kThreads) {
    const int r = e / kWOut, c = e % kWOut, t = r0 + r, d = oc0 + c;
    dst[e] = (t < n && d < Dh) ? to_f32(src[t * ld + d]) : 0.0f;
  }
}

// The forward at any head dimension: a thread owns row r = tid / 8 of a
// 32-row q tile, score columns l + 8 c (l = tid % 8) and output columns
// oc0 + l + 8 j of the block's slice. scale2 = sm_scale * log2 e.
template <typename T, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int Tq, int S, int H, int Dh,
                      long long ld, int causal, float scale2) {
  __shared__ float Qc[kWR * kWS], Kc[kWR * kWS], Ps[kWR * kWS];
  extern __shared__ float slab[];   // [32][kWOut] of V
  const int r = threadIdx.x >> 3, l = threadIdx.x & 7;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWR;
  const int oc0 = blockIdx.z * kWOut;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const int tq = q0 + r;
  int n_tiles = (S + kWR - 1) / kWR;
  if (causal) n_tiles = min(n_tiles, (q0 + kWR - 1) / kWR + 1);

  float m = -INFINITY, lsum = 0.0f, acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kWR;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d0 = 0; d0 < Dh; d0 += 32) {
      __syncthreads();   // the last readers of Qc/Kc (and Ps, slab) are done
      wide_chunk(Qc, q + qoff, q0, Tq, ld, d0, Dh);
      wide_chunk(Kc, k + koff, k0, S, ld, d0, Dh);
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < 32; ++dd) {
        const float qv = Qc[r * kWS + dd];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[c] = fmaf(qv, Kc[(l + 8 * c) * kWS + dd], s[c]);
      }
    }
    bool ok[4];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kv = k0 + l + 8 * c;
      ok[c] = kv < S && (!causal || kv <= tq);
      s[c] = ok[c] ? s[c] * scale2 : -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    const float m_new = fmaxf(m, row_max8(mx));
    const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
    float rs = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = ok[c] ? exp2f(s[c] - m_safe) : 0.0f;
      Ps[r * kWS + l + 8 * c] = p;
      rs += p;
    }
    const float corr = m == -INFINITY ? 0.0f : exp2f(m - m_safe);
    m = m_new;
    lsum = lsum * corr + row_sum8(rs);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] *= corr;
    wide_slab(slab, v + koff, k0, S, ld, oc0, Dh);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kWR; ++t) {
      const float pv = Ps[r * kWS + t];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        acc[j] = fmaf(pv, slab[t * kWOut + l + 8 * j], acc[j]);
    }
  }
  if (tq >= Tq) return;
  const float denom = fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int d = oc0 + l + 8 * j;
    if (d < Dh) o[qoff + tq * ld + d] = from_f32<T>(acc[j] / denom);
  }
  if constexpr (kLse) {
    if (blockIdx.z == 0 && l == 0) {
      const float m_safe = m == -INFINITY ? 0.0f : m;
      lse[(long long)bh * Tq + tq] = m_safe * kLn2 + logf(denom);
    }
  }
}

// dq (and D) at any head dimension: rows as the wide forward; D over the
// whole head (written by the first column slice).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse, T* __restrict__ dq,
                         float* __restrict__ dsum, int Tq, int S, int H,
                         int Dh, long long ld, int causal, float sm_scale) {
  __shared__ float Qc[kWR * kWS], dOc[kWR * kWS], Kc[kWR * kWS],
      Vc[kWR * kWS], dSs[kWR * kWS];
  extern __shared__ float slab[];   // [32][kWOut] of K
  const int r = threadIdx.x >> 3, l = threadIdx.x & 7;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWR;
  const int oc0 = blockIdx.z * kWOut;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * Tq;
  const int tq = q0 + r;
  const float scale2 = sm_scale * kLog2e;

  float part = 0.0f;
  if (tq < Tq)
    for (int d = l; d < Dh; d += 8)
      part = fmaf(to_f32(dout[qoff + tq * ld + d]),
                  to_f32(o[qoff + tq * ld + d]), part);
  const float Dr = row_sum8(part);
  if (blockIdx.z == 0 && l == 0 && tq < Tq) dsum[roff + tq] = Dr;
  const float L2 = tq < Tq ? lse[roff + tq] * kLog2e : 0.0f;

  int n_tiles = (S + kWR - 1) / kWR;
  if (causal) n_tiles = min(n_tiles, (q0 + kWR - 1) / kWR + 1);
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kWR;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d0 = 0; d0 < Dh; d0 += 32) {
      __syncthreads();
      wide_chunk(Qc, q + qoff, q0, Tq, ld, d0, Dh);
      wide_chunk(dOc, dout + qoff, q0, Tq, ld, d0, Dh);
      wide_chunk(Kc, k + koff, k0, S, ld, d0, Dh);
      wide_chunk(Vc, v + koff, k0, S, ld, d0, Dh);
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < 32; ++dd) {
        const float qv = Qc[r * kWS + dd], gv = dOc[r * kWS + dd];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[c] = fmaf(qv, Kc[(l + 8 * c) * kWS + dd], s[c]);
          dp[c] = fmaf(gv, Vc[(l + 8 * c) * kWS + dd], dp[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kv = k0 + l + 8 * c;
      const bool ok = tq < Tq && kv < S && (!causal || kv <= tq);
      const float p = ok ? exp2f(fmaf(s[c], scale2, -L2)) : 0.0f;
      dSs[r * kWS + l + 8 * c] = p * (dp[c] - Dr) * sm_scale;
    }
    wide_slab(slab, k + koff, k0, S, ld, oc0, Dh);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kWR; ++t) {
      const float dsv = dSs[r * kWS + t];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        acc[j] = fmaf(dsv, slab[t * kWOut + l + 8 * j], acc[j]);
    }
  }
  if (tq >= Tq) return;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int d = oc0 + l + 8 * j;
    if (d < Dh) dq[qoff + tq * ld + d] = from_f32<T>(acc[j]);
  }
}

// dk and dv at any head dimension: a block owns 32 kv rows (row r of the
// thread) and a slice of output columns, looping over 32-row q tiles from
// the causal diagonal on.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum, T* __restrict__ dk,
                          T* __restrict__ dv, int Tq, int S, int H, int Dh,
                          long long ld, int causal, float sm_scale) {
  __shared__ float Kc[kWR * kWS], Vc[kWR * kWS], Qc[kWR * kWS],
      dOc[kWR * kWS], Ps[kWR * kWS], dSs[kWR * kWS], Ls[kWR], Ds[kWR];
  extern __shared__ float slab[];   // [32][kWOut] of Q, then of dO
  float* Qo = slab;
  float* dOo = slab + kWR * kWOut;
  const int r = threadIdx.x >> 3, l = threadIdx.x & 7;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kWR;
  const int oc0 = blockIdx.z * kWOut;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * Tq;
  const int skv = k0 + r;
  const float scale2 = sm_scale * kLog2e;

  float gk[32], gv[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) gk[j] = gv[j] = 0.0f;
  const int n_q = (Tq + kWR - 1) / kWR;
  for (int it = causal ? k0 / kWR : 0; it < n_q; ++it) {
    const int q0 = it * kWR;
    float st[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dpt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d0 = 0; d0 < Dh; d0 += 32) {
      __syncthreads();
      wide_chunk(Kc, k + koff, k0, S, ld, d0, Dh);
      wide_chunk(Vc, v + koff, k0, S, ld, d0, Dh);
      wide_chunk(Qc, q + qoff, q0, Tq, ld, d0, Dh);
      wide_chunk(dOc, dout + qoff, q0, Tq, ld, d0, Dh);
      if (d0 == 0 && threadIdx.x < kWR) {
        const int t = q0 + threadIdx.x;
        Ls[threadIdx.x] = t < Tq ? lse[roff + t] * kLog2e : 0.0f;
        Ds[threadIdx.x] = t < Tq ? dsum[roff + t] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < 32; ++dd) {
        const float kv = Kc[r * kWS + dd], vv = Vc[r * kWS + dd];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[c] = fmaf(kv, Qc[(l + 8 * c) * kWS + dd], st[c]);
          dpt[c] = fmaf(vv, dOc[(l + 8 * c) * kWS + dd], dpt[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = l + 8 * c, tq = q0 + col;
      const bool ok = tq < Tq && skv < S && (!causal || skv <= tq);
      const float p = ok ? exp2f(fmaf(st[c], scale2, -Ls[col])) : 0.0f;
      Ps[r * kWS + col] = p;
      dSs[r * kWS + col] = p * (dpt[c] - Ds[col]) * sm_scale;
    }
    wide_slab(Qo, q + qoff, q0, Tq, ld, oc0, Dh);
    wide_slab(dOo, dout + qoff, q0, Tq, ld, oc0, Dh);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kWR; ++t) {
      const float pv = Ps[r * kWS + t], dsv = dSs[r * kWS + t];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        gv[j] = fmaf(pv, dOo[t * kWOut + l + 8 * j], gv[j]);
        gk[j] = fmaf(dsv, Qo[t * kWOut + l + 8 * j], gk[j]);
      }
    }
  }
  if (skv >= S) return;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int d = oc0 + l + 8 * j;
    if (d < Dh) {
      dk[koff + skv * ld + d] = from_f32<T>(gk[j]);
      dv[koff + skv * ld + d] = from_f32<T>(gv[j]);
    }
  }
}

// Query rows per thread for the forward: the tallest q tile (16 R rows,
// R <= max_r) that still gives two blocks per SM, else R = 1.
int pick_rows(int Tq, int BH, int max_r) {
  const long long want = 2LL * sm_count();
  for (int r = max_r; r > 1; r >>= 1)
    if ((long long)((Tq + 16 * r - 1) / (16 * r)) * BH >= want) return r;
  return 1;
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
  dim3 grid(B * H, (Tq + TBQ - 1) / TBQ);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, Tq, S, H, Dh, ldq,
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

template <typename T, bool kLse>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int Tq, int S, int H, int Dh,
                    long long ld, int causal, float sm_scale,
                    cudaStream_t stream) {
  auto kernel = flash_fwd_wide_kernel<T, kLse>;
  const size_t smem = sizeof(float) * kWR * kWOut;
  cudaError_t e = allow_smem(kernel, smem, kWFwdStatic);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Tq + kWR - 1) / kWR, (Dh + kWOut - 1) / kWOut);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tq, S, H, Dh, ld,
      causal, sm_scale * kLog2e);
  return (int)cudaGetLastError();
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
  if (bad_shape(B, T, S, H, Dh) || Dh > 256)
    return (int)cudaErrorInvalidValue;
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
  if (bad_shape(B, T, S, H, Dh) || Dh > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_FWD_LSE(TYPE)                                                \
  return launch_fwd<TYPE, true>(q, k, v, o, lse, B, T, S, H, Dh, ld, ld, \
                                ld, ld, causal, sm_scale, st);
  DL4J_BY_DTYPE(DL4J_FWD_LSE)
#undef DL4J_FWD_LSE
}

// The wide forward (any Dh; the caller takes it above 256), every row
// stride ld; with lse non-null it also writes the logsumexp.
extern "C" int dl4j_flash_attn_fwd_wide(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int T, int S, int H, int Dh,
                                        long long ld, int causal,
                                        float sm_scale, int dtype,
                                        void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_FWD_WIDE(TYPE)                                               \
  return lse ? launch_fwd_wide<TYPE, true>(q, k, v, o, lse, B, T, S, H,  \
                                           Dh, ld, causal, sm_scale, st) \
             : launch_fwd_wide<TYPE, false>(q, k, v, o, lse, B, T, S, H, \
                                            Dh, ld, causal, sm_scale, st);
  DL4J_BY_DTYPE(DL4J_FWD_WIDE)
#undef DL4J_FWD_WIDE
}

// The wide dq: dq [B, T, H, Dh] (in the inputs' type) and dsum = rowsum(do
// * o) [B, H, T] (f32) from q, o, do [B, T, H, Dh], k, v [B, S, H, Dh] and
// lse [B, H, T]; every row stride ld.
extern "C" int dl4j_flash_attn_bwd_dq_wide(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const float* lse,
                                           void* dq, float* dsum, int B,
                                           int T, int S, int H, int Dh,
                                           long long ld, int causal,
                                           float sm_scale, int dtype,
                                           void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * kWR * kWOut;
  dim3 grid(B * H, (T + kWR - 1) / kWR, (Dh + kWOut - 1) / kWOut);
#define DL4J_DQ_WIDE(TYPE)                                                 \
  {                                                                        \
    auto kernel = flash_bwd_dq_wide_kernel<TYPE>;                          \
    cudaError_t e = allow_smem(kernel, smem, kWDqStatic);                  \
    if (e != cudaSuccess) return (int)e;                                   \
    kernel<<<grid, kThreads, smem, st>>>(                                  \
        static_cast<const TYPE*>(q), static_cast<const TYPE*>(k),          \
        static_cast<const TYPE*>(v), static_cast<const TYPE*>(o),          \
        static_cast<const TYPE*>(dout), lse, static_cast<TYPE*>(dq), dsum, \
        T, S, H, Dh, ld, causal, sm_scale);                                \
    return (int)cudaGetLastError();                                        \
  }
  DL4J_BY_DTYPE(DL4J_DQ_WIDE)
#undef DL4J_DQ_WIDE
}

// The wide dk/dv: dk, dv [B, S, H, Dh] (in the inputs' type) from q, do
// [B, T, H, Dh], k, v [B, S, H, Dh], lse and dsum [B, H, T]; every row
// stride ld.
extern "C" int dl4j_flash_attn_bwd_dkv_wide(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* dsum, void* dk,
                                            void* dv, int B, int T, int S,
                                            int H, int Dh, long long ld,
                                            int causal, float sm_scale,
                                            int dtype, void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * sizeof(float) * kWR * kWOut;
  dim3 grid(B * H, (S + kWR - 1) / kWR, (Dh + kWOut - 1) / kWOut);
#define DL4J_DKV_WIDE(TYPE)                                                \
  {                                                                        \
    auto kernel = flash_bwd_dkv_wide_kernel<TYPE>;                         \
    cudaError_t e = allow_smem(kernel, smem, kWDkvStatic);                 \
    if (e != cudaSuccess) return (int)e;                                   \
    kernel<<<grid, kThreads, smem, st>>>(                                  \
        static_cast<const TYPE*>(q), static_cast<const TYPE*>(k),          \
        static_cast<const TYPE*>(v), static_cast<const TYPE*>(dout), lse,  \
        dsum, static_cast<TYPE*>(dk), static_cast<TYPE*>(dv), T, S, H, Dh, \
        ld, causal, sm_scale);                                             \
    return (int)cudaGetLastError();                                        \
  }
  DL4J_BY_DTYPE(DL4J_DKV_WIDE)
#undef DL4J_DKV_WIDE
}
