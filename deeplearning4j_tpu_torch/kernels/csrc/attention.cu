// Flash attention for Hopper (sm_90a): softmax attention over [B, T, H, Dh]
// query and [B, S, H, Dh] key/value tensors, every head in one launch,
// forward and backward. Three kernels:
//
//   flash_fwd_kernel<NC, kLse>   the forward; with kLse it also writes the
//                                per-row logsumexp the backward reads
//   flash_bwd_dq_kernel<NC>      dq, and D = rowsum(do * o) on the way
//   flash_bwd_dkv_kernel<NC>     dk and dv
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
// The logsumexp and D are f32 [B, H, T] (row (b * H + h) * T + t): one
// float per query row, where the TPU kernel keeps a lane-replicated
// [B, Tp, 128] block and slices lane 0.
//
// What bounds them: operations. At the LM's training shapes (B = 64, H = 6,
// T = S = 256, Dh = 64, causal: 32,896 live (q, kv) pairs per (b, h)) the
// forward does 4 Dh FLOPs per live pair (3.2 GFLOP), dq 6 Dh (4.9 GFLOP:
// s, do v^T, ds k) and dk/dv 8 Dh (6.5 GFLOP: s, do v^T, p^T do, ds^T q),
// against about 126 MB of q/k/v/o/do, so each is above the float32 ridge
// of the card (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). The arithmetic
// runs on the CUDA cores in f32: TF32 tensor-core products keep about three
// decimal digits, too few for the comparison of the trained model with the
// CPU. The wgmma/TMA design and bf16 are later work.
//
// What the design does about it:
//   * Tiles of 64 rows. The forward and dq grids are (ceil(T / 64), B * H):
//     a block owns a q tile of one (batch, head) and loops over kv tiles,
//     stopping at the causal diagonal, so dead tiles are never loaded (the
//     TPU kernel's `live`); q-tile indices run in reverse so the longest
//     causal rows start first. The dk/dv grid is (ceil(S / 64), B * H),
//     kv-major as the TPU's second grid: a block owns a kv tile and loops
//     over q tiles from the diagonal on. The TPU's sequential grid axis
//     that carried the accumulators in VMEM becomes this loop, and the
//     accumulators live in registers.
//   * No atomics: every output element is summed by one thread of one
//     block in a fixed order, so the gradients are the same run to run.
//     dk/dv recompute s and do v^T rather than share them with dq, as the
//     TPU kernel's two grids do.
//   * 128 threads as a 16 x 8 grid: a thread owns 4 rows (ty + 16 i) and 8
//     columns (tx + 8 j) of the 64 x 64 score tile, and the same 4 rows
//     times Dh / 8 columns (tx + 8 c) of its accumulators. The 8 threads
//     that share a row are 8 neighbouring lanes of one warp, so the
//     forward's row max and row sum are three xor-shuffles each.
//   * Tiles sit in dynamic shared memory with rows padded to an odd stride
//     (Dh + 1 in the forward, 8 * NC + 1 in the backward, the padding
//     columns zero), so a warp's column reads hit distinct banks. The
//     backward holds four [64][8 NC + 1] tiles plus one (dq) or two (dk/dv)
//     [64][72] probability tiles: at Dh = 128 that is 150,784 bytes (dq)
//     and 169,472 bytes (dk/dv), at Dh = 64 85,248 and 103,936 bytes;
//     above 48 KB a launch first raises the kernel's limit with
//     cudaFuncSetAttribute (a block may use 232,448 bytes).
//   * D = rowsum(do * o) is folded into the dq kernel's preamble (a warp
//     per row, lanes over Dh) and written out for the dk/dv kernel, which
//     runs after it on the same stream.
//   * q/k/v/o/do and the gradients are read and written with their row
//     stride (H * Dh for the layer's contiguous [B, T, H, Dh] projections),
//     so no head transpose or copy is needed around the launches.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128;
constexpr int PS = BK + 8;    // probability-tile row stride (bank spread)

__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// NC = output columns per thread; the head dimension Dh is at most 8 * NC.
// kLse: also write the row logsumexp to lse[(b * H + h) * T + t]. The
// primal instantiation never touches `lse` (the last parameter, so the
// others keep their places).
template <int NC, bool kLse>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T,
                 int S, int H, int Dh, long long ldq, long long ldk,
                 long long ldv, long long ldo, int causal, float sm_scale,
                 float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int DP = Dh + 1;      // q/k row stride in shared memory
  const int VP = 8 * NC;      // v row stride (columns >= Dh held at 0)
  float* Qs = smem;           // [BQ][DP]
  float* Ks = Qs + BQ * DP;   // [BK][DP]
  float* Vs = Ks + BK * DP;   // [BK][VP]
  float* Ps = Vs + BK * VP;   // [BQ][PS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 7;     // score columns tx + 8 j, output tx + 8 c
  const int ty = tid >> 3;    // rows ty + 16 i
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const float* qb = q + (long long)b * T * ldq + (long long)h * Dh;
  const float* kb = k + (long long)b * S * ldk + (long long)h * Dh;
  const float* vb = v + (long long)b * S * ldv + (long long)h * Dh;
  float* ob = o + (long long)b * T * ldo + (long long)h * Dh;

  for (int r = warp; r < BQ; r += NTHREADS / 32) {
    const int t = q0 + r;
    for (int d = lane; d < Dh; d += 32)
      Qs[r * DP + d] = t < T ? qb[t * ldq + d] : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the last tile's readers are done with Ks/Vs/Ps
    for (int r = warp; r < BK; r += NTHREADS / 32) {
      const int s = k0 + r;
      for (int d = lane; d < VP; d += 32) {
        const bool ok = s < S && d < Dh;
        if (d < Dh) Ks[r * DP + d] = ok ? kb[s * ldk + d] : 0.0f;
        Vs[r * VP + d] = ok ? vb[s * ldv + d] : 0.0f;
      }
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int tq = q0 + row;
      bool ok[8];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kv_idx = k0 + tx + 8 * j;
        ok[j] = kv_idx < S && (!causal || kv_idx <= tq);
        sc[i][j] = ok[j] ? sc[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_safe) : 0.0f;
        Ps[row * PS + tx + 8 * j] = p;
        rs += p;
      }
      const float corr = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_safe);
      m[i] = m_new;
      l[i] = l[i] * corr + row_sum8(rs);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < BK; ++s) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + s];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[s * VP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < Dh) ob[t * ldo + d] = acc[i][c] / denom;
    }
    if constexpr (kLse) {
      // the 8 lanes of a row hold the same m and l
      if (tx == 0) {
        const float m_safe = m[i] == -INFINITY ? 0.0f : m[i];
        lse[(long long)blockIdx.y * T + t] = m_safe + logf(denom);
      }
    }
  }
}

// Rows [r0, r0 + 64) of a row-major tile source (row stride ld, head offset
// applied) into shared memory with row stride DP = 8 NC + 1: rows >= n and
// columns >= Dh are zero (the padding column 8 NC is never read).
template <int NC>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, long long ld,
                                          int Dh) {
  constexpr int DP = 8 * NC + 1;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < 64; r += NTHREADS / 32) {
    const int t = r0 + r;
    for (int d = lane; d < 8 * NC; d += 32)
      dst[r * DP + d] = (t < n && d < Dh) ? src[t * ld + d] : 0.0f;
  }
}

// dq (and D) for one 64-row q tile of one (batch, head), looping over kv
// tiles up to the causal diagonal.
template <int NC>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ dsum, int T, int S, int H, int Dh,
                    long long ld, int causal, float sm_scale) {
  constexpr int DP = 8 * NC + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][DP]
  float* dOs = Qs + BQ * DP;    // [BQ][DP]
  float* Ks = dOs + BQ * DP;    // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][DP]
  float* dSs = Vs + BK * DP;    // [BQ][PS]
  float* Ds = dSs + BQ * PS;    // [BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long qoff = (long long)b * T * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * T;

  load_rows<NC>(Qs, q + qoff, q0, T, ld, Dh);
  load_rows<NC>(dOs, dout + qoff, q0, T, ld, Dh);
  __syncthreads();
  // D = rowsum(do * o): a warp per row, lanes over the head dimension
  for (int r = warp; r < BQ; r += NTHREADS / 32) {
    const int t = q0 + r;
    float part = 0.0f;
    if (t < T)
      for (int d = lane; d < Dh; d += 32)
        part = fmaf(dOs[r * DP + d], o[qoff + t * ld + d], part);
    part = warp_sum(part);
    if (lane == 0) {
      Ds[r] = part;
      if (t < T) dsum[roff + t] = part;
    }
  }
  __syncthreads();

  float Lr[4], Dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    Lr[i] = t < T ? lse[roff + t] : 0.0f;
    Dr[i] = Ds[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the last tile's readers are done with Ks/Vs/dSs
    load_rows<NC>(Ks, k + koff, k0, S, ld, Dh);
    load_rows<NC>(Vs, v + koff, k0, S, ld, Dh);
    __syncthreads();

    float sc[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < Dh; ++d) {
      float qv[4], gv[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        gv[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(tx + 8 * j) * DP + d];
        vv[j] = Vs[(tx + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int tq = q0 + row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kv_idx = k0 + tx + 8 * j;
        const bool ok = tq < T && kv_idx < S && (!causal || kv_idx <= tq);
        const float p = ok ? expf(sc[i][j] * sm_scale - Lr[i]) : 0.0f;
        dSs[row * PS + tx + 8 * j] = p * (dp[i][j] - Dr[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < BK; ++s) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * PS + s];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = Ks[s * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < Dh) dq[qoff + t * ld + d] = acc[i][c];
    }
  }
}

// dk and dv for one 64-key tile of one (batch, head), looping over q tiles
// from the causal diagonal on (the TPU kernel's live = i bq + bq - 1 >= j bk).
template <int NC>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int S, int H, int Dh,
                     long long ld, int causal, float sm_scale) {
  constexpr int DP = 8 * NC + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][DP]
  float* Qs = Vs + BK * DP;     // [BQ][DP]
  float* dOs = Qs + BQ * DP;    // [BQ][DP]
  float* Ps = dOs + BQ * DP;    // [BK][PS]  p^T
  float* dSs = Ps + BK * PS;    // [BK][PS]  ds^T
  float* Ls = dSs + BK * PS;    // [BQ]
  float* Ds = Ls + BQ;          // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 7;     // q columns tx + 8 j, output columns tx + 8 c
  const int ty = tid >> 3;    // kv rows ty + 16 i
  const int k0 = blockIdx.x * BK;   // low tiles have the most causal work
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long qoff = (long long)b * T * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * T;

  load_rows<NC>(Ks, k + koff, k0, S, ld, Dh);
  load_rows<NC>(Vs, v + koff, k0, S, ld, Dh);

  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.0f;

  const int n_q = (T + BQ - 1) / BQ;
  for (int it = causal ? k0 / BQ : 0; it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last tile's readers are done with Qs/dOs/Ps/...
    load_rows<NC>(Qs, q + qoff, q0, T, ld, Dh);
    load_rows<NC>(dOs, dout + qoff, q0, T, ld, Dh);
    for (int r = tid; r < BQ; r += NTHREADS) {
      const int t = q0 + r;
      Ls[r] = t < T ? lse[roff + t] : 0.0f;
      Ds[r] = t < T ? dsum[roff + t] : 0.0f;
    }
    __syncthreads();

    float st[4][8], dpt[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < Dh; ++d) {
      float kv[4], vv[4], qv[8], gq[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * DP + d];
        vv[i] = Vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = Qs[(tx + 8 * j) * DP + d];
        gq[j] = dOs[(tx + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(gq[j], vv[i], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int skv = k0 + row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j;
        const int tq = q0 + col;
        const bool ok = tq < T && skv < S && (!causal || skv <= tq);
        const float p = ok ? expf(st[i][j] * sm_scale - Ls[col]) : 0.0f;
        Ps[row * PS + col] = p;
        dSs[row * PS + col] = p * (dpt[i][j] - Ds[col]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BQ; ++t) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty + 16 * i) * PS + t];
        dsv[i] = dSs[(ty + 16 * i) * PS + t];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = dOs[t * DP + tx + 8 * c];
        const float qq = Qs[t * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i][c] = fmaf(pv[i], g, gv[i][c]);
          gk[i][c] = fmaf(dsv[i], qq, gk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < Dh) {
        dk[koff + s * ld + d] = gk[i][c];
        dv[koff + s * ld + d] = gv[i][c];
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

template <int NC, bool kLse>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int B, int T, int S, int H, int Dh, long long ldq,
               long long ldk, long long ldv, long long ldo, int causal,
               float sm_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (Dh + 1) + (size_t)BK * 8 * NC +
                       (size_t)BQ * PS);
  cudaError_t e = allow_smem(flash_fwd_kernel<NC, kLse>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<NC, kLse><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, T, S, H, Dh, ldq, ldk, ldv, ldo, causal, sm_scale, lse);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dq, float* dsum,
              int B, int T, int S, int H, int Dh, long long ld, int causal,
              float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)4 * 64 * (8 * NC + 1) +
                                       (size_t)BQ * PS + BQ);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<NC>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<NC><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, dout, lse, dq, dsum, T, S, H, Dh, ld, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* dsum,
               float* dk, float* dv, int B, int T, int S, int H, int Dh,
               long long ld, int causal, float sm_scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)4 * 64 * (8 * NC + 1) +
                                       (size_t)2 * BK * PS + 2 * BQ);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<NC>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<NC><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, T, S, H, Dh, ld, causal, sm_scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int T, int S, int H, int Dh) {
  return B < 1 || T < 1 || S < 1 || H < 1 || Dh < 1 || Dh > 128 ||
         B * H > 65535;
}

// The instantiation for a head dimension: NC = ceil(Dh / 8) rounded up to
// 1, 2, 4, 8 or 16.
#define DL4J_BY_HEAD_DIM(CALL) \
  if (Dh <= 8) return CALL(1);  \
  if (Dh <= 16) return CALL(2); \
  if (Dh <= 32) return CALL(4); \
  if (Dh <= 64) return CALL(8); \
  return CALL(16);

}  // namespace

// q [B, T, H, Dh] and o [B, T, H, Dh] with row strides ldq / ldo (floats
// between consecutive t), k / v [B, S, H, Dh] with ldk / ldv; the head
// dimension is contiguous and a batch is T (or S) rows. 1 <= Dh <= 128.
extern "C" int dl4j_flash_attn_fwd(const float* q, const float* k,
                                   const float* v, float* o, int B, int T,
                                   int S, int H, int Dh, long long ldq,
                                   long long ldk, long long ldv,
                                   long long ldo, int causal, float sm_scale,
                                   void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_FWD(NC)                                                      \
  launch_fwd<NC, false>(q, k, v, o, nullptr, B, T, S, H, Dh, ldq, ldk, ldv, \
                        ldo, causal, sm_scale, st)
  DL4J_BY_HEAD_DIM(DL4J_FWD)
#undef DL4J_FWD
}

// The forward that also writes lse [B, H, T] (f32): what the backward reads.
extern "C" int dl4j_flash_attn_fwd_lse(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int B, int T, int S, int H, int Dh,
                                       long long ld, int causal,
                                       float sm_scale, void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_FWD_LSE(NC)                                                   \
  launch_fwd<NC, true>(q, k, v, o, lse, B, T, S, H, Dh, ld, ld, ld, ld,    \
                       causal, sm_scale, st)
  DL4J_BY_HEAD_DIM(DL4J_FWD_LSE)
#undef DL4J_FWD_LSE
}

// dq [B, T, H, Dh] and dsum = rowsum(do * o) [B, H, T] from q, o, do
// [B, T, H, Dh], k, v [B, S, H, Dh] and lse [B, H, T]; every row stride ld.
extern "C" int dl4j_flash_attn_bwd_dq(const float* q, const float* k,
                                      const float* v, const float* o,
                                      const float* dout, const float* lse,
                                      float* dq, float* dsum, int B, int T,
                                      int S, int H, int Dh, long long ld,
                                      int causal, float sm_scale,
                                      void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_DQ(NC)                                                        \
  launch_dq<NC>(q, k, v, o, dout, lse, dq, dsum, B, T, S, H, Dh, ld, causal, \
                sm_scale, st)
  DL4J_BY_HEAD_DIM(DL4J_DQ)
#undef DL4J_DQ
}

// dk, dv [B, S, H, Dh] from q, do [B, T, H, Dh], k, v [B, S, H, Dh], lse
// and dsum [B, H, T]; every row stride ld.
extern "C" int dl4j_flash_attn_bwd_dkv(const float* q, const float* k,
                                       const float* v, const float* dout,
                                       const float* lse, const float* dsum,
                                       float* dk, float* dv, int B, int T,
                                       int S, int H, int Dh, long long ld,
                                       int causal, float sm_scale,
                                       void* stream) {
  if (bad_shape(B, T, S, H, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_DKV(NC)                                                       \
  launch_dkv<NC>(q, k, v, dout, lse, dsum, dk, dv, B, T, S, H, Dh, ld,     \
                 causal, sm_scale, st)
  DL4J_BY_HEAD_DIM(DL4J_DKV)
#undef DL4J_DKV
}
