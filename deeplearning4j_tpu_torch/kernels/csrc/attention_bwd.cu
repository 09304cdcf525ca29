// The "simt" attention backward for Hopper: dq (with D = rowsum(do * o))
// and dk/dv on the CUDA cores, in float32, bfloat16 or float16, Dh <= 256.
// attention.cu's header describes the kernels, what bounds them and what
// their design does about it.

#include <initializer_list>

#include "attention_common.cuh"

using namespace dl4j_attn;

namespace {

// Row stride of an f32 probability tile of `cols` columns: two rows of 16
// lanes land on distinct banks, and rows stay 16-byte aligned.
__host__ __device__ constexpr int prob_stride(int cols) {
  return cols % 32 == 0 ? cols + 16 : cols;
}

// dq and D for one q tile of TBQ = 16 R rows of one (batch, head), looping
// over kv tiles of TBK = 16 C rows up to the causal diagonal. A thread owns
// rows ty + 16 i, score columns tx + 16 c and NV packs of 4 output columns
// 4 (tx + 16 n). Grid (B * H, q tiles in reverse).
template <typename T, int R, int C, int NV>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  T* __restrict__ dq, float* __restrict__ dsum, int Tq,
                  int S, int H, int Dh, long long ld, int causal,
                  float sm_scale, int vec) {
  constexpr int TBQ = 16 * R;
  constexpr int TBK = 16 * C;
  constexpr int PS = prob_stride(TBK);
  const int dpad = fwd_dpad(Dh);
  const int DP = fwd_stride(Dh);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [TBQ][DP]
  T* dOs = Qs + TBQ * DP;                   // [TBQ][DP]
  T* Ks = dOs + TBQ * DP;                   // [2][TBK][DP]
  T* Vs = Ks + 2 * TBK * DP;                // [2][TBK][DP]
  float* dSs = reinterpret_cast<float*>(Vs + 2 * TBK * DP);   // [TBQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & (TX - 1);
  const int ty = tid / TX;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TBQ;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * Tq;
  const float scale2 = sm_scale * kLog2e;

  int n_tiles = (S + TBK - 1) / TBK;
  if (causal) n_tiles = min(n_tiles, (q0 + TBQ - 1) / TBK + 1);

  stage_rows(Qs, q + qoff, q0, TBQ, Tq, ld, Dh, DP, vec);
  stage_rows(dOs, dout + qoff, q0, TBQ, Tq, ld, Dh, DP, vec);
  cp_async_commit();
  stage_rows(Ks, k + koff, 0, TBK, S, ld, Dh, DP, vec);
  stage_rows(Vs, v + koff, 0, TBK, S, ld, Dh, DP, vec);
  cp_async_commit();
  cp_async_wait<1>();   // the own tile has landed; kv tile 0 may be in flight
  __syncthreads();

  // D = rowsum(do * o) over the 16 lanes of a row, and L in base 2
  float Lr[R], Dr[R], acc[R][NV][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + 16 * i;
    const int t = q0 + row;
    float part = 0.0f;
    if (t < Tq) {
      const T* orow = o + qoff + t * ld;
      for (int d = 4 * tx; d < dpad; d += 4 * TX) {
        const float4 g = ld4(dOs + row * DP + d);
        const float ov[4] = {to_f32(orow[d]),
                             d + 1 < Dh ? to_f32(orow[d + 1]) : 0.0f,
                             d + 2 < Dh ? to_f32(orow[d + 2]) : 0.0f,
                             d + 3 < Dh ? to_f32(orow[d + 3]) : 0.0f};
        part = fmaf(g.x, ov[0], part);
        part = fmaf(g.y, ov[1], part);
        part = fmaf(g.z, ov[2], part);
        part = fmaf(g.w, ov[3], part);
      }
    }
    Dr[i] = row_sum16(part);
    if (tx == 0 && t < Tq) dsum[roff + t] = Dr[i];
    Lr[i] = t < Tq ? lse[roff + t] * kLog2e : 0.0f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
  }

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < n_tiles) {   // the next kv tile into the other stage
      const int nxt = (jt + 1) * TBK;
      stage_rows(Ks + (buf ^ 1) * TBK * DP, k + koff, nxt, TBK, S, ld, Dh,
                 DP, vec);
      stage_rows(Vs + (buf ^ 1) * TBK * DP, v + koff, nxt, TBK, S, ld, Dh,
                 DP, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();   // everything but the newest group has landed
    __syncthreads();
    const T* Kt = Ks + buf * TBK * DP;
    const T* Vt = Vs + buf * TBK * DP;

    float sc[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) sc[i][c] = dp[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dpad; d += 4) {
      float4 qv[R], gv[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = ld4(Qs + (ty + 16 * i) * DP + d);
        gv[i] = ld4(dOs + (ty + 16 * i) * DP + d);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kv[c] = ld4(Kt + (tx + TX * c) * DP + d);
        vv[c] = ld4(Vt + (tx + TX * c) * DP + d);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sc[i][c] = dot4(qv[i], kv[c], sc[i][c]);
          dp[i][c] = dot4(gv[i], vv[c], dp[i][c]);
        }
    }

    const int k0 = jt * TBK;
    const bool edge = k0 + TBK > S || q0 + TBQ > Tq ||
                      (causal && k0 + TBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tx + TX * c;
        float p = exp2f(fmaf(sc[i][c], scale2, -Lr[i]));
        if (edge) {
          const int tq = q0 + row, kv_idx = k0 + col;
          const bool ok = tq < Tq && kv_idx < S && (!causal || kv_idx <= tq);
          p = ok ? p : 0.0f;
        }
        dSs[row * PS + col] = p * (dp[i][c] - Dr[i]) * sm_scale;
      }
    }
    __syncthreads();

    // dq += ds k: ds as packs of 4 along the kv axis, k rows as packs of 4
    // output columns
#pragma unroll 2
    for (int s = 0; s < TBK; s += 4) {
      float4 dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * PS +
                                                  s);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int d0 = 4 * (tx + TX * n);
          if (d0 < dpad) {
            const float4 kk = ld4(Kt + (s + u) * DP + d0);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float w = u == 0   ? dsv[i].x
                              : u == 1 ? dsv[i].y
                              : u == 2 ? dsv[i].z
                                       : dsv[i].w;
              acc[i][n][0] = fmaf(w, kk.x, acc[i][n][0]);
              acc[i][n][1] = fmaf(w, kk.y, acc[i][n][1]);
              acc[i][n][2] = fmaf(w, kk.z, acc[i][n][2]);
              acc[i][n][3] = fmaf(w, kk.w, acc[i][n][3]);
            }
          }
        }
      }
    }
    __syncthreads();   // every reader is done with this stage and dSs
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + TX * n) + e;
        if (d < Dh) dq[qoff + t * ld + d] = from_f32<T>(acc[i][n][e]);
      }
    }
  }
}

// dk and dv for one kv tile of TBK = 16 R rows of one (batch, head),
// looping over q tiles of TBQ = 16 C rows from the causal diagonal on (the
// TPU kernel's live = i bq + bq - 1 >= j bk). A thread owns kv rows ty +
// 16 i, score columns (queries) tx + 16 c and NV packs of 4 output
// columns. Grid (B * H, kv tiles): low tiles have the most causal work.
template <typename T, int R, int C, int NV>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_simt(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dk,
                   T* __restrict__ dv, int Tq, int S, int H, int Dh,
                   long long ld, int causal, float sm_scale, int vec) {
  constexpr int TBK = 16 * R;
  constexpr int TBQ = 16 * C;
  constexpr int PS = prob_stride(TBQ);
  const int dpad = fwd_dpad(Dh);
  const int DP = fwd_stride(Dh);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [TBK][DP]
  T* Vs = Ks + TBK * DP;                    // [TBK][DP]
  T* Qs = Vs + TBK * DP;                    // [2][TBQ][DP]
  T* dOs = Qs + 2 * TBQ * DP;               // [2][TBQ][DP]
  float* Ps = reinterpret_cast<float*>(dOs + 2 * TBQ * DP);   // [TBK][PS]
  float* dSs = Ps + TBK * PS;                                  // [TBK][PS]
  float* Ls = dSs + TBK * PS;                                  // [2][TBQ]
  float* Ds = Ls + 2 * TBQ;                                    // [2][TBQ]

  const int tid = threadIdx.x;
  const int tx = tid & (TX - 1);
  const int ty = tid / TX;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * TBK;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long koff = (long long)b * S * ld + (long long)h * Dh;
  const long long roff = (long long)bh * Tq;
  const float scale2 = sm_scale * kLog2e;

  const int it0 = causal ? k0 / TBQ : 0;
  const int n_q = (Tq + TBQ - 1) / TBQ;
  auto stage_q = [&](int it, int buf) {
    const int q0 = it * TBQ;
    stage_rows(Qs + buf * TBQ * DP, q + qoff, q0, TBQ, Tq, ld, Dh, DP, vec);
    stage_rows(dOs + buf * TBQ * DP, dout + qoff, q0, TBQ, Tq, ld, Dh, DP,
               vec);
    stage_stat(Ls + buf * TBQ, lse + roff, q0, TBQ, Tq);
    stage_stat(Ds + buf * TBQ, dsum + roff, q0, TBQ, Tq);
  };
  stage_rows(Ks, k + koff, k0, TBK, S, ld, Dh, DP, vec);
  stage_rows(Vs, v + koff, k0, TBK, S, ld, Dh, DP, vec);
  if (it0 < n_q) stage_q(it0, 0);
  cp_async_commit();

  float gk[R][NV][4], gv[R][NV][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[i][n][e] = gv[i][n][e] = 0.0f;

  for (int it = it0; it < n_q; ++it) {
    const int buf = (it - it0) & 1;
    if (it + 1 < n_q) stage_q(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Qt = Qs + buf * TBQ * DP;
    const T* dOt = dOs + buf * TBQ * DP;
    const float* Lt = Ls + buf * TBQ;
    const float* Dt = Ds + buf * TBQ;
    const int q0 = it * TBQ;

    float st[R][C], dpt[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) st[i][c] = dpt[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dpad; d += 4) {
      float4 kv[R], vv[R], qv[C], gq[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = ld4(Ks + (ty + 16 * i) * DP + d);
        vv[i] = ld4(Vs + (ty + 16 * i) * DP + d);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        qv[c] = ld4(Qt + (tx + TX * c) * DP + d);
        gq[c] = ld4(dOt + (tx + TX * c) * DP + d);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          st[i][c] = dot4(kv[i], qv[c], st[i][c]);
          dpt[i][c] = dot4(vv[i], gq[c], dpt[i][c]);
        }
    }

    const bool edge = q0 + TBQ > Tq || k0 + TBK > S ||
                      (causal && q0 < k0 + TBK - 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = tx + TX * c;
        float p = exp2f(fmaf(st[i][c], scale2, -Lt[col] * kLog2e));
        if (edge) {
          const int tq = q0 + col, skv = k0 + row;
          const bool ok = tq < Tq && skv < S && (!causal || skv <= tq);
          p = ok ? p : 0.0f;
        }
        Ps[row * PS + col] = p;
        dSs[row * PS + col] = p * (dpt[i][c] - Dt[col]) * sm_scale;
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q: p and ds as packs of 4 along the q axis
#pragma unroll 2
    for (int t = 0; t < TBQ; t += 4) {
      float4 pv[R], dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + t);
        dsv[i] =
            *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * PS + t);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int d0 = 4 * (tx + TX * n);
          if (d0 < dpad) {
            const float4 g = ld4(dOt + (t + u) * DP + d0);
            const float4 qq = ld4(Qt + (t + u) * DP + d0);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float a = u == 0   ? pv[i].x
                              : u == 1 ? pv[i].y
                              : u == 2 ? pv[i].z
                                       : pv[i].w;
              const float w = u == 0   ? dsv[i].x
                              : u == 1 ? dsv[i].y
                              : u == 2 ? dsv[i].z
                                       : dsv[i].w;
              gv[i][n][0] = fmaf(a, g.x, gv[i][n][0]);
              gv[i][n][1] = fmaf(a, g.y, gv[i][n][1]);
              gv[i][n][2] = fmaf(a, g.z, gv[i][n][2]);
              gv[i][n][3] = fmaf(a, g.w, gv[i][n][3]);
              gk[i][n][0] = fmaf(w, qq.x, gk[i][n][0]);
              gk[i][n][1] = fmaf(w, qq.y, gk[i][n][1]);
              gk[i][n][2] = fmaf(w, qq.z, gk[i][n][2]);
              gk[i][n][3] = fmaf(w, qq.w, gk[i][n][3]);
            }
          }
        }
      }
    }
    __syncthreads();   // every reader is done with this stage, Ps and dSs
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + TX * n) + e;
        if (d < Dh) {
          dk[koff + s * ld + d] = from_f32<T>(gk[i][n][e]);
          dv[koff + s * ld + d] = from_f32<T>(gv[i][n][e]);
        }
      }
    }
  }
}

template <typename T, int R, int C, int NV>
int launch_dq_simt(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, float* dsum, int B, int Tq, int S, int H,
                   int Dh, long long ld, int causal, float sm_scale,
                   int vec, cudaStream_t stream) {
  constexpr int TBQ = 16 * R, TBK = 16 * C;
  const size_t smem = sizeof(T) * (size_t)(2 * TBQ + 4 * TBK) *
                          fwd_stride(Dh) +
                      sizeof(float) * (size_t)TBQ * prob_stride(TBK);
  auto kernel = flash_bwd_dq_simt<T, R, C, NV>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Tq + TBQ - 1) / TBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), dsum, Tq, S, H,
      Dh, ld, causal, sm_scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, int R, int C, int NV>
int launch_dkv_simt(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dsum,
                    void* dk, void* dv, int B, int Tq, int S, int H, int Dh,
                    long long ld, int causal, float sm_scale, int vec,
                    cudaStream_t stream) {
  constexpr int TBK = 16 * R, TBQ = 16 * C;
  const size_t smem = sizeof(T) * (size_t)(2 * TBK + 4 * TBQ) *
                          fwd_stride(Dh) +
                      sizeof(float) * ((size_t)2 * TBK * prob_stride(TBQ) +
                                       4 * TBQ);
  auto kernel = flash_bwd_dkv_simt<T, R, C, NV>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + TBK - 1) / TBK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, S, H, Dh, ld, causal,
      sm_scale, vec);
  return (int)cudaGetLastError();
}

// Whether every tensor's rows take packs of 4 (16-byte copies for f32, 8
// for 2-byte types).
template <typename T>
bool all_aligned(int Dh, long long ld, std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (!packs_aligned<T>(Dh, ld, p)) return false;
  return true;
}

}  // namespace

// dq [B, T, H, Dh] (in the inputs' type) and dsum = rowsum(do * o)
// [B, H, T] (f32) from q, o, do [B, T, H, Dh], k, v [B, S, H, Dh] and lse
// [B, H, T]; every row stride ld; 1 <= Dh <= 256. Tiles (R, C, NV): own q
// rows 16 R, kv rows 16 C, NV packs of 4 output columns a thread.
extern "C" int dl4j_flash_attn_bwd_dq_simt(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const float* lse,
                                           void* dq, float* dsum, int B,
                                           int T, int S, int H, int Dh,
                                           long long ld, int causal,
                                           float sm_scale, int dtype,
                                           void* stream) {
  if (bad_shape(B, T, S, H, Dh) || Dh > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_DQ_CFG(TYPE, R, C, NV)                                          \
  launch_dq_simt<TYPE, R, C, NV>(q, k, v, o, dout, lse, dq, dsum, B, T, S, \
                                 H, Dh, ld, causal, sm_scale, vec, st)
#define DL4J_DQ(TYPE)                                                     \
  {                                                                       \
    const int vec = all_aligned<TYPE>(Dh, ld, {q, k, v, dout});           \
    if (Dh <= 64) return DL4J_DQ_CFG(TYPE, 4, 2, 1);                      \
    if (Dh <= 128) return DL4J_DQ_CFG(TYPE, 2, 2, 2);                     \
    return DL4J_DQ_CFG(TYPE, 1, 2, 4);                                    \
  }
  DL4J_BY_DTYPE(DL4J_DQ)
#undef DL4J_DQ
#undef DL4J_DQ_CFG
}

// dk, dv [B, S, H, Dh] (in the inputs' type) from q, do [B, T, H, Dh], k, v
// [B, S, H, Dh], lse and dsum [B, H, T]; every row stride ld; 1 <= Dh <=
// 256. Tiles (R, C, NV): own kv rows 16 R, q rows 16 C.
extern "C" int dl4j_flash_attn_bwd_dkv_simt(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* dsum, void* dk,
                                            void* dv, int B, int T, int S,
                                            int H, int Dh, long long ld,
                                            int causal, float sm_scale,
                                            int dtype, void* stream) {
  if (bad_shape(B, T, S, H, Dh) || Dh > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DL4J_DKV_CFG(TYPE, R, C, NV)                                      \
  launch_dkv_simt<TYPE, R, C, NV>(q, k, v, dout, lse, dsum, dk, dv, B, T, \
                                  S, H, Dh, ld, causal, sm_scale, vec, st)
#define DL4J_DKV(TYPE)                                                    \
  {                                                                       \
    const int vec = all_aligned<TYPE>(Dh, ld, {q, k, v, dout});           \
    if (Dh <= 64) return DL4J_DKV_CFG(TYPE, 4, 2, 1);                     \
    if (Dh <= 128) return DL4J_DKV_CFG(TYPE, 2, 1, 2);                    \
    return DL4J_DKV_CFG(TYPE, 1, 1, 4);                                   \
  }
  DL4J_BY_DTYPE(DL4J_DKV)
#undef DL4J_DKV
#undef DL4J_DKV_CFG
}
