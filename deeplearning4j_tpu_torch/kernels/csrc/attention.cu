// Flash-attention forward for Hopper (sm_90a): softmax attention over
// [B, T, H, Dh] query and [B, S, H, Dh] key/value tensors, every head in one
// launch.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/attention.py:_make_kernel
// in primal mode (emit_lse=False), reached through _flash_fwd_impl's
// pl.pallas_call. Same math per (batch, head):
//
//   s   = (q @ k^T) * sm_scale, masked to -inf where kv >= S (ragged tail)
//         or, when causal, where kv > q (top-left diagonal)
//   online softmax over kv tiles: running row max m, row sum l and an f32
//   accumulator; a -inf running max counts as 0 (m_safe) and its correction
//   factor as 0, exactly as the TPU kernel does
//   out = acc / max(l, 1e-30)
//
// What bounds it: operations. At the LM's shapes (T = S = 256, Dh = 64,
// causal) one (batch, head) problem does 4 * 64 * 256 * 257 / 2 = 8.4 MFLOP
// of products on 256 KB of q/k/v/o, about 32 FLOP per byte, above the
// float32 ridge of the card (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). The
// arithmetic runs on the CUDA cores in f32: TF32 tensor-core products keep
// about three decimal digits, too few for the 1e-4 comparison of the served
// model with the CPU. The wgmma/TMA design and bf16 are later work.
//
// What the design does about it:
//   * The grid is (ceil(T / 64), B * H): one block owns a 64-row q tile of
//     one (batch, head) and loops over 64-row kv tiles. The TPU's
//     sequential kv grid axis becomes this loop, and the loop stops at the
//     causal diagonal, so dead tiles are never loaded (the TPU kernel's
//     `live`). q-tile indices run in reverse so the longest causal rows
//     start first. At bucket 1 the grid is 4 x 6 = 24 blocks on 132 SMs;
//     at bucket 32 it is 768.
//   * The q tile, one k tile, one v tile and the probability tile sit in
//     shared memory (dynamic, up to 115 KB at Dh = 128); rows of q and k
//     are padded by one float so column reads hit distinct banks.
//   * 128 threads as a 16 x 8 grid: a thread owns 4 query rows (ty + 16 i)
//     and 8 score columns (tx + 8 j) of the 64 x 64 score tile, and the same
//     4 rows times Dh / 8 output columns of the accumulator, in registers.
//     The 8 threads that share a row are 8 neighbouring lanes of one warp,
//     so the row max and row sum are three xor-shuffles each.
//   * q/k/v are read with their row stride (H * Dh for the layer's
//     contiguous [B, T, H, Dh] projections), so no head transpose or copy
//     is needed before the launch.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
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

// NC = output columns per thread; the head dimension Dh is at most 8 * NC.
template <int NC>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T,
                 int S, int H, int Dh, long long ldq, long long ldk,
                 long long ldv, long long ldo, int causal, float sm_scale) {
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
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int T, int S, int H, int Dh, long long ldq, long long ldk,
           long long ldv, long long ldo, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (Dh + 1) + (size_t)BK * 8 * NC +
                       (size_t)BQ * PS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<NC><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, T, S, H, Dh, ldq, ldk, ldv, ldo, causal, sm_scale);
  return (int)cudaGetLastError();
}

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
  if (B < 1 || T < 1 || S < 1 || H < 1 || Dh < 1 || Dh > 128 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 8)
    return launch<1>(q, k, v, o, B, T, S, H, Dh, ldq, ldk, ldv, ldo, causal,
                     sm_scale, st);
  if (Dh <= 16)
    return launch<2>(q, k, v, o, B, T, S, H, Dh, ldq, ldk, ldv, ldo, causal,
                     sm_scale, st);
  if (Dh <= 32)
    return launch<4>(q, k, v, o, B, T, S, H, Dh, ldq, ldk, ldv, ldo, causal,
                     sm_scale, st);
  if (Dh <= 64)
    return launch<8>(q, k, v, o, B, T, S, H, Dh, ldq, ldk, ldv, ldo, causal,
                     sm_scale, st);
  return launch<16>(q, k, v, o, B, T, S, H, Dh, ldq, ldk, ldv, ldo, causal,
                    sm_scale, st);
}
