// Graves-LSTM sequence kernels for Hopper (sm_90a), "cluster" variant: the
// forward (primal and residual-saving modes) and the adjoint recurrence,
// each run by thread-block clusters that keep their slice of W resident in
// shared memory for the whole sequence. lstm.cu's header gives the math,
// the TPU kernels these replace, and when a shape takes this variant or
// the "streamed" one; kernels/lstm.py:sequence_plan picks the variant and
// the launch plan (cluster_bytes there mirrors fwd_layout / bwd_layout
// here).
//
// What bounds a step: the recurrence is a chain of T dependent steps. At
// the char-RNN's widths (F = 77 or 200, H = 200) one step of one batch row
// is 2 (F + H) 4H = 0.2-0.3 MFLOP over a 0.9-1.3 MB W, so a design that
// rereads W from L2 every step (the streamed variant: one block per row)
// is bound by what one SM pulls from L2, not by the card. Here a cluster
// of kCluster CTAs shares one group of Bg rows; CTA rank r owns the hidden
// units U_r = [r U, r U + U) (the last slices may be short or empty) and
// loads its slice of W into shared memory once:
//   * forward: the 4 |U_r| gate columns i | f | o | g of its units, all
//     F + H rows (the product is [x_t | h_{t-1}] @ W, as in the TPU
//     kernel's body), so the cell update, c and the peepholes of its units
//     stay local. x_t is staged into the step's input buffer by cp.async
//     one step ahead (off the chain); h_t is written into every CTA's input
//     buffer through distributed shared memory;
//   * adjoint: the rows W[F + U_r, :] (dh_prev of its units) and, when dx is
//     asked for, the rows W[F_r, :] of its input slice F_r = [r Fr, r Fr +
//     Fr) (dx_t of those features), both as W^T (reduction over the 4H gate
//     columns). Each CTA computes the four gate gradients of its units,
//     writes them to dgates (for the reduction launch) and into every CTA's
//     gradient buffer; after the barrier each CTA forms dh_prev of its units
//     and dx of its features from all 4H gate gradients. The residuals of
//     step t-1 are staged by cp.async while step t runs.
// The step buffers are double-buffered by step parity, so one cluster
// barrier (barrier.cluster arrive.release / wait.acquire) per step orders
// every write before every read. A step's product runs on the CUDA cores
// in f32 (TF32 would break the f32 parity): thread (ks, cg) sums k-slice ks
// of the contraction for four adjacent output columns 4 cg .. 4 cg + 3 and
// all Bg rows (a Bg x 4 register tile, and the first rows of its slice of
// W held in registers for the whole sequence, the rest read from shared
// memory), and the owners of the outputs add the k-slices' partial sums in
// slice order. No atomics: reruns are bit-equal. The threads that own a
// unit's state are numbered row fastest, so the values they send into the
// (k-major) step buffers of the other CTAs land contiguously.
// What bounds a step now: the f32 FMAs of the group's rows (2 (F + H) 4U
// FLOP a row and CTA: 0.06-0.08 MFLOP at the char-RNN's widths), the
// partial sums, the cell, and the exchange and barrier
// that every step pays whatever its size (at one row a cluster these
// dominate); kernels/lstm.py sizes Bg so the batch spreads over as many
// clusters as the card runs at once (CLUSTER_GROUPS), one CTA an SM.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace dl4j_lstm;

namespace {

constexpr int kCluster = 8;     // CTAs per cluster: the portable maximum
constexpr int kThreads = 256;

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory carve-up of one CTA, in floats; every region starts on a
// 16-byte boundary. kernels/lstm.py:cluster_bytes computes the same total.
struct Layout {
  int K;          // rows of the contraction
  int Jp;         // resident columns (row stride of the W slice)
  int ws, buf, part, state, bias, peep, stage, total;
};

// Forward: W slice [F + H][4U] (local column g U + u is gate g of unit
// u0 + u), the input buffers [2][F + H][Bg] ([x_t | h_{t-1}] by step
// parity, k-major), the k-slices' partial sums, c [U][Bg], b [4U],
// peep [3U]. Per-unit state is unit-major (row fastest), as the threads
// that own it are numbered: their writes into the next input buffer, which
// is k-major, are then contiguous.
__host__ __device__ inline Layout fwd_layout(int F, int H, int U, int Bg) {
  Layout L;
  L.K = F + H;
  L.Jp = 4 * U;
  L.ws = 0;
  L.buf = L.ws + up4(L.K * L.Jp);
  L.part = L.buf + up4(2 * L.K * Bg);
  L.state = L.part + 4 * kThreads * Bg;
  L.bias = L.state + up4(Bg * U);
  L.peep = L.bias + up4(4 * U);
  L.stage = L.total = L.peep + up4(3 * U);   // no residual stages
  return L;
}

// Adjoint: W^T slice [4H][up4(U + Fr)] (local column u < U is hidden row
// F + u0 + u of W, column U + f is input row f0 + f), the gate-gradient
// buffers [2][4H][Bg] by step parity, the partial sums, dc [U][Bg], peep
// [3U], and two residual stages [2][7][U][Bg] (c_t, c_{t-1}, i, f, o, g,
// dhs_t).
__host__ __device__ inline Layout bwd_layout(int H, int U, int Fr, int Bg) {
  Layout L;
  L.K = 4 * H;
  L.Jp = up4(U + Fr);
  L.ws = 0;
  L.buf = L.ws + L.K * L.Jp;
  L.part = L.buf + up4(2 * L.K * Bg);
  L.state = L.part + 4 * kThreads * Bg;
  L.bias = L.peep = L.state + up4(Bg * U);   // no bias in the adjoint
  L.stage = L.peep + up4(3 * U);
  L.total = L.stage + up4(14 * Bg * U);
  return L;
}

// The BG inputs of row k of a step buffer ([K][BG], k-major): vector loads
// where BG allows, broadcast to the lanes that share the k-slice. (Rows
// padded to 4 floats for vector loads at BG = 3, 5-7 ran slower on an H100.)
template <int BG>
__device__ __forceinline__ void load_inputs(const float* v, float (&r)[BG]) {
  if constexpr (BG % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BG / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(v)[q];
      r[4 * q] = a.x;
      r[4 * q + 1] = a.y;
      r[4 * q + 2] = a.z;
      r[4 * q + 3] = a.w;
    }
  } else if constexpr (BG % 2 == 0) {
#pragma unroll
    for (int q = 0; q < BG / 2; ++q) {
      const float2 a = reinterpret_cast<const float2*>(v)[q];
      r[2 * q] = a.x;
      r[2 * q + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < BG; ++q) r[q] = v[q];
  }
}

// Rows of a thread's k-slice of the resident W slice it keeps in registers
// for the whole sequence (4 floats each: its four columns); rows past them
// are read from shared memory every step. 256 threads a CTA leave 255
// registers a thread. Past 2 batch rows fewer register rows ran faster on
// an H100 (16 against 24, 32 or 40): the BG x 4 accumulators and the loads
// in flight need the registers more.
template <int BG>
constexpr int kRegRows = BG <= 2 ? 40 : 16;

// How the threads split a step product of K rows over PJ = 4 JG columns:
// thread tid is (ks, cg) = (tid / JG, tid % JG), summing rows [kb, ke) of
// k-slice ks (KS slices of kper rows) for columns 4 cg .. 4 cg + 3.
struct Split {
  int PJ, JG, KS, kper, ks, cgi, kb, ke;
  bool active;
  __device__ Split(int K, int pj) {
    PJ = pj;
    JG = PJ / 4;
    KS = min(kThreads / JG, K);
    kper = (K + KS - 1) / KS;
    ks = (int)threadIdx.x / JG;
    cgi = (int)threadIdx.x - ks * JG;
    active = ks < KS;
    kb = min(K, ks * kper);
    ke = active ? min(K, kb + kper) : kb;
  }
  // Output columns j[0..N) of row b: the k-slices' partial sums, each added
  // in slice order (the loads of several slices in flight at once).
  template <int N>
  __device__ __forceinline__ void sums(const float* part, int BG, int b,
                                       const int (&j)[N],
                                       float (&s)[N]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) s[n] = 0.0f;
    const float* p = part + (size_t)b * PJ;
#pragma unroll 4
    for (int q = 0; q < KS; ++q, p += (size_t)BG * PJ)
#pragma unroll
      for (int n = 0; n < N; ++n) s[n] += p[j[n]];
  }
  __device__ __forceinline__ float sum(const float* part, int BG, int b,
                                       int j) const {
    const int jj[1] = {j};
    float s[1];
    sums<1>(part, BG, b, jj, s);
    return s[0];
  }
};

// A thread's rows of the resident slice `ws` (row stride Jp) into registers.
template <int R>
__device__ __forceinline__ void load_slice(float4 (&wr)[R],
                                           const float* __restrict__ ws,
                                           int Jp, const Split& sp) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    wr[i] = sp.kb + i < sp.ke ? *reinterpret_cast<const float4*>(
                                    ws + (size_t)(sp.kb + i) * Jp + 4 * sp.cgi)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One step's product for one thread: its four columns against the k-major
// inputs `in` ([K][BG]) over its rows in k order (registers first, then
// shared memory), written as its partial sums part[ks][b][4 cg ..] (row
// stride PJ).
template <int BG, int R>
__device__ __forceinline__ void step_product(const float4 (&wr)[R],
                                             const float* __restrict__ ws,
                                             int Jp,
                                             const float* __restrict__ in,
                                             const Split& sp,
                                             float* __restrict__ part) {
  float acc[BG][4];
#pragma unroll
  for (int b = 0; b < BG; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0.0f;
  const int n = sp.ke - sp.kb;
  const float* v = in + (size_t)sp.kb * BG;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n) {
      float r[BG];
      load_inputs<BG>(v + i * BG, r);
#pragma unroll
      for (int b = 0; b < BG; ++b) {
        acc[b][0] = fmaf(r[b], wr[i].x, acc[b][0]);
        acc[b][1] = fmaf(r[b], wr[i].y, acc[b][1]);
        acc[b][2] = fmaf(r[b], wr[i].z, acc[b][2]);
        acc[b][3] = fmaf(r[b], wr[i].w, acc[b][3]);
      }
    }
  }
  const float* w = ws + (size_t)(sp.kb + R) * Jp + 4 * sp.cgi;
#pragma unroll 2
  for (int i = R; i < n; ++i, w += Jp) {
    const float4 w4 = *reinterpret_cast<const float4*>(w);
    float r[BG];
    load_inputs<BG>(v + i * BG, r);
#pragma unroll
    for (int b = 0; b < BG; ++b) {
      acc[b][0] = fmaf(r[b], w4.x, acc[b][0]);
      acc[b][1] = fmaf(r[b], w4.y, acc[b][1]);
      acc[b][2] = fmaf(r[b], w4.z, acc[b][2]);
      acc[b][3] = fmaf(r[b], w4.w, acc[b][3]);
    }
  }
#pragma unroll
  for (int b = 0; b < BG; ++b)
    *reinterpret_cast<float4*>(part + ((size_t)sp.ks * BG + b) * sp.PJ +
                               4 * sp.cgi) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
}

// One cluster per group of BG batch rows walks t = 0 .. T-1. Grid:
// kCluster * ceil(B / BG) CTAs, clusters along x.
template <int BG, bool kSave>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
lstm_cluster_fwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ W,
                        const float* __restrict__ b,
                        const float* __restrict__ peep,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0,
                        float* __restrict__ hs,
                        float* __restrict__ hT,
                        float* __restrict__ cT,
                        float* __restrict__ cs,
                        float* __restrict__ ii,
                        float* __restrict__ ff,
                        float* __restrict__ oo,
                        float* __restrict__ gg,
                        int T, int B, int F, int H, int U, float offs) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = fwd_layout(F, H, U, BG);
  float* ws = smem + L.ws;
  float* buf = smem + L.buf;
  float* part = smem + L.part;
  float* cst = smem + L.state;
  float* bs = smem + L.bias;
  float* ps = smem + L.peep;
  const int K = L.K, Jp = L.Jp, G = 4 * H;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * BG;
  const int rows = min(BG, B - row0);
  const int u0 = rank * U;
  const int ur = max(0, min(U, H - u0));

  // the resident slice, b and peep of the owned units (zero past them)
  for (int e = tid; e < K * Jp; e += kThreads) {
    const int k = e / Jp, j = e - k * Jp;
    const int gate = j / U, u = j - gate * U;
    const bool ok = u < ur;
    cp_async4(ws + e, ok ? W + (size_t)k * G + gate * H + u0 + u : W, ok);
  }
  cp_async_commit();
  for (int j = tid; j < Jp; j += kThreads) {
    const int gate = j / U, u = j - gate * U;
    bs[j] = u < ur ? b[gate * H + u0 + u] : 0.0f;
    if (gate < 3) ps[j] = u < ur ? peep[gate * H + u0 + u] : 0.0f;
  }
  // step 0's inputs [x_0 | h0] in parity 0, zeros in parity 1 (rows past B
  // stay zero throughout)
  for (int e = tid; e < 2 * K * BG; e += kThreads) {
    const int k = (e / BG) % K, r = e % BG;
    float v = 0.0f;
    if (e < K * BG && r < rows)
      v = k < F ? x[(size_t)(row0 + r) * F + k]
                : h0[(size_t)(row0 + r) * H + (k - F)];
    buf[e] = v;
  }
  for (int e = tid; e < BG * U; e += kThreads) {
    const int u = e / BG, r = e - u * BG;
    cst[e] = r < rows && u < ur ? c0[(size_t)(row0 + r) * H + u0 + u] : 0.0f;
  }
  cp_async_wait_all();
  // every CTA of the cluster is running and initialised before any writes
  // into another's buffers
  cluster.sync();

  const Split sp(K, Jp);
  float4 wr[kRegRows<BG>];
  load_slice(wr, ws, Jp, sp);
  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    float* cur = buf + (size_t)p * K * BG;
    float* nxt = buf + (size_t)(p ^ 1) * K * BG;
    if (t + 1 < T) {   // x_{t+1}, off the chain: parity p ^ 1 is free
      const float* xt = x + (size_t)(t + 1) * B * F;
      for (int e = tid; e < F * BG; e += kThreads) {
        const int k = e / BG, r = e - k * BG;
        const bool ok = r < rows;
        cp_async4(nxt + e, ok ? xt + (size_t)(row0 + r) * F + k : x, ok);
      }
      cp_async_commit();
    }
    if (sp.active) step_product<BG>(wr, ws, Jp, cur, sp, part);
    __syncthreads();

    for (int e = tid; e < BG * U; e += kThreads) {
      const int u = e / BG, r = e - u * BG;
      if (r >= rows || u >= ur) continue;
      const int cols[4] = {u, U + u, 2 * U + u, 3 * U + u};
      float z[4];
      sp.sums<4>(part, BG, r, cols, z);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) z[gate] += bs[cols[gate]];
      const float cp = cst[e];
      const float i = sigmoid_f32(z[0] + cp * ps[u]);
      const float f = sigmoid_f32(z[1] + cp * ps[U + u] + offs);
      const float g = tanhf(z[3]);
      const float cn = f * cp + i * g;
      const float o = sigmoid_f32(z[2] + cn * ps[2 * U + u]);
      const float hn = o * tanhf(cn);
      cst[e] = cn;
      const int j = u0 + u;
      const size_t at = ((size_t)t * B + row0 + r) * H + j;
      hs[at] = hn;
      if (kSave) {
        cs[at] = cn;
        ii[at] = i;
        ff[at] = f;
        oo[at] = o;
        gg[at] = g;
      }
      if (t + 1 < T) {   // h_t into every CTA's next input buffer
        float* dst = nxt + (size_t)(F + j) * BG + r;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) *cluster.map_shared_rank(dst, q) = hn;
      } else {
        hT[(size_t)(row0 + r) * H + j] = hn;
        cT[(size_t)(row0 + r) * H + j] = cn;
      }
    }
    cp_async_wait_all();
    cluster.sync();
  }
}

// One cluster per group of BG batch rows walks t = T-1 .. 0. dgates
// receives the gate gradients of every step ([T, B, 4H]); dx (may be null:
// the input needs no gradient) the input gradients; dhs, dhT and dcT may be
// null (zero cotangents).
template <int BG>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
lstm_cluster_bwd_kernel(const float* __restrict__ W,
                        const float* __restrict__ peep,
                        const float* __restrict__ c0,
                        const float* __restrict__ cs,
                        const float* __restrict__ ii,
                        const float* __restrict__ ff,
                        const float* __restrict__ oo,
                        const float* __restrict__ gg,
                        const float* __restrict__ dhs,
                        const float* __restrict__ dhT,
                        const float* __restrict__ dcT,
                        float* __restrict__ dgates,
                        float* __restrict__ dx,
                        float* __restrict__ dh0,
                        float* __restrict__ dc0,
                        int T, int B, int F, int H, int U, int Fr) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = bwd_layout(H, U, Fr, BG);
  float* ws = smem + L.ws;
  float* buf = smem + L.buf;
  float* part = smem + L.part;
  float* dcs = smem + L.state;
  float* ps = smem + L.peep;
  float* stage = smem + L.stage;
  const int K = L.K, Jp = L.Jp, G = 4 * H;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * BG;
  const int rows = min(BG, B - row0);
  const int u0 = rank * U;
  const int ur = max(0, min(U, H - u0));
  const int f0 = rank * Fr;
  const int fr = dx ? max(0, min(Fr, F - f0)) : 0;
  const int n = BG * U;   // items of a residual stage array

  // the resident W^T slice: hidden rows, then (when dx is asked for) input
  // rows; zeros past them
  for (int e = tid; e < K * Jp; e += kThreads) {
    const int j = e / K, k = e - j * K;   // k fastest: W's rows are read along
    const int src = j < U ? (j < ur ? F + u0 + j : -1)
                          : (j - U < fr ? f0 + j - U : -1);
    const bool ok = src >= 0;
    cp_async4(ws + (size_t)k * Jp + j, ok ? W + (size_t)src * G + k : W, ok);
  }
  for (int u = tid; u < 3 * U; u += kThreads) {
    const int gate = u / U, uu = u - gate * U;
    ps[u] = uu < ur ? peep[gate * H + u0 + uu] : 0.0f;
  }
  for (int e = tid; e < 2 * K * BG; e += kThreads) buf[e] = 0.0f;
  for (int e = tid; e < n; e += kThreads) {
    const int u = e / BG, r = e - u * BG;
    dcs[e] = r < rows && u < ur && dcT ? dcT[(size_t)(row0 + r) * H + u0 + u]
                                       : 0.0f;
  }
  // the residuals of step t into stage s
  auto stage_step = [&](int t, int s) {
    float* st = stage + (size_t)s * 7 * n;
    for (int e = tid; e < n; e += kThreads) {
      const int u = e / BG, r = e - u * BG;
      if (r >= rows || u >= ur) continue;
      const size_t at = ((size_t)t * B + row0 + r) * H + u0 + u;
      cp_async4(st + e, cs + at, true);
      cp_async4(st + n + e,
                t > 0 ? cs + at - (size_t)B * H
                      : c0 + (size_t)(row0 + r) * H + u0 + u,
                true);
      cp_async4(st + 2 * n + e, ii + at, true);
      cp_async4(st + 3 * n + e, ff + at, true);
      cp_async4(st + 4 * n + e, oo + at, true);
      cp_async4(st + 5 * n + e, gg + at, true);
      cp_async4(st + 6 * n + e, dhs ? dhs + at : cs, dhs != nullptr);
    }
    cp_async_commit();
  };
  stage_step(T - 1, (T - 1) & 1);
  cp_async_wait_all();
  cluster.sync();

  // the product needs the hidden columns, and the input ones for dx
  const Split sp(K, up4(dx ? U + Fr : U));
  float4 wr[kRegRows<BG>];
  load_slice(wr, ws, Jp, sp);
  auto write_dx = [&](int t) {
    for (int e = tid; e < BG * fr; e += kThreads) {
      const int r = e / fr, f = e - r * fr;
      if (r < rows)
        dx[((size_t)t * B + row0 + r) * F + f0 + f] = sp.sum(part, BG, r, U + f);
    }
  };

  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;
    // dz of step t + 1: dh for this step's units, dx_{t+1} of this slice
    if (t < T - 1 && sp.active)
      step_product<BG>(wr, ws, Jp, buf + (size_t)(p ^ 1) * K * BG, sp, part);
    cp_async_wait_all();   // the residuals of step t
    __syncthreads();
    if (t > 0) stage_step(t - 1, p ^ 1);

    const float* st = stage + (size_t)p * 7 * n;
    float* dgp = buf + (size_t)p * K * BG;
    for (int e = tid; e < n; e += kThreads) {
      const int u = e / BG, r = e - u * BG;
      if (r >= rows || u >= ur) continue;
      const int j = u0 + u;
      const float dh =
          t < T - 1 ? sp.sum(part, BG, r, u)
                    : (dhT ? dhT[(size_t)(row0 + r) * H + j] : 0.0f);
      const float c = st[e], cp = st[n + e], i = st[2 * n + e];
      const float f = st[3 * n + e], o = st[4 * n + e], g = st[5 * n + e];
      const float dht = (dhs ? st[6 * n + e] : 0.0f) + dh;
      const float tc = tanhf(c);
      const float d_o = dht * tc * o * (1.0f - o);
      const float dct = dht * o * (1.0f - tc * tc) + dcs[e] + d_o * ps[2 * U + u];
      const float d_i = dct * g * i * (1.0f - i);
      const float d_f = dct * cp * f * (1.0f - f);
      const float d_g = dct * i * (1.0f - g * g);
      dcs[e] = dct * f + d_i * ps[u] + d_f * ps[U + u];
      const float d[4] = {d_i, d_f, d_o, d_g};
      float* dgt = dgates + ((size_t)t * B + row0 + r) * G;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        dgt[gate * H + j] = d[gate];
        float* dst = dgp + (size_t)(gate * H + j) * BG + r;
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          *cluster.map_shared_rank(dst, q) = d[gate];
      }
    }
    if (t < T - 1) write_dx(t + 1);
    cluster.sync();
  }

  // dz of step 0: dh0 and dx_0 (local reads only)
  if (sp.active) step_product<BG>(wr, ws, Jp, buf, sp, part);
  __syncthreads();
  for (int e = tid; e < n; e += kThreads) {
    const int u = e / BG, r = e - u * BG;
    if (r >= rows || u >= ur) continue;
    const size_t at = (size_t)(row0 + r) * H + u0 + u;
    dh0[at] = sp.sum(part, BG, r, u);
    dc0[at] = dcs[e];
  }
  write_dx(0);
}

template <int BG, bool kSave>
int launch_fwd(const float* x, const float* W, const float* b,
               const float* peep, const float* h0, const float* c0,
               float* hs, float* hT, float* cT, float* cs, float* ii,
               float* ff, float* oo, float* gg, int T, int B, int F, int H,
               int U, float offs, cudaStream_t stream) {
  static std::atomic<size_t> granted[kMaxDevices];
  const size_t bytes = (size_t)fwd_layout(F, H, U, BG).total * sizeof(float);
  auto kernel = &lstm_cluster_fwd_kernel<BG, kSave>;
  cudaError_t e = grant_smem(kernel, bytes, granted);
  if (e != cudaSuccess) return (int)e;
  const int groups = (B + BG - 1) / BG;
  kernel<<<groups * kCluster, kThreads, bytes, stream>>>(
      x, W, b, peep, h0, c0, hs, hT, cT, cs, ii, ff, oo, gg, T, B, F, H, U,
      offs);
  return (int)cudaGetLastError();
}

template <int BG>
int launch_bwd(const float* W, const float* peep, const float* c0,
               const float* cs, const float* ii, const float* ff,
               const float* oo, const float* gg, const float* dhs,
               const float* dhT, const float* dcT, float* dgates, float* dx,
               float* dh0, float* dc0, int T, int B, int F, int H, int U,
               int Fr, cudaStream_t stream) {
  static std::atomic<size_t> granted[kMaxDevices];
  const size_t bytes = (size_t)bwd_layout(H, U, Fr, BG).total * sizeof(float);
  auto kernel = &lstm_cluster_bwd_kernel<BG>;
  cudaError_t e = grant_smem(kernel, bytes, granted);
  if (e != cudaSuccess) return (int)e;
  const int groups = (B + BG - 1) / BG;
  kernel<<<groups * kCluster, kThreads, bytes, stream>>>(
      W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT, dcT, dgates, dx, dh0, dc0,
      T, B, F, H, U, Fr);
  return (int)cudaGetLastError();
}

// A plan the kernels take: the sizes kernels/lstm.py:sequence_plan gives.
bool bad_plan(int T, int B, int F, int H, int U, int Fr, int Bg) {
  if (T < 1 || B < 1 || F < 0 || H < 1 || U < 1 || Fr < 0) return true;
  if ((long long)U * kCluster < H || (long long)Fr * kCluster < F) return true;
  if (Bg < 1 || Bg > 8) return true;
  if ((long long)(B + Bg - 1) / Bg * kCluster > 2147483647LL) return true;
  // a step product's column groups must fit the block
  if (U > kThreads || up4(U + Fr) / 4 > kThreads) return true;
  const long long fwd = (long long)fwd_layout(F, H, U, Bg).total * 4;
  const long long bwd = (long long)bwd_layout(H, U, Fr, Bg).total * 4;
  return fwd > kMaxSharedBytes || bwd > kMaxSharedBytes;
}

template <bool kSave>
int dispatch_fwd(const float* x, const float* W, const float* b,
                 const float* peep, const float* h0, const float* c0,
                 float* hs, float* hT, float* cT, float* cs, float* ii,
                 float* ff, float* oo, float* gg, int T, int B, int F, int H,
                 int U, int Fr, int Bg, float offs, void* stream) {
  if (bad_plan(T, B, F, H, U, Fr, Bg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Bg) {
#define DL4J_FWD(n)                                                          \
  case n:                                                                    \
    return launch_fwd<n, kSave>(x, W, b, peep, h0, c0, hs, hT, cT, cs, ii,   \
                                ff, oo, gg, T, B, F, H, U, offs, s);
    DL4J_FWD(1) DL4J_FWD(2) DL4J_FWD(3) DL4J_FWD(4)
    DL4J_FWD(5) DL4J_FWD(6) DL4J_FWD(7) DL4J_FWD(8)
#undef DL4J_FWD
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dl4j_lstm_cluster_fwd(const float* x, const float* W,
                                     const float* b, const float* peep,
                                     const float* h0, const float* c0,
                                     float* hs, float* hT, float* cT, int T,
                                     int B, int F, int H, int U, int Fr,
                                     int Bg, float offs, void* stream) {
  return dispatch_fwd<false>(x, W, b, peep, h0, c0, hs, hT, cT, nullptr,
                             nullptr, nullptr, nullptr, nullptr, T, B, F, H,
                             U, Fr, Bg, offs, stream);
}

extern "C" int dl4j_lstm_cluster_fwd_res(
    const float* x, const float* W, const float* b, const float* peep,
    const float* h0, const float* c0, float* hs, float* hT, float* cT,
    float* cs, float* ii, float* ff, float* oo, float* gg, int T, int B,
    int F, int H, int U, int Fr, int Bg, float offs, void* stream) {
  return dispatch_fwd<true>(x, W, b, peep, h0, c0, hs, hT, cT, cs, ii, ff,
                            oo, gg, T, B, F, H, U, Fr, Bg, offs, stream);
}

extern "C" int dl4j_lstm_cluster_bwd(
    const float* W, const float* peep, const float* c0, const float* cs,
    const float* ii, const float* ff, const float* oo, const float* gg,
    const float* dhs, const float* dhT, const float* dcT, float* dgates,
    float* dx, float* dh0, float* dc0, int T, int B, int F, int H, int U,
    int Fr, int Bg, void* stream) {
  if (bad_plan(T, B, F, H, U, Fr, Bg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Bg) {
#define DL4J_BWD(n)                                                          \
  case n:                                                                    \
    return launch_bwd<n>(W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT, dcT,     \
                         dgates, dx, dh0, dc0, T, B, F, H, U, Fr, s);
    DL4J_BWD(1) DL4J_BWD(2) DL4J_BWD(3) DL4J_BWD(4)
    DL4J_BWD(5) DL4J_BWD(6) DL4J_BWD(7) DL4J_BWD(8)
#undef DL4J_BWD
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the forward (adjoint = 0) or the
// adjoint (adjoint = 1), in bytes: what kernels/lstm.py:cluster_bytes must
// agree with.
extern "C" long long dl4j_lstm_cluster_bytes(int F, int H, int U, int Fr,
                                             int Bg, int adjoint) {
  return 4LL * (adjoint ? bwd_layout(H, U, Fr, Bg).total
                        : fwd_layout(F, H, U, Bg).total);
}

// Clusters of the residual forward (adjoint = 0) or the adjoint (1) the
// card holds at once at this plan's shared memory
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error. The kernels
// of every Bg take over half an SM's registers (one CTA an SM), so the
// 8-row kernels stand for all.
extern "C" int dl4j_lstm_cluster_max_active(int F, int H, int U, int Fr,
                                            int Bg, int adjoint) {
  const size_t bytes = (size_t)dl4j_lstm_cluster_bytes(F, H, U, Fr, Bg,
                                                       adjoint);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  int n = 0;
  cudaError_t e;
  if (adjoint) {
    static std::atomic<size_t> granted[kMaxDevices];
    auto kernel = &lstm_cluster_bwd_kernel<8>;
    e = grant_smem(kernel, bytes, granted);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  } else {
    static std::atomic<size_t> granted[kMaxDevices];
    auto kernel = &lstm_cluster_fwd_kernel<8, true>;
    e = grant_smem(kernel, bytes, granted);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  return e == cudaSuccess ? n : -(int)e;
}
