// Graves-LSTM sequence kernels for Hopper (sm_90a): the forward, in primal
// and residual-saving modes, and the backward in two launches (the reverse-
// time adjoint recurrence, then the parameter-gradient reduction).
//
// Replaces the TPU kernels of deeplearning4j_tpu/kernels/lstm.py:
//   * _fwd_kernel (reached through _fwd_impl's pl.pallas_call), in primal
//     mode (save_residuals=False: hs, h_T, c_T) and residual mode
//     (save_residuals=True: also c, i, f, o, g of every step);
//   * _bwd_kernel (reached through _bwd_impl's pl.pallas_call): dx, dW, db,
//     dpeep, dh0, dc0 from the residuals and the cotangents.
//
// Forward math, the layer's _lstm_cell without a mask:
//
//   z = [x_t, h] @ W + b           W: [F+H, 4H], gate columns i|f|o|g
//   i = sigmoid(z_i + c * p_i)
//   f = sigmoid(z_f + c * p_f + offs)
//   g = tanh(z_g)
//   c' = f * c + i * g
//   o = sigmoid(z_o + c' * p_o)
//   h = o * tanh(c')
//
// Adjoint, step t from T-1 down to 0 (dh, dc carried from step t+1, seeded
// with the h_T / c_T cotangents), exactly _bwd_kernel's equations:
//
//   dh  = dhs[t] + dh
//   do  = dh * tanh(c) * o * (1 - o)
//   dc  = dh * o * (1 - tanh(c)^2) + dc + do * p_o
//   di  = dc * g * i * (1 - i);  df = dc * c_prev * f * (1 - f)
//   dg  = dc * i * (1 - g^2)
//   dc_prev = dc * f + di * p_i + df * p_f
//   dz = [di, df, do, dg] @ W^T:  dx_t = dz[:F],  dh_prev = dz[F:]
//
// and the parameter gradients, summed over every (t, b) with h_{-1} = h0
// and c_{-1} = c0:
//
//   dW = sum [x_t, h_{t-1}]^T [di, df, do, dg];  db = sum [di, df, do, dg]
//   dpeep = (sum di * c_{t-1}, sum df * c_{t-1}, sum do * c_t)
//
// Two variants of the forward and the adjoint; kernels/lstm.py:
// sequence_plan picks one from the shapes alone (never by trying one and
// catching its failure):
//   * "cluster" (lstm_cluster.cu, whose header has the design): a
//     thread-block cluster of 8 CTAs per group of Bg batch rows, each CTA
//     holding its slice of W in shared memory for the whole sequence, one
//     cluster barrier per step. Taken wherever a CTA's slice and step
//     buffers fit its 227 KB (the char-RNN's H = 200, and H up to about 330
//     at small input widths);
//   * "streamed" (this file): one block per batch row that reads W from
//     global memory (L2) every step. Taken for wider layers (up to H =
//     9,685, where a row's 6H floats of state still fit a block) and for
//     input widths whose slice of W does not fit (a word-level one-hot
//     vocabulary of 58,200 or 120,000).
//
// What bounds them: the forward and the adjoint are serial chains of T
// dependent steps; at the char-RNN's widths (F = 77 or 200, H = 200, B <=
// 64) a step is at most 2 * 64 * 400 * 800 = 41 MFLOP over a 0.9-1.3 MB W,
// so neither the arithmetic nor the HBM bytes come close to the card's
// rates: each step waits on the previous one. The streamed kernels are
// bound by what one SM pulls from L2 (every block rereads W every step, B
// blocks on B SMs); the cluster kernels read W from L2 once and are bound
// per step by shared-memory reads of the resident slice and the cluster
// barrier. The reduction is a plain [F+H, T*B] x [T*B, 4H] product
// (1.8-2.6 GFLOP at T*B = 4096), bound by the f32 rate of the CUDA cores.
//
// What the streamed designs do: the time loops run inside the kernels (the
// TPU grid's sequential time axis becomes a loop in the block), one block
// per batch row, so a sequence is one launch and the carries never leave
// shared memory. The forward's threads own gate columns (neighbouring
// threads read neighbouring columns of a row of W); it stages x_t in
// shared memory whole where it fits beside h, c and the gates, and in
// chunks where it does not, so it takes any input width (the TPU kernel
// gives way to the layer's scan past its VMEM rule; this one needs only
// the 6H floats of a row's state to fit a block). The adjoint's product
// with W^T reads W by rows, so a warp takes one row at a time, its lanes
// over the 4H columns (coalesced), with a shuffle reduction. The TPU kernel
// accumulates dW in VMEM across its grid; dW (0.9-1.3 MB) does not fit a
// block's 227 KB of shared memory, and blocks adding into it with atomics
// would serialise and give a different sum each run. So both adjoint
// variants write the gate gradients of every step to a [T, B, 4H] buffer
// and a second launch reduces them.
//
// The reduction (redesigned; the first design walked all T*B rows serially
// in each of 65-91 blocks of 64 x 64 tiles, with synchronous loads, a 4 x 4
// micro-tile and separate serial column-sum blocks, 6.7x behind a
// torch.matmul of the same product):
//   * the T*B axis is split into S slices, one per block of a thread-block
//     cluster, over 128 x 64 tiles of dW; S (at most 8) is the most for
//     which all the clusters are resident at once (39 tiles for the
//     char-RNN's first layer, F = 77, and 52 for its second, on 132 SMs),
//     so no tail wave runs a few clusters alone;
//   * the [x | h_{t-1}] operand is tiled by source, x's F columns and h's
//     H columns apart, so a tile reads one tensor with one row stride;
//     each block stages 16-row chunks of it and of the gate gradients
//     through a 3-stage cp.async ring, 16 bytes a copy where the row
//     stride allows (h, the gate gradients, x at F = 200) and 4 bytes
//     where it does not (x rows of F = 77 floats are not 16-byte aligned);
//     a thread keeps an 8 x 4 micro-tile in registers: 32 FMAs per three
//     16-byte shared loads;
//   * the blocks of the first row tile also sum db and dpeep for their 64
//     gate columns from the same staged gate gradients (and the cell
//     states dpeep multiplies), so there is no separate column-sum pass;
//   * the S slices' partial tiles meet in distributed shared memory: rank
//     r sums its share of the tile over the ranks 0..S-1 in order and
//     writes it. One launch per layer, no workspace, no atomics: the same
//     sums in the same order every run.
// It stays in f32 on the CUDA cores (TF32 would break the f32 parity).
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

using namespace dl4j_lstm;

namespace {

// One block per batch row walks t = 0 .. T-1. x_t is staged through shared
// memory in chunks of FC features: all of it in one chunk wherever
// (F + 6H) floats fit a block (every layer the TPU kernel's VMEM rule
// takes), else in chunks of what is left beside h, the gates and c, so a
// layer of any input width (a word-level one-hot vocabulary) runs here.
template <bool kSave>
__global__ void lstm_seq_fwd_kernel(const float* __restrict__ x,
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
                                    int T, int B, int F, int H, int FC,
                                    float offs) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* xs = smem;         // [FC]: features [f0, f0 + FC) of x_t
  float* h = xs + FC;       // [H], right after x_t when FC = F
  float* gates = h + H;     // [4H] pre-activations
  float* c = gates + G;     // [H] cell state

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int j = tid; j < H; j += nt) {
    h[j] = h0[(size_t)row * H + j];
    c[j] = c0[(size_t)row * H + j];
  }

  for (int t = 0; t < T; ++t) {
    const float* xt = x + ((size_t)t * B + row) * F;
    if (FC >= F) {   // x_t whole: [x_t | h] is contiguous, one loop over it
      for (int k = tid; k < F; k += nt) xs[k] = xt[k];
      __syncthreads();
      for (int col = tid; col < G; col += nt) {
        const float* wc = W + col;
        float acc = b[col];
#pragma unroll 8
        for (int k = 0; k < F + H; ++k)
          acc = fmaf(xs[k], wc[(size_t)k * G], acc);
        gates[col] = acc;
      }
    } else {   // x_t in chunks, then h after the last
      for (int f0 = 0; f0 < F; f0 += FC) {
        const int n = min(FC, F - f0);
        if (f0 > 0) __syncthreads();   // every thread is done with the chunk
        for (int k = tid; k < n; k += nt) xs[k] = xt[f0 + k];
        __syncthreads();
        for (int col = tid; col < G; col += nt) {
          const float* wc = W + (size_t)f0 * G + col;
          float acc = f0 == 0 ? b[col] : gates[col];
          for (int k = 0; k < n; ++k)
            acc = fmaf(xs[k], wc[(size_t)k * G], acc);
          if (f0 + FC >= F) {
            const float* wh = W + (size_t)F * G + col;
            for (int j = 0; j < H; ++j)
              acc = fmaf(h[j], wh[(size_t)j * G], acc);
          }
          gates[col] = acc;   // a thread reads back only its own columns
        }
      }
    }
    __syncthreads();

    const size_t base = ((size_t)t * B + row) * H;
    for (int j = tid; j < H; j += nt) {
      const float cp = c[j];
      const float i = sigmoid_f32(gates[j] + cp * peep[j]);
      const float f = sigmoid_f32(gates[H + j] + cp * peep[H + j] + offs);
      const float g = tanhf(gates[3 * H + j]);
      const float cn = f * cp + i * g;
      const float o = sigmoid_f32(gates[2 * H + j] + cn * peep[2 * H + j]);
      const float hn = o * tanhf(cn);
      c[j] = cn;
      h[j] = hn;
      hs[base + j] = hn;
      if (kSave) {
        cs[base + j] = cn;
        ii[base + j] = i;
        ff[base + j] = f;
        oo[base + j] = o;
        gg[base + j] = g;
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < H; j += nt) {
    hT[(size_t)row * H + j] = h[j];
    cT[(size_t)row * H + j] = c[j];
  }
}

template <bool kSave>
int launch_fwd(const float* x, const float* W, const float* b,
               const float* peep, const float* h0, const float* c0,
               float* hs, float* hT, float* cT, float* cs, float* ii,
               float* ff, float* oo, float* gg, int T, int B, int F, int H,
               float offs, void* stream) {
  int threads = (4 * H + 31) / 32 * 32;  // one thread per gate column
  if (threads > 1024) threads = 1024;    // wider layers stride over columns
  const int FC = min(F, kMaxSharedFloats - 6 * H);   // x_t chunk
  if (FC < 1 && F > 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(FC + 6 * H) * sizeof(float);
  static std::atomic<size_t> granted[kMaxDevices];
  auto kernel = &lstm_seq_fwd_kernel<kSave>;
  cudaError_t e = grant_smem(kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      x, W, b, peep, h0, c0, hs, hT, cT, cs, ii, ff, oo, gg, T, B, F, H, FC,
      offs);
  return (int)cudaGetLastError();
}

constexpr int kBwdThreads = 1024;

// One block per batch row walks t = T-1 .. 0. dgates receives the gate
// gradients of every step ([T, B, 4H]); dx (may be null: the input needs
// no gradient) the input gradients ([T, B, F]); dhs, dhT and dcT may be
// null (zero cotangents).
__global__ void __launch_bounds__(kBwdThreads)
lstm_seq_bwd_kernel(const float* __restrict__ W,
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
                    int T, int B, int F, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int K = F + H;
  float* dg = smem;         // [4H] this step's gate gradients
  float* dh = dg + G;       // [H] dh carried from the later step
  float* dc = dh + H;       // [H] dc carried from the later step

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const float* p_i = peep;
  const float* p_f = peep + H;
  const float* p_o = peep + 2 * H;

  for (int j = tid; j < H; j += nt) {
    dh[j] = dhT ? dhT[(size_t)row * H + j] : 0.0f;
    dc[j] = dcT ? dcT[(size_t)row * H + j] : 0.0f;
  }
  __syncthreads();

  const int k_first = dx ? 0 : F;   // rows of W^T the product needs
  for (int t = T - 1; t >= 0; --t) {
    const size_t base = ((size_t)t * B + row) * H;
    for (int j = tid; j < H; j += nt) {
      const float c = cs[base + j];
      const float i = ii[base + j];
      const float f = ff[base + j];
      const float o = oo[base + j];
      const float g = gg[base + j];
      const float cp = t > 0 ? cs[base - (size_t)B * H + j]
                             : c0[(size_t)row * H + j];
      const float dht = (dhs ? dhs[base + j] : 0.0f) + dh[j];
      const float tc = tanhf(c);
      const float d_o = dht * tc * o * (1.0f - o);
      const float dct = dht * o * (1.0f - tc * tc) + dc[j] + d_o * p_o[j];
      const float d_i = dct * g * i * (1.0f - i);
      const float d_f = dct * cp * f * (1.0f - f);
      const float d_g = dct * i * (1.0f - g * g);
      dc[j] = dct * f + d_i * p_i[j] + d_f * p_f[j];
      dg[j] = d_i;
      dg[H + j] = d_f;
      dg[2 * H + j] = d_o;
      dg[3 * H + j] = d_g;
    }
    __syncthreads();

    float* dgt = dgates + ((size_t)t * B + row) * G;
    for (int col = tid; col < G; col += nt) dgt[col] = dg[col];

    // dz = dg @ W^T: warp per row of W, lanes over its 4H columns
    for (int k = k_first + warp; k < K; k += nwarps) {
      const float* wr = W + (size_t)k * G;
      float acc = 0.0f;
      for (int col = lane; col < G; col += 32)
        acc = fmaf(dg[col], wr[col], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        if (k < F) dx[((size_t)t * B + row) * F + k] = acc;
        else dh[k - F] = acc;
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < H; j += nt) {
    dh0[(size_t)row * H + j] = dh[j];
    dc0[(size_t)row * H + j] = dc[j];
  }
}

constexpr int kRedThreads = 256;
constexpr int kTileK = 128;   // dW rows ([x, h] columns) per block
constexpr int kTileG = 64;    // dW columns (gate columns) per block
constexpr int kChunk = 16;    // (t, b) rows per pipeline stage
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kMaxSplit = 8;  // slices of the T*B axis: a portable cluster
constexpr int kRedFloats = kStages * kChunk * (kTileK + 2 * kTileG);

// Copy 16 bytes from global to shared memory asynchronously (cp_async4 in
// lstm_common.cuh copies 4); when !ok nothing is read and the destination
// is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// Which operands may be staged in 16-byte packs (the row stride a multiple
// of 4 floats and the pointers 16-byte aligned); the rest go 4 bytes a copy.
constexpr int kVecX = 1, kVecH = 2, kVecG = 4, kVecC = 8;

// dW = sum_n [x_n, h_{n-B}]^T dgates_n over the flat rows n = t * B + b,
// with db and dpeep. The [x | h] operand is tiled by source: row tiles
// [0, n_xtiles) cover the F columns of x, the rest the H columns of h, so
// a tile reads one tensor with one row stride and, where that stride
// allows (H = 200, F = 200; not F = 77), 16-byte copies. Grid (S, tiles),
// launched as clusters of S blocks along x: blockIdx.y is a 128 x 64 tile
// of dW (row tile kt, gate-column tile gt); the S blocks of a cluster each
// sum one slice of the T*B rows into registers, then reduce the slices
// through distributed shared memory in rank order. The row tile kt = 0
// blocks also sum db and dpeep for their 64 gate columns from the same
// staged gate gradients. No atomics: the same sums in the same order every
// run (for a given S, which the launch derives from the shapes and the
// card).
// Three resident blocks an SM (80 registers a thread) ran faster than two
// (127 registers) on an H100 80GB HBM3: more warps hide the latency.
__global__ void __launch_bounds__(kRedThreads, 3)
lstm_param_grad_kernel(const float* __restrict__ x,
                       const float* __restrict__ hs,
                       const float* __restrict__ h0,
                       const float* __restrict__ cs,
                       const float* __restrict__ c0,
                       const float* __restrict__ dgates,
                       float* __restrict__ dW,
                       float* __restrict__ db,
                       float* __restrict__ dpeep,
                       int T, int B, int F, int H, int n_gtiles,
                       int n_xtiles, int vec) {
  __shared__ __align__(16) float smem[kRedFloats];   // 48 KB
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = 4 * H;
  const int N = T * B;
  const int tid = threadIdx.x;
  const int tx = tid & 15;    // gate columns g0 + 4 tx .. + 3
  const int ty = tid >> 4;    // tile rows 8 ty .. + 7
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kt = blockIdx.y / n_gtiles;
  const int g0 = (blockIdx.y % n_gtiles) * kTileG;
  const bool sums = kt == 0;  // this block also sums db and dpeep
  // the tile's source: columns [base, base + 128) of x (row stride F) or
  // of h (row stride H), dW rows from k0
  const bool seg_x = kt < n_xtiles;
  const int base = (seg_x ? kt : kt - n_xtiles) * kTileK;
  const int width = seg_x ? F : H;
  const int k0 = seg_x ? base : F + base;
  const int rows_here = min(kTileK, width - base);
  const bool vec_z = (vec & (seg_x ? kVecX : kVecH)) != 0;
  const bool vec_g = (vec & kVecG) != 0;
  const bool vec_c = (vec & kVecC) != 0;

  // this block's slice of the T*B rows, a whole number of chunks
  const int per =
      ((N + n_split - 1) / n_split + kChunk - 1) / kChunk * kChunk;
  const int n_begin = rank * per;
  const int n_end = min(N, n_begin + per);
  const int chunks = n_end > n_begin ? (n_end - n_begin + kChunk - 1) / kChunk
                                     : 0;

  float* Zs = smem;                                // [kStages][kChunk][kTileK]
  float* Gs = Zs + kStages * kChunk * kTileK;      // [kStages][kChunk][kTileG]
  float* Cs = Gs + kStages * kChunk * kTileG;      // [kStages][kChunk][kTileG]

  // The element (row n, column c) of the tile's source, and of the cell
  // state dpeep multiplies at gate column c (c_{t-1} for i and f, c_t for
  // o; c0 and h0 stand for step -1).
  auto z_at = [&](int n, int c) -> const float* {
    return seg_x ? x + (size_t)n * F + c
                 : (n >= B ? hs + (size_t)(n - B) * H + c
                           : h0 + (size_t)n * H + c);
  };
  auto c_at = [&](int n, int gate, int u) -> const float* {
    return gate == 2 ? cs + (size_t)n * H + u
                     : (n >= B ? cs + (size_t)(n - B) * H + u
                               : c0 + (size_t)n * H + u);
  };
  // What a thread copies in every chunk. Packs: the [x | h] tile's pack
  // (row e >> 5, columns 4 (e & 31)) for e = tid and tid + 256, and one
  // gate-gradient pack (row tid >> 4, columns 4 tx). Single floats: one
  // [x | h] column (tid & 127) in rows (tid >> 7) + 2 q, one gate column
  // (tid & 63) in rows (tid >> 6) + 4 q.
  const int gc4 = g0 + 4 * tx;
  const int gate4 = gc4 / H, gu4 = gc4 - gate4 * H;
  const int gc1 = g0 + (tid & (kTileG - 1));
  const int gate1 = gc1 / H, gu1 = gc1 - gate1 * H;

  // One chunk into stage s, zero-filled past the slice and the edges.
  auto stage = [&](int s, int ch) {
    const int nb = n_begin + ch * kChunk;
    float* zs = Zs + s * kChunk * kTileK;
    float* gs = Gs + s * kChunk * kTileG;
    float* cz = Cs + s * kChunk * kTileG;
    if (vec_z) {
#pragma unroll
      for (int q = 0; q < kChunk * kTileK / 4 / kRedThreads; ++q) {
        const int e = tid + q * kRedThreads;
        const int n = nb + (e >> 5);
        const int c = base + 4 * (e & 31);
        const bool ok = n < n_end && c < width;
        cp_async16(zs + 4 * e, ok ? z_at(n, c) : x, ok);
      }
    } else {
      const int c = base + (tid & (kTileK - 1));
#pragma unroll
      for (int q = 0; q < kChunk * kTileK / kRedThreads; ++q) {
        const int nn = (tid / kTileK) + q * (kRedThreads / kTileK);
        const int n = nb + nn;
        const bool ok = n < n_end && c < width;
        cp_async4(zs + nn * kTileK + (tid & (kTileK - 1)),
                  ok ? z_at(n, c) : x, ok);
      }
    }
    if (vec_g) {
      const int nn = tid >> 4;
      const int n = nb + nn;
      const bool ok = n < n_end && gc4 < G;
      cp_async16(gs + 4 * tid, ok ? dgates + (size_t)n * G + gc4 : dgates,
                 ok);
    } else {
#pragma unroll
      for (int q = 0; q < kChunk * kTileG / kRedThreads; ++q) {
        const int nn = (tid / kTileG) + q * (kRedThreads / kTileG);
        const int n = nb + nn;
        const bool ok = n < n_end && gc1 < G;
        cp_async4(gs + nn * kTileG + (tid & (kTileG - 1)),
                  ok ? dgates + (size_t)n * G + gc1 : dgates, ok);
      }
    }
    if (!sums) return;
    if (vec_c) {
      const int n = nb + (tid >> 4);
      const bool ok = n < n_end && gc4 < G && gate4 < 3;
      cp_async16(cz + 4 * tid, ok ? c_at(n, gate4, gu4) : cs, ok);
    } else {
#pragma unroll
      for (int q = 0; q < kChunk * kTileG / kRedThreads; ++q) {
        const int nn = (tid / kTileG) + q * (kRedThreads / kTileG);
        const int n = nb + nn;
        const bool ok = n < n_end && gc1 < G && gate1 < 3;
        cp_async4(cz + nn * kTileG + (tid & (kTileG - 1)),
                  ok ? c_at(n, gate1, gu1) : cs, ok);
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dps[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool sum_here = sums && ty == 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int ch = 0; ch < chunks; ++ch) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();   // chunk ch has landed; stage (ch - 1) % kStages is free
    const int nxt = ch + kStages - 1;
    if (nxt < chunks) stage(nxt % kStages, nxt);
    asm volatile("cp.async.commit_group;\n" ::);
    const int s = ch % kStages;
    const float* zs = Zs + s * kChunk * kTileK + 8 * ty;
    const float* gs = Gs + s * kChunk * kTileG + 4 * tx;
    const float* cz = Cs + s * kChunk * kTileG + 4 * tx;
#pragma unroll
    for (int nn = 0; nn < kChunk; ++nn) {
      const float4 a0 = *reinterpret_cast<const float4*>(zs + nn * kTileK);
      const float4 a1 =
          *reinterpret_cast<const float4*>(zs + nn * kTileK + 4);
      const float4 g4 = *reinterpret_cast<const float4*>(gs + nn * kTileG);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], gv[c], acc[r][c]);
      if (sum_here) {
        const float4 c4 = *reinterpret_cast<const float4*>(cz + nn * kTileG);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dbs[c] += gv[c];
          dps[c] = fmaf(gv[c], cv[c], dps[c]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();   // the stages are free: they hold the partial sums now

  // this slice's partial tile [kTileK][kTileG], then db and dpeep [2][64]
  float* red = smem;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    *reinterpret_cast<float4*>(red + (8 * ty + r) * kTileG + 4 * tx) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  if (sum_here) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      red[kTileK * kTileG + 4 * tx + c] = dbs[c];
      red[kTileK * kTileG + kTileG + 4 * tx + c] = dps[c];
    }
  }
  cluster.sync();

  // rank r sums the float4s r * 256 + tid (+ S * 256 ...) of the tile over
  // the slices 0 .. S-1 in order
  for (int i4 = rank * kRedThreads + tid; i4 < kTileK * kTileG / 4;
       i4 += n_split * kRedThreads) {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int qr = 0; qr < n_split; ++qr) {
      const float4 p =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(red, qr))[i4];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const int row = (4 * i4) / kTileG;
    const int c = g0 + (4 * i4) % kTileG;
    if (row < rows_here) {
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < G) dW[(size_t)(k0 + row) * G + c + j] = sv[j];
    }
  }
  if (sums && rank == n_split - 1 && tid < 2 * kTileG) {
    float sum = 0.0f;
    for (int qr = 0; qr < n_split; ++qr)
      sum += cluster.map_shared_rank(red, qr)[kTileK * kTileG + tid];
    const int c = g0 + tid % kTileG;
    if (tid < kTileG) {
      if (c < G) db[c] = sum;
    } else if (c < 3 * H) {
      dpeep[c] = sum;       // dpeep is [i | f | o] x H: gate column c
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// Slices of the T*B axis for `tiles` dW tiles: the most (at most
// kMaxSplit, a portable cluster) for which every tile's cluster is resident
// at once (cudaOccupancyMaxActiveClusters), so no tail wave runs a few
// clusters alone; 1 when even single-block clusters need more than a wave.
int reduction_split(int tiles) {
  static int max_clusters[kMaxSplit + 1] = {0};
  for (int split = kMaxSplit; split > 1; --split) {
    if (max_clusters[split] == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(split, 1);
      cfg.blockDim = dim3(kRedThreads);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = split;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, lstm_param_grad_kernel, &cfg) !=
              cudaSuccess || n < 1)
        n = -1;   // not launchable as such a cluster: never picked
      max_clusters[split] = n;
    }
    if (max_clusters[split] >= tiles) return split;
  }
  return 1;
}

}  // namespace

extern "C" int dl4j_lstm_seq_fwd(const float* x, const float* W,
                                 const float* b, const float* peep,
                                 const float* h0, const float* c0, float* hs,
                                 float* hT, float* cT, int T, int B, int F,
                                 int H, float offs, void* stream) {
  return launch_fwd<false>(x, W, b, peep, h0, c0, hs, hT, cT, nullptr,
                           nullptr, nullptr, nullptr, nullptr, T, B, F, H,
                           offs, stream);
}

extern "C" int dl4j_lstm_seq_fwd_res(const float* x, const float* W,
                                     const float* b, const float* peep,
                                     const float* h0, const float* c0,
                                     float* hs, float* hT, float* cT,
                                     float* cs, float* ii, float* ff,
                                     float* oo, float* gg, int T, int B,
                                     int F, int H, float offs, void* stream) {
  return launch_fwd<true>(x, W, b, peep, h0, c0, hs, hT, cT, cs, ii, ff, oo,
                          gg, T, B, F, H, offs, stream);
}

extern "C" int dl4j_lstm_seq_bwd(const float* W, const float* peep,
                                 const float* c0, const float* cs,
                                 const float* ii, const float* ff,
                                 const float* oo, const float* gg,
                                 const float* dhs, const float* dhT,
                                 const float* dcT, float* dgates, float* dx,
                                 float* dh0, float* dc0, int T, int B, int F,
                                 int H, void* stream) {
  const size_t smem = (size_t)(6 * H) * sizeof(float);
  static std::atomic<size_t> granted[kMaxDevices];
  cudaError_t e = grant_smem(lstm_seq_bwd_kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  lstm_seq_bwd_kernel<<<B, kBwdThreads, smem, (cudaStream_t)stream>>>(
      W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT, dcT, dgates, dx, dh0, dc0,
      T, B, F, H);
  return (int)cudaGetLastError();
}

extern "C" int dl4j_lstm_param_grad(const float* x, const float* hs,
                                    const float* h0, const float* cs,
                                    const float* c0, const float* dgates,
                                    float* dW, float* db, float* dpeep, int T,
                                    int B, int F, int H, void* stream) {
  const int n_gtiles = (4 * H + kTileG - 1) / kTileG;
  const int n_xtiles = (F + kTileK - 1) / kTileK;
  const int n_tiles = (n_xtiles + (H + kTileK - 1) / kTileK) * n_gtiles;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  auto al = [](const float* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = (F % 4 == 0 && al(x) ? kVecX : 0) |
                  (H % 4 == 0 && al(hs) && al(h0) ? kVecH : 0) |
                  (al(dgates) ? kVecG : 0) |
                  (H % 4 == 0 && al(cs) && al(c0) ? kVecC : 0);
  const int split = reduction_split(n_tiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_tiles);
  cfg.blockDim = dim3(kRedThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, lstm_param_grad_kernel, x, hs, h0,
                                     cs, c0, dgates, dW, db, dpeep, T, B, F,
                                     H, n_gtiles, n_xtiles, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
