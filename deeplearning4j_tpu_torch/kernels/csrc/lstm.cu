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
// What bounds them: the forward and the adjoint are serial chains of T
// dependent steps; at the char-RNN's widths (F = 77 or 200, H = 200, B <=
// 64) a step is at most 2 * 64 * 400 * 800 = 41 MFLOP over a 0.9-1.3 MB W,
// so neither the arithmetic nor the HBM bytes come close to the card's
// rates: each step waits on the previous one. The reduction is a plain
// [F+H, T*B] x [T*B, 4H] product (1.8-2.6 GFLOP at T*B = 4096), bound by
// the f32 rate of the CUDA cores.
//
// What the designs do about it: the time loops run inside the kernels (the
// TPU grid's sequential time axis becomes a loop in the block), one block
// per batch row, so a sequence is one launch and the carries never leave
// shared memory. The forward's threads own gate columns (neighbouring
// threads read neighbouring columns of a row of W); the adjoint's product
// with W^T reads W by rows, so a warp takes one row at a time, its lanes
// over the 4H columns (coalesced), with a shuffle reduction. The TPU kernel
// accumulates dW in VMEM across its grid; dW (0.9-1.3 MB) does not fit a
// block's 227 KB of shared memory, and 64 row-blocks adding into it with
// atomics would serialise and give a different sum each run. So the adjoint
// writes the gate gradients of every step to a [T, B, 4H] buffer and a
// second launch reduces them: 64 x 64 tiles of dW, each summed by one
// thread over all T*B rows in a fixed order (deterministic, no atomics),
// reading x, hs and the gate gradients directly (no concatenated copy),
// plus blocks of column sums for db and dpeep. W is read from global memory
// every step and stays resident in the 50 MB L2. A persistent cluster
// kernel with W slices resident in shared memory, and wgmma for the dz and
// dW products, are left for later work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

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
                                    int T, int B, int F, int H, float offs) {
  extern __shared__ float smem[];
  const int K = F + H;
  const int G = 4 * H;
  float* z = smem;          // [K]: x_t in [0, F), h in [F, F + H)
  float* gates = z + K;     // [4H] pre-activations
  float* c = gates + G;     // [H] cell state

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int j = tid; j < H; j += nt) {
    z[F + j] = h0[(size_t)row * H + j];
    c[j] = c0[(size_t)row * H + j];
  }

  for (int t = 0; t < T; ++t) {
    const float* xt = x + ((size_t)t * B + row) * F;
    for (int k = tid; k < F; k += nt) z[k] = xt[k];
    __syncthreads();

    for (int col = tid; col < G; col += nt) {
      const float* wc = W + col;
      float acc = b[col];
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(z[k], wc[(size_t)k * G], acc);
      gates[col] = acc;
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
      const float h = o * tanhf(cn);
      c[j] = cn;
      z[F + j] = h;
      hs[base + j] = h;
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
    hT[(size_t)row * H + j] = z[F + j];
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
  const size_t smem = (size_t)(F + 6 * H) * sizeof(float);
  auto kernel = &lstm_seq_fwd_kernel<kSave>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      x, W, b, peep, h0, c0, hs, hT, cT, cs, ii, ff, oo, gg, T, B, F, H,
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

constexpr int kTile = 64;      // dW tile: 64 rows of [x, h] x 64 gate columns
constexpr int kChunk = 16;     // (t, b) rows staged per pass
constexpr int kRedThreads = 256;
constexpr int kRedCols = 32;   // db / dpeep columns per reduction block

// [x_t, h_{t-1}] at flat row n = t * B + b, column k.
__device__ __forceinline__ float zcat_at(const float* __restrict__ x,
                                         const float* __restrict__ hs,
                                         const float* __restrict__ h0,
                                         int n, int k, int B, int F, int H) {
  if (k < F) return x[(size_t)n * F + k];
  return n >= B ? hs[(size_t)(n - B) * H + (k - F)]
                : h0[(size_t)n * H + (k - F)];
}

// Blocks [0, n_tiles) each own one 64 x 64 tile of dW; the rest each own
// 32 of the 7H columns [db (4H) | dpeep (3H)]. Every output is summed by
// one thread over all T*B rows in a fixed order.
__global__ void __launch_bounds__(kRedThreads)
lstm_param_grad_kernel(const float* __restrict__ x,
                       const float* __restrict__ hs,
                       const float* __restrict__ h0,
                       const float* __restrict__ cs,
                       const float* __restrict__ c0,
                       const float* __restrict__ dgates,
                       float* __restrict__ dW,
                       float* __restrict__ db,
                       float* __restrict__ dpeep,
                       int T, int B, int F, int H, int n_tile_cols,
                       int n_tiles) {
  __shared__ __align__(16) float As[kChunk][kTile];
  __shared__ __align__(16) float Bs[kChunk][kTile];
  __shared__ float red[kRedThreads / kRedCols][kRedCols];
  const int G = 4 * H;
  const int K = F + H;
  const int N = T * B;
  const int tid = threadIdx.x;

  if ((int)blockIdx.x < n_tiles) {
    const int k0 = (blockIdx.x / n_tile_cols) * kTile;
    const int c0_ = (blockIdx.x % n_tile_cols) * kTile;
    const int ty = tid / 16;   // rows k0 + 4 ty .. + 3
    const int tx = tid % 16;   // columns c0 + 4 tx .. + 3
    float acc[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += kChunk) {
#pragma unroll
      for (int q = 0; q < kChunk * kTile / kRedThreads; ++q) {
        const int e = tid + q * kRedThreads;
        const int nn = e / kTile;
        const int kk = e % kTile;
        const int n = n0 + nn;
        const int k = k0 + kk;
        const int c = c0_ + kk;
        As[nn][kk] = (n < N && k < K) ? zcat_at(x, hs, h0, n, k, B, F, H)
                                      : 0.0f;
        Bs[nn][kk] = (n < N && c < G) ? dgates[(size_t)n * G + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int nn = 0; nn < kChunk; ++nn) {
        const float4 a = *reinterpret_cast<const float4*>(&As[nn][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[nn][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bw[s], acc[r][s]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + ty * 4 + r;
      if (k >= K) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int c = c0_ + tx * 4 + s;
        if (c < G) dW[(size_t)k * G + c] = acc[r][s];
      }
    }
    return;
  }

  // column sums: db over gate columns, dpeep over (i, f, o) x H
  const int lane = tid % kRedCols;
  const int slice = tid / kRedCols;
  const int nslices = kRedThreads / kRedCols;
  const int col = ((int)blockIdx.x - n_tiles) * kRedCols + lane;
  float acc = 0.0f;
  if (col < G) {
    for (int n = slice; n < N; n += nslices) acc += dgates[(size_t)n * G + col];
  } else if (col < G + 3 * H) {
    const int j = col - G;
    const int gate = j / H;   // 0: i, 1: f, 2: o
    const int u = j % H;
    for (int n = slice; n < N; n += nslices) {
      const float d = dgates[(size_t)n * G + gate * H + u];
      const float cv = gate == 2 ? cs[(size_t)n * H + u]
                       : (n >= B ? cs[(size_t)(n - B) * H + u]
                                 : c0[(size_t)n * H + u]);
      acc = fmaf(d, cv, acc);
    }
  }
  red[slice][lane] = acc;
  __syncthreads();
  if (slice == 0) {
    float s = 0.0f;
    for (int q = 0; q < nslices; ++q) s += red[q][lane];
    if (col < G) db[col] = s;
    else if (col < G + 3 * H) dpeep[col - G] = s;
  }
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
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
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
  const int n_tile_cols = (4 * H + kTile - 1) / kTile;
  const int n_tiles = ((F + H + kTile - 1) / kTile) * n_tile_cols;
  const int n_red = (7 * H + kRedCols - 1) / kRedCols;
  lstm_param_grad_kernel<<<n_tiles + n_red, kRedThreads, 0,
                           (cudaStream_t)stream>>>(
      x, hs, h0, cs, c0, dgates, dW, db, dpeep, T, B, F, H, n_tile_cols,
      n_tiles);
  return (int)cudaGetLastError();
}
