// Whole-sequence Graves-LSTM forward for Hopper (sm_90a), one launch per
// layer per forward.
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/lstm.py:_fwd_kernel
// (primal mode, reached through _fwd_impl's pl.pallas_call). Same math as
// the layer's _lstm_cell without a mask:
//
//   z = [x_t, h] @ W + b           W: [F+H, 4H], gate columns i|f|o|g
//   i = sigmoid(z_i + c * p_i)
//   f = sigmoid(z_f + c * p_f + offs)
//   g = tanh(z_g)
//   c' = f * c + i * g
//   o = sigmoid(z_o + c' * p_o)
//   h = o * tanh(c')
//
// What bounds it: the serial chain of T dependent steps. At the char-RNN's
// widths (F = 77 or 200, H = 200, B <= 32) one step is at most
// 2 * 32 * 400 * 800 = 20 MFLOP and W is 0.9-1.3 MB, so neither the
// arithmetic nor the HBM bytes come close to the card's rates; each step
// waits on the previous step's h.
//
// What the design does about it: the time loop runs inside the kernel (the
// TPU grid's sequential time axis becomes a loop in the block), so there is
// one launch per sequence instead of one per step, and h and c never leave
// shared memory between steps. One block per batch row; its threads own
// gate columns for the matrix-vector product (neighbouring threads read
// neighbouring columns of W, so each row of W is one coalesced read) and
// hidden units for the cell update, with __syncthreads() between phases.
// W is read from global memory every step; at these sizes it stays resident
// in the 50 MB L2. Splitting W across blocks with a cluster-wide exchange
// of h, and wgmma/TMA for larger batches, are left for later work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. The entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void lstm_seq_fwd_kernel(const float* __restrict__ x,
                                    const float* __restrict__ W,
                                    const float* __restrict__ b,
                                    const float* __restrict__ peep,
                                    const float* __restrict__ h0,
                                    const float* __restrict__ c0,
                                    float* __restrict__ hs,
                                    float* __restrict__ hT,
                                    float* __restrict__ cT,
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

    float* ht = hs + ((size_t)t * B + row) * H;
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
      ht[j] = h;
    }
    __syncthreads();
  }

  for (int j = tid; j < H; j += nt) {
    hT[(size_t)row * H + j] = z[F + j];
    cT[(size_t)row * H + j] = c[j];
  }
}

}  // namespace

extern "C" int dl4j_lstm_seq_fwd(const float* x, const float* W,
                                 const float* b, const float* peep,
                                 const float* h0, const float* c0, float* hs,
                                 float* hT, float* cT, int T, int B, int F,
                                 int H, float offs, void* stream) {
  int threads = (4 * H + 31) / 32 * 32;  // one thread per gate column
  if (threads > 1024) threads = 1024;    // wider layers stride over columns
  const size_t smem = (size_t)(F + 6 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lstm_seq_fwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      x, W, b, peep, h0, c0, hs, hT, cT, T, B, F, H, offs);
  return (int)cudaGetLastError();
}
