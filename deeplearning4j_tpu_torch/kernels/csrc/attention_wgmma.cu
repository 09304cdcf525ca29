// The "wgmma" attention backward for Hopper (sm_90a): dq (with D =
// rowsum(do * o)) and dk/dv on the tensor cores, for bfloat16 and float16
// at head dimensions that are multiples of 16 up to 256, with 16-byte
// aligned rows and pointers. attention.cu's header describes the kernels,
// what bounds them and what their design does about it.
//
// Layout: a block is one consumer warpgroup (warps 0-3, 64 rows of the own
// tile) and one producer warp (warp 4). Tiles are 64 rows; the head
// dimension is cut into 64-column panels of 128 bytes a row, each panel a
// [64][64] tile in the 128-byte swizzled layout that TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B) and the wgmma matrix descriptors name. The
// tensor maps are 4-D over [B, rows, H, Dh] (innermost first: Dh, H, rows,
// B), so rows past T or S and columns past Dh read zeros.
// cuTensorMapEncodeTiled is looked up at run time (cudaGetDriverEntryPoint),
// so the library does not link libcuda.

#include <cuda.h>

#include <initializer_list>
#include <type_traits>

#include "attention_common.cuh"

using namespace dl4j_attn;

namespace {

constexpr int kRows = 64;               // own and looped-over tile rows
constexpr int kPanel = 64;              // head columns per swizzled panel
constexpr int kPanelBytes = kRows * 128;
constexpr int kStages = 2;              // the ring over the looped-over axis
constexpr int kWgThreads = 160;         // 4 consumer warps + 1 producer
constexpr int kConsumers = 128;

// ---- mbarriers and TMA ------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Nanoseconds on the card's global timer.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase with this parity has completed. A wait
// that never ends (a lost TMA transaction or arrival) traps once 20 s have
// passed on the global timer, read every 1024 polls, instead of hanging
// the card; a healthy wait ends in microseconds, even on a time-sliced or
// preempted card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0, polls = 0;
  uint64_t start = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && (++polls & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > 20000000000ull) __trap();
    }
  } while (!done);
}

// One [64 rows][64 columns] box of a 4-D tensor map at (column c0, head h,
// row r0, batch b) into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h,
                                         int r0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(h), "r"(r0), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------
// A shared-memory matrix descriptor for a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (rows of the tile are M or N, the 16-element k slice at
// byte offset 32 k within a panel row): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}

// MN-major B operand (the tile's rows are K, its columns N): a k16 slice
// is 16 rows (2048 bytes) of one panel; 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return make_desc(addr, kPanelBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DL4J_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define DL4J_REGS32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] B[16 x 64], f32 accumulators: A and B from
// shared memory (A K-major; B K-major, or MN-major with kTransB = 1), or A
// from registers (the m64k16 fragment: four 32-bit pairs a thread).
#define DL4J_WGMMA_FNS(NAME, PTX_TYPE)                                         \
  template <int kTransB>                                                       \
  __device__ __forceinline__ void NAME##_ss(float(&d)[32], uint64_t a,         \
                                            uint64_t b) {                      \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX_TYPE "." PTX_TYPE   \
        " " DL4J_REGS32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"                   \
        : DL4J_ACC32(d)                                                        \
        : "l"(a), "l"(b), "r"(1), "n"(kTransB));                               \
  }                                                                            \
  template <int kTransB>                                                       \
  __device__ __forceinline__ void NAME##_rs(float(&d)[32],                     \
                                            const uint32_t(&a)[4],             \
                                            uint64_t b) {                      \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX_TYPE "." PTX_TYPE   \
        " " DL4J_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"     \
        : DL4J_ACC32(d)                                                        \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),          \
          "n"(kTransB));                                                       \
  }
DL4J_WGMMA_FNS(wgmma_bf16, "bf16")
DL4J_WGMMA_FNS(wgmma_f16, "f16")
#undef DL4J_WGMMA_FNS

template <typename T, int kTransB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    wgmma_bf16_ss<kTransB>(d, a, b);
  else
    wgmma_f16_ss<kTransB>(d, a, b);
}

template <typename T, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    wgmma_bf16_rs<kTransB>(d, a, b);
  else
    wgmma_f16_rs<kTransB>(d, a, b);
}

// ---- element pairs ----------------------------------------------------------
// x0, x1 as a hi pair round(x) and a lo pair round(x - hi) in T (x0 in the
// low half, as the fragment wants the lower column first).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo, __half) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 unpack2(uint32_t u, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 unpack2(uint32_t u, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// 8 products of two 16-byte packs of T, summed in f32.
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t ua[4] = {a.x, a.y, a.z, a.w}, ub[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack2(ua[i], T()), y = unpack2(ub[i], T());
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// The ds (or p) accumulator of a 64 x 64 tile as register A fragments for
// the product over its column axis: k slice kb holds columns 16 kb.. 16 kb
// + 15, which are accumulator entries 8 kb .. 8 kb + 7 of this thread.
template <typename T>
__device__ __forceinline__ void fragments(const float (&x)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(x[8 * kb + 2 * r], x[8 * kb + 2 * r + 1], hi[kb][r], lo[kb][r],
             T());
}

// dq and D for one 64-row q tile of one (batch, head) and the output
// panels [OC z, OC z + OC) (gridDim.z), looping over 64-row kv tiles up to
// the causal diagonal. A consumer thread owns rows r0 = 16 warp + lane / 4
// and r0 + 8 and, in each n8 slice j of a 64-column accumulator, columns
// 8 j + 2 (lane % 4) and the next. Grid (B * H, q tiles in reverse,
// panel slices).
template <typename T, int OC>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ lse, T* __restrict__ dq,
                   float* __restrict__ dsum, int Tq, int S, int H, int Dh,
                   long long ld, int causal, float sm_scale) {
  const int NP = (Dh + kPanel - 1) / kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                        // [NP] panels
  unsigned char* dOs = Qs + NP * kPanelBytes;      // [NP]
  unsigned char* Ks = dOs + NP * kPanelBytes;      // [kStages][NP]
  unsigned char* Vs = Ks + kStages * NP * kPanelBytes;
  uint64_t* own_bar =
      reinterpret_cast<uint64_t*>(Vs + kStages * NP * kPanelBytes);
  uint64_t* full = own_bar + 1;                    // [kStages]
  uint64_t* empty = full + kStages;                // [kStages]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int p0 = blockIdx.z * OC;
  int n_tiles = (S + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kRows + 1);

  if (threadIdx.x == 0) {
    mbar_init(own_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // the producer: the own tile, then the kv ring
    if (lane == 0) {
      const uint32_t bytes = 2 * NP * kPanelBytes;
      mbar_expect_tx(own_bar, bytes);
      for (int p = 0; p < NP; ++p) {
        tma_load(Qs + p * kPanelBytes, &tm_q, own_bar, p * kPanel, h, q0, b);
        tma_load(dOs + p * kPanelBytes, &tm_do, own_bar, p * kPanel, h, q0,
                 b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + s, ((j / kStages) - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        for (int p = 0; p < NP; ++p) {
          const int off = (s * NP + p) * kPanelBytes;
          tma_load(Ks + off, &tm_k, full + s, p * kPanel, h, j * kRows, b);
          tma_load(Vs + off, &tm_v, full + s, p * kPanel, h, j * kRows, b);
        }
      }
    }
    return;
  }

  // consumers: D = rowsum(do * o) and L (base 2) for rows r0 and r0 + 8,
  // from global memory while the own tile lands
  const int g = lane >> 2, c = lane & 3;
  const int r0 = 16 * warp + g;
  const long long qoff = (long long)b * Tq * ld + (long long)h * Dh;
  const long long roff = (long long)bh * Tq;
  const float scale2 = sm_scale * kLog2e;
  float Dr[2], L2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = q0 + r0 + 8 * rr;
    float part = 0.0f;
    if (t < Tq)
      for (int d = 8 * c; d < Dh; d += 32)
        part = dot8<T>(*reinterpret_cast<const uint4*>(o + qoff + t * ld + d),
                       *reinterpret_cast<const uint4*>(dout + qoff + t * ld +
                                                       d),
                       part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    Dr[rr] = part;
    if (c == 0 && t < Tq && blockIdx.z == 0) dsum[roff + t] = part;
    L2[rr] = t < Tq ? lse[roff + t] * kLog2e : 0.0f;
  }

  float qacc[OC][32];
#pragma unroll
  for (int oc = 0; oc < OC; ++oc)
#pragma unroll
    for (int i = 0; i < 32; ++i) qacc[oc][i] = 0.0f;
  const uint32_t q_base = smem_addr(Qs), do_base = smem_addr(dOs);
  mbar_wait(own_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full + s, (j / kStages) & 1);
    const uint32_t kt = smem_addr(Ks) + s * NP * kPanelBytes;
    const uint32_t vt = smem_addr(Vs) + s * NP * kPanelBytes;

    // S = Q K^T and dP = dO V^T over the head dimension
    float sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.0f;
    fence_acc(sacc);
    fence_acc(pacc);
    wg_fence();
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
      mma_ss<T, 0>(sacc, kmajor(q_base + off), kmajor(kt + off));
      mma_ss<T, 0>(pacc, kmajor(do_base + off), kmajor(vt + off));
    }
    wg_commit();
    wg_wait_all();
    fence_acc(sacc);
    fence_acc(pacc);

    // ds = p (dp - D) sm_scale, the mask only on edge tiles
    const int k0 = j * kRows;
    const bool edge = k0 + kRows > S || q0 + kRows > Tq ||
                      (causal && k0 + kRows - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      float p = exp2f(fmaf(sacc[i], scale2, -L2[rr]));
      if (edge) {
        const int tq = q0 + r0 + 8 * rr;
        const int kv = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        const bool ok = tq < Tq && kv < S && (!causal || kv <= tq);
        p = ok ? p : 0.0f;
      }
      sacc[i] = p * (pacc[i] - Dr[rr]) * sm_scale;
    }

    // dQ += dS K (dS as hi + lo register fragments, K MN-major)
    uint32_t fh[4][4], fl[4][4];
    fragments<T>(sacc, fh, fl);
    wg_fence();
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      const int p = p0 + oc;
      if (p < NP) {
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          const uint64_t bd = mnmajor(kt + p * kPanelBytes + kb * 2048);
          mma_rs<T, 1>(qacc[oc], fh[kb], bd);
          mma_rs<T, 1>(qacc[oc], fl[kb], bd);
        }
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) fence_acc(qacc[oc]);
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int oc = 0; oc < OC; ++oc) {
    const int p = p0 + oc;
    if (p >= NP) continue;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = q0 + r0 + 8 * ((i >> 1) & 1);
      const int col = p * kPanel + 8 * (i >> 2) + 2 * c;
      if (t < Tq && col < Dh)
        store2(dq + qoff + t * ld + col, qacc[oc][i], qacc[oc][i + 1]);
    }
  }
}

// dk and dv for one 64-row kv tile of one (batch, head) and the output
// panel z (gridDim.z), looping over 64-row q tiles from the causal
// diagonal on. S^T = K Q^T and dP^T = V dO^T put kv rows in the
// accumulator rows, so P^T and dS^T are register A fragments of dV += P^T
// dO and dK += dS^T Q. L (in base 2) and D of each q tile ride the ring.
// Grid (B * H, kv tiles, panels).
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dk,
                    T* __restrict__ dv, int Tq, int S, int H, int Dh,
                    long long ld, int causal, float sm_scale) {
  const int NP = (Dh + kPanel - 1) / kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = base;                        // [NP]
  unsigned char* Vs = Ks + NP * kPanelBytes;       // [NP]
  unsigned char* Qs = Vs + NP * kPanelBytes;       // [kStages][NP]
  unsigned char* dOs = Qs + kStages * NP * kPanelBytes;
  float* Ls = reinterpret_cast<float*>(dOs + kStages * NP * kPanelBytes);
  float* Ds = Ls + kStages * kRows;                // [kStages][64]
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(Ds + kStages * kRows);
  uint64_t* full = own_bar + 1;
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kRows;
  const int p = blockIdx.z;
  const long long roff = (long long)bh * Tq;
  const int it0 = causal ? k0 / kRows : 0;
  const int n_tiles = max(0, (Tq + kRows - 1) / kRows - it0);

  if (threadIdx.x == 0) {
    mbar_init(own_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // the producer: the own tile, then the q ring
    const uint32_t bytes = 2 * NP * kPanelBytes;
    if (lane == 0) {
      mbar_expect_tx(own_bar, bytes);
      for (int pp = 0; pp < NP; ++pp) {
        tma_load(Ks + pp * kPanelBytes, &tm_k, own_bar, pp * kPanel, h, k0,
                 b);
        tma_load(Vs + pp * kPanelBytes, &tm_v, own_bar, pp * kPanel, h, k0,
                 b);
      }
    }
    for (int jj = 0; jj < n_tiles; ++jj) {
      const int s = jj % kStages;
      const int q0 = (it0 + jj) * kRows;
      if (jj >= kStages) mbar_wait(empty + s, ((jj / kStages) - 1) & 1);
      for (int r = lane; r < kRows; r += 32) {
        const int t = q0 + r;
        Ls[s * kRows + r] = t < Tq ? lse[roff + t] * kLog2e : 0.0f;
        Ds[s * kRows + r] = t < Tq ? dsum[roff + t] : 0.0f;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full + s, bytes);
        for (int pp = 0; pp < NP; ++pp) {
          const int off = (s * NP + pp) * kPanelBytes;
          tma_load(Qs + off, &tm_q, full + s, pp * kPanel, h, q0, b);
          tma_load(dOs + off, &tm_do, full + s, pp * kPanel, h, q0, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, c = lane & 3;
  const int r0 = 16 * warp + g;   // own kv rows r0 and r0 + 8
  const float scale2 = sm_scale * kLog2e;
  float dkacc[32], dvacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = 0.0f;
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
  mbar_wait(own_bar, 0);

  for (int jj = 0; jj < n_tiles; ++jj) {
    const int s = jj % kStages;
    const int q0 = (it0 + jj) * kRows;
    mbar_wait(full + s, (jj / kStages) & 1);
    const uint32_t qt = smem_addr(Qs) + s * NP * kPanelBytes;
    const uint32_t dot = smem_addr(dOs) + s * NP * kPanelBytes;
    const float* Lt = Ls + s * kRows;
    const float* Dt = Ds + s * kRows;

    float sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.0f;
    fence_acc(sacc);
    fence_acc(pacc);
    wg_fence();
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
      mma_ss<T, 0>(sacc, kmajor(k_base + off), kmajor(qt + off));
      mma_ss<T, 0>(pacc, kmajor(v_base + off), kmajor(dot + off));
    }
    wg_commit();
    wg_wait_all();
    fence_acc(sacc);
    fence_acc(pacc);

    const bool edge = q0 + kRows > Tq || k0 + kRows > S ||
                      (causal && q0 < k0 + kRows - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * c + (i & 1);
      float pr = exp2f(fmaf(sacc[i], scale2, -Lt[col]));
      if (edge) {
        const int tq = q0 + col;
        const int skv = k0 + r0 + 8 * ((i >> 1) & 1);
        const bool ok = tq < Tq && skv < S && (!causal || skv <= tq);
        pr = ok ? pr : 0.0f;
      }
      sacc[i] = pr;
      pacc[i] = pr * (pacc[i] - Dt[col]) * sm_scale;
    }

    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
    fragments<T>(sacc, ph, pl);
    fragments<T>(pacc, dh, dl);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t bo = mnmajor(dot + p * kPanelBytes + kb * 2048);
      mma_rs<T, 1>(dvacc, ph[kb], bo);
      mma_rs<T, 1>(dvacc, pl[kb], bo);
      const uint64_t bq = mnmajor(qt + p * kPanelBytes + kb * 2048);
      mma_rs<T, 1>(dkacc, dh[kb], bq);
      mma_rs<T, 1>(dkacc, dl[kb], bq);
    }
    wg_commit();
    wg_wait_all();
    fence_acc(dvacc);
    fence_acc(dkacc);
    mbar_arrive(empty + s);
  }

  const long long koff = (long long)b * S * ld + (long long)h * Dh;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int skv = k0 + r0 + 8 * ((i >> 1) & 1);
    const int col = p * kPanel + 8 * (i >> 2) + 2 * c;
    if (skv < S && col < Dh) {
      store2(dk + koff + skv * ld + col, dkacc[i], dkacc[i + 1]);
      store2(dv + koff + skv * ld + col, dvacc[i], dvacc[i + 1]);
    }
  }
}

// ---- host side --------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &status) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess)
      return nullptr;
#endif
    return status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map of a [B, rows, H, Dh] tensor with row stride ld, read in
// [64 rows][64 columns] boxes with the 128-byte swizzle.
bool tile_map(CUtensorMap* map, const void* ptr, int dtype, int Dh, int H,
              int rows, int B, long long ld) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)ld * 2,
                                 (cuuint64_t)rows * ld * 2};
  const cuuint32_t box[4] = {kPanel, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map,
             dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What the wgmma kernels take (kernels/attention.py:backward_variant
// chooses them only then).
bool wgmma_shape(int B, int T, int S, int H, int Dh, long long ld, int dtype,
                 std::initializer_list<const void*> ptrs) {
  if (bad_shape(B, T, S, H, Dh) || Dh > 256 || Dh % 16 != 0 || ld % 8 != 0 ||
      (dtype != 1 && dtype != 2))
    return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return false;
  return true;
}

size_t ring_bytes(int Dh) {
  return 1024 + (size_t)((Dh + kPanel - 1) / kPanel) * kPanelBytes *
                    (2 + 2 * kStages) +
         8 * (1 + 2 * kStages);
}

template <typename T, int OC>
int launch_dq_wgmma(const CUtensorMap (&m)[4], const void* o,
                    const void* dout, const float* lse, void* dq,
                    float* dsum, int B, int Tq, int S, int H, int Dh,
                    long long ld, int causal, float sm_scale,
                    cudaStream_t stream) {
  const int NP = (Dh + kPanel - 1) / kPanel;
  const size_t smem = ring_bytes(Dh);
  auto kernel = flash_bwd_dq_wgmma<T, OC>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Tq + kRows - 1) / kRows, (NP + OC - 1) / OC);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), dsum, Tq, S, H,
      Dh, ld, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv_wgmma(const CUtensorMap (&m)[4], const float* lse,
                     const float* dsum, void* dk, void* dv, int B, int Tq,
                     int S, int H, int Dh, long long ld, int causal,
                     float sm_scale, cudaStream_t stream) {
  const int NP = (Dh + kPanel - 1) / kPanel;
  const size_t smem = ring_bytes(Dh) + sizeof(float) * 2 * kStages * kRows;
  auto kernel = flash_bwd_dkv_wgmma<T>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + kRows - 1) / kRows, NP);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, static_cast<T*>(dk),
      static_cast<T*>(dv), Tq, S, H, Dh, ld, causal, sm_scale);
  return (int)cudaGetLastError();
}

bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
               const void* v, const void* dout, int dtype, int B, int T,
               int S, int H, int Dh, long long ld) {
  return tile_map(&m[0], q, dtype, Dh, H, T, B, ld) &&
         tile_map(&m[1], k, dtype, Dh, H, S, B, ld) &&
         tile_map(&m[2], v, dtype, Dh, H, S, B, ld) &&
         tile_map(&m[3], dout, dtype, Dh, H, T, B, ld);
}

}  // namespace

// dq [B, T, H, Dh] and dsum = rowsum(do * o) [B, H, T] (f32), as
// dl4j_flash_attn_bwd_dq_simt, on the tensor cores: dtype 1 (bfloat16) or 2
// (float16), Dh a multiple of 16 up to 256, ld a multiple of 8, every
// pointer 16-byte aligned; anything else returns cudaErrorInvalidValue.
extern "C" int dl4j_flash_attn_bwd_dq_wgmma(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* dout,
                                            const float* lse, void* dq,
                                            float* dsum, int B, int T, int S,
                                            int H, int Dh, long long ld,
                                            int causal, float sm_scale,
                                            int dtype, void* stream) {
  CUtensorMap m[4];
  if (!wgmma_shape(B, T, S, H, Dh, ld, dtype, {q, k, v, o, dout, dq}) ||
      !make_maps(m, q, k, v, dout, dtype, B, T, S, H, Dh, ld))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = Dh > kPanel;
  if (dtype == 1)
    return wide ? launch_dq_wgmma<__nv_bfloat16, 2>(m, o, dout, lse, dq,
                                                    dsum, B, T, S, H, Dh, ld,
                                                    causal, sm_scale, st)
                : launch_dq_wgmma<__nv_bfloat16, 1>(m, o, dout, lse, dq,
                                                    dsum, B, T, S, H, Dh, ld,
                                                    causal, sm_scale, st);
  return wide ? launch_dq_wgmma<__half, 2>(m, o, dout, lse, dq, dsum, B, T,
                                           S, H, Dh, ld, causal, sm_scale,
                                           st)
              : launch_dq_wgmma<__half, 1>(m, o, dout, lse, dq, dsum, B, T,
                                           S, H, Dh, ld, causal, sm_scale,
                                           st);
}

// dk, dv [B, S, H, Dh], as dl4j_flash_attn_bwd_dkv_simt, on the tensor
// cores; the same conditions as the dq entry.
extern "C" int dl4j_flash_attn_bwd_dkv_wgmma(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const float* lse,
                                             const float* dsum, void* dk,
                                             void* dv, int B, int T, int S,
                                             int H, int Dh, long long ld,
                                             int causal, float sm_scale,
                                             int dtype, void* stream) {
  CUtensorMap m[4];
  if (!wgmma_shape(B, T, S, H, Dh, ld, dtype, {q, k, v, dout, dk, dv}) ||
      !make_maps(m, q, k, v, dout, dtype, B, T, S, H, Dh, ld))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_dkv_wgmma<__nv_bfloat16>(m, lse, dsum, dk, dv, B, T, S, H,
                                           Dh, ld, causal, sm_scale, st);
  return launch_dkv_wgmma<__half>(m, lse, dsum, dk, dv, B, T, S, H, Dh, ld,
                                  causal, sm_scale, st);
}
