// Flash-attention backward for Hopper (sm_90a), head dim 64: dQ, dK, dV from
// Q, K, V, dO, the forward's per-row logsumexp (lse) and D = rowsum(dO * O),
// bf16 in and out, fp32 lse/D/logits/accumulators.
//
// Replaces three Pallas TPU kernels of edtr_tpu/ops/flash_attention.py:
//
//   flash_bwd_dq_kernel   <- _dq_kernel (_flash_bwd_flat, N > 1024) and the
//                            dq half of _whole_bwd_kernel (_whole_bwd_flat,
//                            N <= 1024);
//   flash_bwd_dkv_kernel  <- _dkv_kernel (_flash_bwd_flat) and the dk/dv
//                            half of _whole_bwd_kernel.
//
// The function is the TPU kernels' (and _xla_bwd_flat's), cast for cast:
//   s  = fp32 (Q K^T) * scale,       p = exp(s - lse)           (fp32)
//   dV = bf16(p)^T dO               (fp32 accumulation)
//   dP = dO V^T                      (fp32)
//   dS = bf16(p * (dP - D))
//   dQ = (dS K) * scale,  dK = (dS^T Q) * scale   (fp32 accumulation)
// and each gradient rounded once to bf16.
//
// The TPU kernels keep an N x N (whole) or 512 x N (dq/dkv) fp32 slab in
// VMEM. A Hopper block has at most 227 KB of shared memory, so both kernels
// here tile N in 64-row tiles and recompute p from lse, as FlashAttention-2
// does; the split is deterministic and needs no atomics:
//
//   flash_bwd_dq_kernel:  a block owns 64 query rows (4 warps x 16). Q and dO
//     fragments stay in registers for the whole walk, with lse and D of the
//     thread's two rows; K/V tiles of 64 rows stream through a cp.async
//     double buffer. Per tile a warp computes its 16 x 64 S and dP, forms
//     dS in registers and re-packs it as the bf16 A operand of dS K (K read
//     with ldmatrix.trans).
//   flash_bwd_dkv_kernel: a block owns 64 KV rows (4 warps x 16). K and V
//     fragments stay in registers, dK and dV accumulate in registers; Q and
//     dO tiles of 64 rows stream through a cp.async double buffer with their
//     lse and D. Each warp works in the transposed frame: S^T = K Q^T and
//     dP^T = V dO^T (16 kv rows x 64 query columns), so P^T and dS^T are
//     already the A operands of P^T dO and dS^T Q (dO and Q read with
//     ldmatrix.trans).
//
// What bounds them on an H100: the function does 2.5x the forward's
// 4 N^2 D flops per head on 7 N D bf16 values and 2 N fp32 values, far above
// the ~295 flop/byte ridge, so the tensor cores bound it. The split design
// computes S twice (once per kernel), 5 + 2 = 7 of the forward's N^2 D
// products in all where the function needs 5. This first version issues
// mma.sync m16n8k16 (bf16 -> fp32) from ldmatrix fragments; it does not use
// wgmma/TMA/warp specialisation, so it cannot reach the dense bf16 peak.

#include <atomic>

#include "common.cuh"

namespace {

using namespace edtr;

constexpr int D = 64;
constexpr int BR = 64;          // rows a block owns: 4 warps x 16
constexpr int BT = 64;          // rows of each streamed tile
constexpr int LD = D + 8;       // padded smem row (elements): 144 B, ldmatrix conflict-free
constexpr int kThreads = 128;
constexpr size_t kTile = (size_t)BT * LD;  // elements of one staged tile
// own rows (2 tiles) + two double-buffered streamed tiles; the dkv kernel
// also stages lse and D of each streamed tile
constexpr size_t kSmemDq = 6 * kTile * sizeof(bf16);
constexpr size_t kSmemDkv = 6 * kTile * sizeof(bf16) + 2 * 2 * BT * sizeof(float);

__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int tid) {
  for (int c = tid; c < BT * (D / 8); c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    cp_async16(dst + r * LD + col, src + (size_t)r * D + col);
  }
}

// 64 fp32 values (one tile's lse or D) as 16 chunks of 16 bytes
__device__ __forceinline__ void load_vec(float* dst, const float* src, int tid) {
  if (tid < BT / 4) cp_async16(dst + tid * 4, src + tid * 4);
}

__device__ __forceinline__ void zero(float (&a)[D / 8][4]) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) a[t][0] = a[t][1] = a[t][2] = a[t][3] = 0.f;
}

// acc (16 x 64 per warp) += A (16 x 64, fragments of 4 k-steps) * B, where
// B[k][n] = tile[k][n] (row-major 64 x 64 tile, read transposed): dS K,
// P^T dO and dS^T Q.
__device__ __forceinline__ void mma_a_tile(float (&acc)[D / 8][4], const uint32_t (&a)[BT / 16][4],
                                           const bf16* tile, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + dp * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// s (16 x 64 per warp) = A (16 x 64 over d, 4 k-steps) * tile^T: Q K^T,
// dO V^T, K Q^T and V dO^T.
__device__ __forceinline__ void mma_tile_t(float (&s)[BT / 8][4], const uint32_t (&a)[D / 16][4],
                                           const bf16* tile, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int t = 0; t < BT / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int np = 0; np < BT / 16; ++np) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + ks * 16 + (mi & 1) * 8);
      mma_bf16(s[2 * np], a[ks], b[0], b[1]);
      mma_bf16(s[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// the A fragments of this warp's 16 rows of a staged 64 x 64 tile
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* tile, int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(a[ks], tile + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
}

// a 16 x 64 fp32 accumulator re-packed as the bf16 A operand of a product
// over its 64 columns (the forward's P -> PV re-pack)
__device__ __forceinline__ void pack_a(uint32_t (&a)[BT / 16][4], const float (&s)[BT / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// this warp's 16 x 64 accumulator, times mul, to rows r0.. of a (n, 64) bf16 output
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], int r0,
                                           int g, int tig, float mul) {
  bf16* o0 = out + (size_t)(r0 + g) * D;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[t][0] * mul, acc[t][1] * mul);
    *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[t][2] * mul, acc[t][3] * mul);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dd,
                        bf16* __restrict__ dq, int n, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kTile;       // dO rows of the block
  bf16* sK = sO + kTile;       // [2][BT][LD]
  bf16* sV = sK + 2 * kTile;   // [2][BT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BR;
  const size_t base = (size_t)bh * n * D;
  const bf16* kg = k + base;
  const bf16* vg = v + base;

  load_rows(sQ, q + base + (size_t)q0 * D, tid);
  load_rows(sO, dout + base + (size_t)q0 * D, tid);
  load_rows(sK, kg, tid);
  load_rows(sV, vg, tid);
  cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const size_t row0 = (size_t)bh * n + q0 + warp * 16 + g;
  const float lse0 = lse[row0], lse1 = lse[row0 + 8];
  const float dd0 = dd[row0], dd1 = dd[row0 + 8];

  uint32_t qf[D / 16][4], of[D / 16][4];
  float acc[D / 8][4];
  zero(acc);

  const int ntiles = n / BT;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < ntiles) {
      const int b = (j + 1) & 1;
      load_rows(sK + b * kTile, kg + (size_t)(j + 1) * BT * D, tid);
      load_rows(sV + b * kTile, vg + (size_t)(j + 1) * BT * D, tid);
      cp_async_commit();
    }
    if (j == 0) {
      load_a(qf, sQ, warp, lane);
      load_a(of, sO, warp, lane);
    }
    const bf16* cK = sK + (j & 1) * kTile;
    const bf16* cV = sV + (j & 1) * kTile;

    float s[BT / 8][4], dp[BT / 8][4];
    mma_tile_t(s, qf, cK, lane);   // S = Q K^T
    mma_tile_t(dp, of, cV, lane);  // dP = dO V^T
#pragma unroll
    for (int t = 0; t < BT / 8; ++t) {  // dS = p * (dP - D), p = exp(s * scale - lse)
      s[t][0] = __expf(s[t][0] * scale - lse0) * (dp[t][0] - dd0);
      s[t][1] = __expf(s[t][1] * scale - lse0) * (dp[t][1] - dd0);
      s[t][2] = __expf(s[t][2] * scale - lse1) * (dp[t][2] - dd1);
      s[t][3] = __expf(s[t][3] * scale - lse1) * (dp[t][3] - dd1);
    }
    uint32_t a[BT / 16][4];
    pack_a(a, s);             // bf16(dS)
    mma_a_tile(acc, a, cK, lane);  // dQ += dS K
  }
  store_rows(dq + base, acc, q0 + warp * 16, g, tig, scale);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile;
  bf16* sQ = sV + kTile;       // [2][BT][LD]
  bf16* sO = sQ + 2 * kTile;   // [2][BT][LD]: dO
  float* sL = reinterpret_cast<float*>(sO + 2 * kTile);  // [2][BT]: lse
  float* sD = sL + 2 * BT;                                // [2][BT]: D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BR;
  const size_t base = (size_t)bh * n * D;
  const bf16* qg = q + base;
  const bf16* og = dout + base;
  const float* lg = lse + (size_t)bh * n;
  const float* dg = dd + (size_t)bh * n;

  load_rows(sK, k + base + (size_t)k0 * D, tid);
  load_rows(sV, v + base + (size_t)k0 * D, tid);
  load_rows(sQ, qg, tid);
  load_rows(sO, og, tid);
  load_vec(sL, lg, tid);
  load_vec(sD, dg, tid);
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int ntiles = n / BT;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < ntiles) {
      const int b = (j + 1) & 1;
      const size_t off = (size_t)(j + 1) * BT;
      load_rows(sQ + b * kTile, qg + off * D, tid);
      load_rows(sO + b * kTile, og + off * D, tid);
      load_vec(sL + b * BT, lg + off, tid);
      load_vec(sD + b * BT, dg + off, tid);
      cp_async_commit();
    }
    if (j == 0) {
      load_a(kf, sK, warp, lane);
      load_a(vf, sV, warp, lane);
    }
    const bf16* cQ = sQ + (j & 1) * kTile;
    const bf16* cO = sO + (j & 1) * kTile;
    const float* cL = sL + (j & 1) * BT;
    const float* cD = sD + (j & 1) * BT;

    // the transposed frame: rows are this warp's kv rows, columns query rows
    float p[BT / 8][4], dp[BT / 8][4];
    mma_tile_t(p, kf, cQ, lane);  // S^T = K Q^T
#pragma unroll
    for (int t = 0; t < BT / 8; ++t) {  // P^T = exp(S^T * scale - lse[col])
      const float2 l = *reinterpret_cast<const float2*>(cL + t * 8 + tig * 2);
      p[t][0] = __expf(p[t][0] * scale - l.x);
      p[t][1] = __expf(p[t][1] * scale - l.y);
      p[t][2] = __expf(p[t][2] * scale - l.x);
      p[t][3] = __expf(p[t][3] * scale - l.y);
    }
    uint32_t a[BT / 16][4];
    pack_a(a, p);                    // bf16(P^T)
    mma_a_tile(dv_acc, a, cO, lane);  // dV += P^T dO
    mma_tile_t(dp, vf, cO, lane);    // dP^T = V dO^T
#pragma unroll
    for (int t = 0; t < BT / 8; ++t) {  // dS^T = P^T * (dP^T - D[col])
      const float2 d2 = *reinterpret_cast<const float2*>(cD + t * 8 + tig * 2);
      p[t][0] *= dp[t][0] - d2.x;
      p[t][1] *= dp[t][1] - d2.y;
      p[t][2] *= dp[t][2] - d2.x;
      p[t][3] *= dp[t][3] - d2.y;
    }
    pack_a(a, p);                    // bf16(dS^T)
    mma_a_tile(dk_acc, a, cQ, lane);  // dK += dS^T Q
  }
  store_rows(dk + base, dk_acc, k0 + warp * 16, g, tig, scale);
  store_rows(dv + base, dv_acc, k0 + warp * 16, g, tig, 1.f);
}

}  // namespace

// Plain C interface (loaded with ctypes). q/k/v/do/dq/dk/dv are contiguous
// (bh, n, 64) bf16, lse and dd (bh, n) fp32; n must be a multiple of 64
// (the Python wrappers check it). Launch on `stream`; return
// cudaGetLastError().
extern "C" int edtr_flash_bwd_dq_d64(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* dd,
                                     void* dq, int bh, int n, float scale, void* stream) {
  static std::atomic<unsigned> raised{0u};
  const cudaError_t err = raise_smem_once(flash_bwd_dq_kernel, kSmemDq, raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / BR, bh);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemDq, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dq), n, scale);
  return (int)cudaGetLastError();
}

extern "C" int edtr_flash_bwd_dkv_d64(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dd,
                                      void* dk, void* dv, int bh, int n, float scale,
                                      void* stream) {
  static std::atomic<unsigned> raised{0u};
  const cudaError_t err = raise_smem_once(flash_bwd_dkv_kernel, kSmemDkv, raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / BR, bh);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, scale);
  return (int)cudaGetLastError();
}
