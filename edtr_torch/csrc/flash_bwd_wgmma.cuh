// Flash-attention backward at head dim 64 for Hopper (sm_90a) on wgmma, the
// streamed tiles fed by TMA: dQ, dK, dV from Q, K, V, dO, the forward's
// per-row logsumexp (lse) and D = rowsum(dO * O); bf16 in and out, fp32
// lse, D, logits and accumulators.
//
// Replaces the Pallas TPU kernels of edtr_tpu/ops/flash_attention.py:
//
//   flash_dq_wgmma_kernel  <- _dq_kernel (_flash_bwd_flat, N > 1024; its
//                             pallas_call at :445) and the dq half of
//                             _whole_bwd_kernel (_whole_bwd_flat, N <= 1024,
//                             :373);
//   flash_dkv_wgmma_kernel <- _dkv_kernel (_flash_bwd_flat, :468) and the
//                             dk/dv half of _whole_bwd_kernel.
//
// The function is theirs and _xla_bwd_flat's, cast for cast:
//   s  = fp32 (Q K^T) * scale,       p = exp(s - lse)           (fp32)
//   dV = bf16(p)^T dO               (fp32 accumulation)
//   dP = dO V^T                      (fp32)
//   dS = bf16(p * (dP - D))
//   dQ = (dS K) * scale,  dK = (dS^T Q) * scale   (fp32 accumulation)
// and each gradient rounded once to bf16. p is taken as
// exp2(s * scale * log2(e) - lse * log2(e)): one FFMA and one MUFU.EX2 an
// element, as the forward (flash_wgmma.cuh) takes its exponentials.
//
// What bounds it on an H100: the function is 5 products of 2 N^2 D FLOP a
// head on 7 N D bf16 and 2 N fp32 values, far above the card's ~295
// FLOP/byte ridge, so the tensor cores (989 TFLOP/s dense bf16). A Hopper
// block holds no N x N slab, so the work is split as FlashAttention-2 splits
// it, deterministic and without atomics: one kernel walks K/V for a block of
// query rows (dQ), the other walks Q/dO for a block of KV rows (dK, dV), and
// each recomputes S and dP: 7 products where the function needs 5. The
// mma.sync pair before it (flash_bwd_dq_kernel, flash_bwd_dkv_kernel: 4 warps
// from ldmatrix, a cp.async double buffer refilled by the warps that
// compute) reached 273 and 246 TFLOP/s on those 7 products. Here:
//
// 1. The block's own 64 rows loaded once. A consumer warpgroup owns 64
//    rows. The dkv kernel loads its two A operands, K and V, from device
//    memory straight into wgmma's register-A layout (mma.sync's m16n8k16 A
//    fragment), so its products read only B from shared memory. The dq
//    kernel has the producer TMA-load its Q and dO tiles once into shared
//    memory and reads them there as A: 122 registers, so 3 blocks fit an SM
//    where register A fits 2. It keeps lse and D of its rows in
//    registers.
// 2. The streamed tiles by TMA. A producer warp keeps a ring of STAGES
//    stages full: (K, V) tiles of BN rows for dq; (Q, dO) tiles of BN rows
//    with their BN lse and D values (1-D bulk copies) for dkv. A row is 64
//    bf16 = 128 bytes, one 128-byte swizzle atom, so one staged tile is read
//    both ways: K-major as the B of S = Q K^T (dq) or S^T = K Q^T, dP^T = V
//    dO^T (dkv), and MN-major (the transpose bit) as the B of dQ += dS K or
//    dV += P^T dO, dK += dS^T Q.
// 3. P and dS never leave the registers. The S (dP) accumulator of a tile,
//    rounded to bf16 in pairs, is already the register A operand of the
//    tile's next product. The dkv kernel works in the transposed frame (its
//    rows are KV rows, its columns query rows), so P^T and dS^T are the A
//    operands of P^T dO and dS^T Q, and lse and D are per column, read from
//    the stage in shared memory.
// 4. Overlap. A tile's last products stay in flight while the next tile's S
//    and dP are issued; the wait for both comes before the next tile's
//    exponentials. The stage is freed once the products that read it have
//    retired. Several 64-row blocks are resident on an SM, so that one
//    block's exponentials run under another's MMAs.
// 5. Each block writes its own 64 rows once: two calls give bit-identical
//    gradients.
//
// Each kernel is built in one tile plan (BN, STAGES, MINB), in
// flash_attention_bwd.cu: dq with 64-row tiles in 3 stages at 3 blocks an
// SM (ptxas serialises its wgmmas for registers, C7512; the SM's other
// blocks hide the waits), dkv with 64-row tiles in 4 stages at 1 block an
// SM (221 registers; a 2-block build spills, and spilled builds of the
// flash forward gave wrong output). A plan where ptxas reports a spill is
// not built.

#pragma once

#include <atomic>
#include <climits>

#include "sm90.cuh"

namespace edtr_flash_bwd {

using namespace edtr_sm90;

constexpr int D = 64;
constexpr int ROW_BYTES = D * 2;  // one 128-byte swizzle row
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

struct Args {
  const bf16* a0;    // the dkv block's register A operands: k, (BH * N, 64)
  const bf16* a1;    // and v (the dq kernel reads q and dO by TMA)
  const float* lse;  // (BH * N)
  const float* dd;   // (BH * N): D
  bf16* o0;          // dq (dq) or dk (dkv)
  bf16* o1;          // dv (dkv)
  int n;
  float scale;
};

// the dkv kernel's K or V: 16 rows a warp, rows r and r + 8 of each
// k-step's 16 columns, as flash_wgmma.cuh loads Q: a[kk] is the register A
// of k-step kk over D
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* rows, int lane) {
  const bf16* r0 = rows + (lane >> 2) * D + 2 * (lane & 3);
  const bf16* r1 = r0 + 8 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld32(r0 + 16 * kk);
    a[kk][1] = ld32(r1 + 16 * kk);
    a[kk][2] = ld32(r0 + 16 * kk + 8);
    a[kk][3] = ld32(r1 + 16 * kk + 8);
  }
}

// a warp's 16 x 64 share of a 64 x 64 accumulator (register 4t + 2h + e: row
// 16 warp + lane / 4 + 8h, column 8t + 2 (lane % 4) + e), times mul, to
// `rows` (the warpgroup's first output row), 16 columns at a time through
// the warp's staging
__device__ __forceinline__ void store_acc(bf16* stg, const float (&acc)[D / 2], float mul,
                                          bf16* rows, int warp, int lane) {
  bf16* wstg = stg + warp * STG_WARP;
  bf16* orow = rows + (warp * 16 + (lane >> 1)) * D;
#pragma unroll
  for (int t = 0; t < D / 8; t += 2) {
    float ov[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ov[i] = acc[4 * t + i] * mul;
    store16x16_rows(wstg, ov, lane, orow + 8 * t);
  }
}

constexpr int OWN_BYTES = 2 * 64 * ROW_BYTES;  // the dq block's own Q and dO tiles

template <int BN, int STAGES>
constexpr int dq_smem_bytes() {
  // alignment slack, the (K, V) ring, the own tiles, the output staging, the
  // ring's barriers and the own tiles'
  return 1024 + STAGES * 2 * BN * ROW_BYTES + OWN_BYTES + 4 * STG_WARP * 2 + 2 * STAGES * 8 + 8;
}

template <int BN, int STAGES>
constexpr int dkv_smem_bytes() {
  // alignment slack, the (Q, dO) ring, its (lse, D) ring, the output
  // staging, the barriers
  return 1024 + STAGES * 2 * BN * ROW_BYTES + STAGES * 2 * BN * 4 + 4 * STG_WARP * 2 +
         2 * STAGES * 8;
}

// a stage is full when the producer's copies have landed, and empty when
// each of the 4 consumer warps has retired the products that read it (the
// dkv kernel's warps also read its lse and D with plain loads)
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], 4);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// dQ of 64 query rows of one head: the block's Q and dO tiles loaded once,
// K/V tiles of BN rows through a ring of STAGES, MINB blocks resident on an
// SM.
template <int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap omap, const Args p) {
  constexpr int TILE_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  constexpr int SR = BN / 2;  // S (dP) accumulator registers a thread
  static_assert(BN % 16 == 0 && BN <= 128 && TILE_BYTES % 1024 == 0, "tile shape");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* own = ring + STAGES * STAGE_BYTES;  // Q, then dO, of the block's rows
  bf16* stg = reinterpret_cast<bf16*>(own + OWN_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 4 * STG_WARP);
  uint64_t* empty = full + STAGES;
  uint64_t* owned = empty + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head = (size_t)blockIdx.y * p.n;  // the head's first row
  const size_t rows = head + blockIdx.x * 64;    // the block's first row
  const int ntiles = p.n / BN;

  if (tid == 0) {
    mbar_init(owned, 1);
    init_ring(full, empty, STAGES);
  }
  __syncthreads();

  if (warp == 4) {  // producer: the block's Q and dO, then the head's K and V
    if (lane == 0) {  // tiles, in order, into the ring
      mbar_expect_tx(owned, OWN_BYTES);
      tma_load_2d(own, &qmap, owned, 0, (int)rows);
      tma_load_2d(own + OWN_BYTES / 2, &omap, owned, 0, (int)rows);
      int s = 0;
      uint32_t ph = 0;
      for (int j = 0; j < ntiles; ++j) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        uint8_t* dst = ring + s * STAGE_BYTES;
        const int row = (int)(head + (size_t)j * BN);
        tma_load_2d(dst, &kmap, &full[s], 0, row);
        tma_load_2d(dst + TILE_BYTES, &vmap, &full[s], 0, row);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: warp w holds rows r0 + lane / 4 (+ 8)
  const int gq = lane >> 2;
  const size_t r0 = rows + warp * 16;
  const float c = p.scale * kLog2e;
  const float l0 = p.lse[r0 + gq] * kLog2e, l1 = p.lse[r0 + gq + 8] * kLog2e;
  const float d0 = p.dd[r0 + gq], d1 = p.dd[r0 + gq + 8];
  const uint32_t ring0 = smem_u32(ring), qaddr = smem_u32(own), oaddr = qaddr + OWN_BYTES / 2;
  float sacc[SR], dpacc[SR], acc[D / 2];
#pragma unroll
  for (int i = 0; i < SR; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t dsf[BN / 16][4];  // dS as the register A of dQ += dS K, k-step kk
  mbar_wait(owned, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t kaddr = ring0 + s * STAGE_BYTES, vaddr = kaddr + TILE_BYTES;
    fence_operands(sacc);
    fence_operands(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
      Wgmma<BN>::mma(sacc, sw128_desc(qaddr + kk * 32), sw128_desc(kaddr + kk * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
      Wgmma<BN>::mma(dpacc, sw128_desc(oaddr + kk * 32), sw128_desc(vaddr + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();  // S and dP of this tile, and the dS K of the one before
    fence_operands(sacc);
    fence_operands(dpacc);
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_operands(dsf[kk]);
    if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);

    // dS = p (dP - D), p = exp2(s scale log2e - lse log2e), packed to bf16
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const float s00 = ex2(fmaf(sacc[4 * t], c, -l0)) * (dpacc[4 * t] - d0);
      const float s01 = ex2(fmaf(sacc[4 * t + 1], c, -l0)) * (dpacc[4 * t + 1] - d0);
      const float s10 = ex2(fmaf(sacc[4 * t + 2], c, -l1)) * (dpacc[4 * t + 2] - d1);
      const float s11 = ex2(fmaf(sacc[4 * t + 3], c, -l1)) * (dpacc[4 * t + 3] - d1);
      dsf[t / 2][2 * (t & 1)] = edtr::pack_bf16(s00, s01);
      dsf[t / 2][2 * (t & 1) + 1] = edtr::pack_bf16(s10, s11);
    }

    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_operands(dsf[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // dQ += dS K, K read MN-major
      WgmmaRS<64, 1>::mma(acc, dsf[kk], sw128_mn_desc(kaddr + kk * 16 * ROW_BYTES));
    wgmma_commit();  // waited for with the next tile's S and dP, or below
  }
  wgmma_wait<0>();
  fence_operands(acc);
  store_acc(stg, acc, p.scale, p.o0 + rows * D, warp, lane);
}

// dK and dV of 64 KV rows of one head: Q/dO tiles of BN rows (with their
// lse and D) through a ring of STAGES, MINB blocks resident on an SM.
template <int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap omap, const Args p) {
  constexpr int TILE_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  constexpr int VEC_BYTES = BN * 4;  // one tile's lse (or D)
  constexpr int SR = BN / 2;
  static_assert(BN % 16 == 0 && BN <= 128 && TILE_BYTES % 1024 == 0 && VEC_BYTES % 16 == 0,
                "tile shape");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  float* vecs = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);  // [STAGES][2][BN]
  bf16* stg = reinterpret_cast<bf16*>(vecs + STAGES * 2 * BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 4 * STG_WARP);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head = (size_t)blockIdx.y * p.n;
  const int ntiles = p.n / BN;

  if (tid == 0) init_ring(full, empty, STAGES);
  __syncthreads();

  if (warp == 4) {  // producer: the head's Q, dO, lse and D tiles into the ring
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int j = 0; j < ntiles; ++j) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES + 2 * VEC_BYTES);
        uint8_t* dst = ring + s * STAGE_BYTES;
        const size_t row = head + (size_t)j * BN;
        tma_load_2d(dst, &qmap, &full[s], 0, (int)row);
        tma_load_2d(dst + TILE_BYTES, &omap, &full[s], 0, (int)row);
        float* v = vecs + s * 2 * BN;
        bulk_load(v, p.lse + row, VEC_BYTES, &full[s]);
        bulk_load(v + BN, p.dd + row, VEC_BYTES, &full[s]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup, in the transposed frame: rows are this
  // block's KV rows, columns the tile's query rows
  const int tq = lane & 3;
  const size_t rows = head + blockIdx.x * 64;
  uint32_t kf[D / 16][4], vf[D / 16][4];  // K and V as register A operands
  load_a(kf, p.a0 + (rows + warp * 16) * D, lane);
  load_a(vf, p.a1 + (rows + warp * 16) * D, lane);
  const float c = p.scale * kLog2e;
  const uint32_t ring0 = smem_u32(ring);
  float sacc[SR], dpacc[SR], dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < SR; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pf[BN / 16][4], dsf[BN / 16][4];  // P^T and dS^T as register A operands

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t qaddr = ring0 + s * STAGE_BYTES, oaddr = qaddr + TILE_BYTES;
    const float* sl = vecs + s * 2 * BN;  // the tile's lse, then its D
    fence_operands(sacc);
    fence_operands(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
      WgmmaRS<BN, 0>::mma(sacc, kf[kk], sw128_desc(qaddr + kk * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
      WgmmaRS<BN, 0>::mma(dpacc, vf[kk], sw128_desc(oaddr + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();  // S^T and dP^T of this tile, and the dV, dK of the one before
    fence_operands(sacc);
    fence_operands(dpacc);
    fence_operands(dk);
    fence_operands(dv);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      fence_operands(pf[kk]);
      fence_operands(dsf[kk]);
    }
    if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);

    // P^T = exp2(s scale log2e - lse[col] log2e), dS^T = P^T (dP^T - D[col]),
    // both packed to bf16; this thread's columns are 8t + 2 tq + {0, 1}
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const float2 l = *reinterpret_cast<const float2*>(sl + 8 * t + 2 * tq);
      const float2 d = *reinterpret_cast<const float2*>(sl + BN + 8 * t + 2 * tq);
      const float lx = l.x * kLog2e, ly = l.y * kLog2e;
      const float p00 = ex2(fmaf(sacc[4 * t], c, -lx));
      const float p01 = ex2(fmaf(sacc[4 * t + 1], c, -ly));
      const float p10 = ex2(fmaf(sacc[4 * t + 2], c, -lx));
      const float p11 = ex2(fmaf(sacc[4 * t + 3], c, -ly));
      pf[t / 2][2 * (t & 1)] = edtr::pack_bf16(p00, p01);
      pf[t / 2][2 * (t & 1) + 1] = edtr::pack_bf16(p10, p11);
      dsf[t / 2][2 * (t & 1)] =
          edtr::pack_bf16(p00 * (dpacc[4 * t] - d.x), p01 * (dpacc[4 * t + 1] - d.y));
      dsf[t / 2][2 * (t & 1) + 1] =
          edtr::pack_bf16(p10 * (dpacc[4 * t + 2] - d.x), p11 * (dpacc[4 * t + 3] - d.y));
    }

    fence_operands(dk);
    fence_operands(dv);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      fence_operands(pf[kk]);
      fence_operands(dsf[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // dV += P^T dO, dO read MN-major
      WgmmaRS<64, 1>::mma(dv, pf[kk], sw128_mn_desc(oaddr + kk * 16 * ROW_BYTES));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // dK += dS^T Q, Q read MN-major
      WgmmaRS<64, 1>::mma(dk, dsf[kk], sw128_mn_desc(qaddr + kk * 16 * ROW_BYTES));
    wgmma_commit();  // waited for with the next tile's S^T and dP^T, or below
  }
  wgmma_wait<0>();
  fence_operands(dk);
  fence_operands(dv);
  store_acc(stg, dk, p.scale, p.o0 + rows * D, warp, lane);
  store_acc(stg, dv, 1.f, p.o1 + rows * D, warp, lane);
}

inline bool bad_shape(int bh, int n, int bn) {
  return bh <= 0 || bh > 65535 || n <= 0 || n % 64 || n % bn || (long long)bh * n > INT_MAX;
}

// One launch over (n / 64) x bh blocks. q/k/v/dout/dq contiguous (bh, n, 64)
// bf16, 16-byte aligned; lse and dd (bh, n) fp32, 16-byte aligned; n a
// multiple of 64 and of BN.
template <int BN, int STAGES, int MINB>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dd, void* dq, int bh, int n, float scale, cudaStream_t stream) {
  if (bad_shape(bh, n, BN)) return (int)cudaErrorInvalidValue;
  constexpr int smem = dq_smem_bytes<BN, STAGES>();
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(flash_dq_wgmma_kernel<BN, STAGES, MINB>, smem, raised, true);
  CUtensorMap kmap, vmap, qmap, omap;
  if (r == 0) r = cached_matrix_map(k, bh * n, D, BN, &kmap);
  if (r == 0) r = cached_matrix_map(v, bh * n, D, BN, &vmap);
  if (r == 0) r = cached_matrix_map(q, bh * n, D, 64, &qmap);
  if (r == 0) r = cached_matrix_map(dout, bh * n, D, 64, &omap);
  if (r != 0) return r;
  const Args a = {nullptr, nullptr, static_cast<const float*>(lse),
                  static_cast<const float*>(dd), static_cast<bf16*>(dq), nullptr, n, scale};
  flash_dq_wgmma_kernel<BN, STAGES, MINB><<<dim3(n / 64, bh), kThreads, smem, stream>>>(
      kmap, vmap, qmap, omap, a);
  return (int)cudaGetLastError();
}

// The same for dk and dv.
template <int BN, int STAGES, int MINB>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dd, void* dk, void* dv, int bh, int n, float scale,
               cudaStream_t stream) {
  if (bad_shape(bh, n, BN)) return (int)cudaErrorInvalidValue;
  constexpr int smem = dkv_smem_bytes<BN, STAGES>();
  static std::atomic<unsigned> raised{0u};
  int r =
      (int)edtr::raise_smem_once(flash_dkv_wgmma_kernel<BN, STAGES, MINB>, smem, raised, true);
  CUtensorMap qmap, omap;
  if (r == 0) r = cached_matrix_map(q, bh * n, D, BN, &qmap);
  if (r == 0) r = cached_matrix_map(dout, bh * n, D, BN, &omap);
  if (r != 0) return r;
  const Args a = {static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const float*>(lse), static_cast<const float*>(dd),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, scale};
  flash_dkv_wgmma_kernel<BN, STAGES, MINB><<<dim3(n / 64, bh), kThreads, smem, stream>>>(
      qmap, omap, a);
  return (int)cudaGetLastError();
}

}  // namespace edtr_flash_bwd
