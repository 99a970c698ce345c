// Flash-attention forward at head dim 64 for Hopper (sm_90a) on wgmma, with
// K and V fed by TMA: O = softmax(Q K^T * s) V and the per-row logsumexp,
// bf16 in and out, fp32 logits, softmax and accumulators.
//
// Replaces the Pallas TPU kernels of edtr_tpu/ops/flash_attention.py
// _qblock_wholekv_kernel (_qblock_wholekv_fwd_flat, its pallas_call at
// :187), _fwd_kernel (_flash_fwd_flat, :128) and _whole_fwd_kernel
// (_whole_fwd_flat, :356): one online-softmax walk over the whole K/V of a
// head serves all three. The function is theirs and plain_fwd's: the scale
// applied to the fp32 logits, P rounded to bf16 before the PV product, l
// summed from the fp32 P, O = acc / l stored in bf16, lse = m + log(l) in
// fp32.
//
// What bounds it on an H100: 4 N^2 D FLOP a head on 8 N D bytes, far above
// the card's ~295 FLOP/byte ridge, so the tensor cores (989 TFLOP/s dense
// bf16); at D = 64 the softmax's exponentials (16 a clock an SM) take about
// as long as the two products, so the MMAs of one block must run while
// another block's warps exponentiate. The mma.sync kernel before it
// (flash_fwd_d64_kernel, 4 warps from ldmatrix) reached 174 TFLOP/s at (5,
// 4096, 64) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md). Here:
//
// 1. Q in registers. A block's consumer warpgroup owns 64 query rows and
//    loads them once from device memory straight into the register layout
//    of wgmma's A operand (mma.sync's m16n8k16 A fragment, 16 registers a
//    thread), so both products read only B from shared memory.
// 2. K and V by TMA. A producer warp keeps a ring of STAGES (K, V) tile
//    pairs of BN rows full. A row is 64 bf16 = 128 bytes, one 128-byte
//    swizzle atom wide, so a tile lands in exactly the layout wgmma reads:
//    K-major for K (S = Q K^T) and MN-major for V (O += P V, the transpose
//    bit of bf16 wgmma). A stage is freed once the PV that read its V has
//    retired.
// 3. S = Q K^T as wgmma m64nBNk16 with A from registers, four k-steps. The
//    online softmax runs in registers (exp2 of s * scale * log2(e) - m *
//    scale * log2(e), one FFMA and one MUFU an element; the row's max and
//    sum over the four threads of a quad); P, rounded to bf16 in pairs, is
//    already the register A operand of O += P V (m64n64k16, BN / 16 k-steps),
//    so P never goes through shared memory.
// 4. The PV of tile j is left in flight while the S of tile j + 1 is
//    issued; the wait for both comes before tile j + 1's softmax, which
//    rescales O.
// 5. The grid is one block per 64 query rows of a head, several blocks
//    resident on an SM, so that one block's softmax overlaps another's MMAs
//    (the scheduler interleaves them; no ping-pong barrier), and 64-row
//    blocks keep the last wave short: (5, 4096) gives 320 blocks, at most 3
//    on an SM against 2.42 on average.
//
// Two tile plans (BN, STAGES, MINB) are built (flash_attention.cu):
// 64-row K/V tiles, 3 stages, 3 blocks an SM (122 registers), where the
// grid fills the card; 128-row tiles, 2 stages, 2 blocks an SM, where it
// does not (ops/flash_attention.py:flash_plan). Plans that spilled (64-row
// tiles at 4 blocks an SM, two consumer warpgroups at 2) gave wrong O on an
// NVIDIA H100 80GB HBM3 and are not built.

#pragma once

#include <atomic>
#include <climits>

#include "sm90.cuh"

namespace edtr_flash {

using namespace edtr_sm90;

constexpr int D = 64;
constexpr int ROW_BYTES = D * 2;  // one 128-byte swizzle row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

struct Args {
  const bf16* q;  // (BH * N, 64)
  bf16* o;        // (BH * N, 64)
  float* lse;     // (BH * N)
  int n;
  float scale;
};

constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp

template <int BN, int STAGES>
constexpr int smem_bytes() {
  // alignment slack, the (K, V) ring, the output staging, the barriers
  return 1024 + STAGES * 2 * BN * ROW_BYTES + 4 * STG_WARP * 2 + 2 * STAGES * 8;
}

// A block: 64 query rows of one head, BN-row K/V tiles through a ring of
// STAGES, MINB blocks resident on an SM.
template <int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const Args p) {
  constexpr int TILE_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  constexpr int SR = BN / 2;  // S accumulator registers a thread
  static_assert(BN % 16 == 0 && BN <= 256 && TILE_BYTES % 1024 == 0, "tile shape");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sKV = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  bf16* stg = reinterpret_cast<bf16*>(sKV + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 4 * STG_WARP);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head = (size_t)blockIdx.y * p.n;  // the head's first row
  const int nkv = p.n / BN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer: the head's K and V tiles, in order, into the ring
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int j = 0; j < nkv; ++j) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        uint8_t* dst = sKV + s * STAGE_BYTES;
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

  // ---- the consumer warpgroup: warp w holds rows r0 + gq and r0 + gq + 8
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * 64 + warp * 16;
  uint32_t qf[D / 16][4];  // Q as the register A of S = Q K^T, k-step kk
  {
    const bf16* q0 = p.q + (head + r0 + gq) * D + 2 * tq;
    const bf16* q1 = q0 + 8 * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = ld32(q0 + 16 * kk);
      qf[kk][1] = ld32(q1 + 16 * kk);
      qf[kk][2] = ld32(q0 + 16 * kk + 8);
      qf[kk][3] = ld32(q1 + 16 * kk + 8);
    }
  }
  const float c = p.scale * kLog2e;
  const uint32_t kv0 = smem_u32(sKV);
  const bool leader = tid == 0;
  float sacc[SR], oacc[D / 2];
#pragma unroll
  for (int i = 0; i < SR; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  uint32_t pf[BN / 16][4];  // P as the register A of O += P V, k-step kk
  float m0 = kNegInf, m1 = kNegInf;  // rows gq, gq + 8: max of the raw logits
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums

  for (int j = 0; j < nkv; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t kaddr = kv0 + s * STAGE_BYTES;
    fence_operands(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      WgmmaRS<BN, 0>::mma(sacc, qf[kk], sw128_desc(kaddr + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();  // S of this tile and the PV of the one before
    fence_operands(sacc);
    fence_operands(oacc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_operands(pf[kk]);
    if (j > 0 && leader) mbar_arrive(&empty[(j - 1) % STAGES]);

    // online softmax over this tile's BN columns
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * t], sacc[4 * t + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * t + 2], sacc[4 * t + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = ex2((m0 - mx0) * c), alpha1 = ex2((m1 - mx1) * c);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * c, mc1 = mx1 * c;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const float p00 = ex2(fmaf(sacc[4 * t], c, -mc0));
      const float p01 = ex2(fmaf(sacc[4 * t + 1], c, -mc0));
      const float p10 = ex2(fmaf(sacc[4 * t + 2], c, -mc1));
      const float p11 = ex2(fmaf(sacc[4 * t + 3], c, -mc1));
      ls0 += p00 + p01;
      ls1 += p10 + p11;
      pf[t / 2][2 * (t & 1)] = edtr::pack_bf16(p00, p01);
      pf[t / 2][2 * (t & 1) + 1] = edtr::pack_bf16(p10, p11);
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      oacc[4 * t] *= alpha0;
      oacc[4 * t + 1] *= alpha0;
      oacc[4 * t + 2] *= alpha1;
      oacc[4 * t + 3] *= alpha1;
    }

    fence_operands(oacc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_operands(pf[kk]);
    wgmma_fence();
    const uint32_t vaddr = kaddr + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      WgmmaRS<64, 1>::mma(oacc, pf[kk], sw128_mn_desc(vaddr + kk * 16 * ROW_BYTES));
    wgmma_commit();  // waited for with the next tile's S, or below
  }
  wgmma_wait<0>();
  fence_operands(oacc);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // O: the accumulator (register 4t + 2h + e: row gq + 8h, column 8t + 2tq +
  // e) scaled by 1 / l, 16 columns at a time through the warp's staging
  bf16* wstg = stg + warp * STG_WARP;
  bf16* orow = p.o + (head + r0 + (lane >> 1)) * D;
#pragma unroll
  for (int t = 0; t < D / 8; t += 2) {
    float ov[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ov[i] = oacc[4 * t + i] * ((i & 2) ? inv1 : inv0);
    store16x16_rows(wstg, ov, lane, orow + 8 * t);
  }
  if (tq == 0) {
    p.lse[head + r0 + gq] = m0 * p.scale + logf(l0);
    p.lse[head + r0 + gq + 8] = m1 * p.scale + logf(l1);
  }
}

// One launch over (n / 64) x bh blocks. q/k/v/o contiguous (bh, n, 64)
// bf16, 16-byte aligned; lse (bh, n) fp32; n a multiple of 64 and of BN;
// scale > 0 (the row max is taken over the raw logits).
template <int BN, int STAGES, int MINB>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
           float scale, cudaStream_t stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % 64 || n % BN || !(scale > 0.f) ||
      (long long)bh * n > INT_MAX)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BN, STAGES>();
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(flash_wgmma_kernel<BN, STAGES, MINB>, smem, raised, true);
  CUtensorMap kmap, vmap;
  if (r == 0) r = cached_matrix_map(k, bh * n, D, BN, &kmap);
  if (r == 0) r = cached_matrix_map(v, bh * n, D, BN, &vmap);
  if (r != 0) return r;
  const Args a = {static_cast<const bf16*>(q), static_cast<bf16*>(o), static_cast<float*>(lse),
                  n, scale};
  dim3 grid(n / 64, bh);
  flash_wgmma_kernel<BN, STAGES, MINB><<<grid, kThreads, smem, stream>>>(kmap, vmap, a);
  return (int)cudaGetLastError();
}

}  // namespace edtr_flash
