// Flash-attention forward at head dims 256, 384 and 512 for Hopper (sm_90a)
// on wgmma, with Q, K and V fed by TMA: O = softmax(Q K^T * s) V and the
// per-row logsumexp, bf16 in and out, fp32 logits, softmax and accumulators.
//
// Replaces the Pallas TPU kernel of edtr_tpu/ops/flash_attention.py
// _fwd_kernel_streamkv (_streamkv_fwd_flat, its pallas_call at :268), which
// JAX runs for 128 < D <= 512 (the VAE's mid-block attention, D 512). The
// function is theirs and plain_fwd's: the scale applied to the fp32
// logits, P rounded to bf16 before the PV product, l summed from the fp32
// P, O = acc / l stored in bf16 once, lse = m + log(l) in fp32.
//
// What bounds it on an H100: 4 N^2 D FLOP a head on 8 N D bytes, far above
// the card's ~295 FLOP/byte ridge, so the tensor cores (989 TFLOP/s dense
// bf16; 34.4 GFLOP, 0.035 ms, at the restore's (1, 4096, 512)). Each block
// re-reads its head's K and V from L2, N D 4 bytes for 64 query rows, so
// L2's bandwidth is the next limit. The mma.sync kernel before it
// (flash_fwd_d512_kernel: 32-row query blocks and K/V tiles, each of 8
// warps a 16 x 8 logit sub-tile over all 512 of depth, the logit tile
// through shared memory between barriers, ~1.07 GB of L2 reads a call) took
// 0.323 ms, ~106 TFLOP/s, on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md). Here:
//
// 1. A block owns 64 query rows (wgmma's M). The 64 x D fp32 output does
//    not fit one warpgroup's registers at D 512 (128 registers a thread for
//    64 x 256), so two consumer warpgroups split D: warpgroup g owns the
//    columns [g D/2, (g+1) D/2) of O (128, 192 or 256: 2 to 4 wgmma n64
//    accumulators).
// 2. TMA feeds it. A producer warp loads the block's Q once (D/64 boxes of
//    64 rows x 128 bytes in the 128-byte swizzle: wgmma's K-major A) and
//    streams the head's K and V tiles (64 rows at D 256, 32 above it; D/64
//    boxes each) through separate rings of 2 or 3 stages (tile_rows,
//    stages), so that the loads of the next tiles land while this one's
//    S, softmax and PV run. A K stage is freed when both warpgroups' S
//    wgmmas retire, a V stage when their PV ones do. The producer is a
//    warpgroup that gives its registers to the consumers (setmaxnreg): the
//    O accumulators alone take 128 a thread at D 512, and a 168-register
//    build spilled.
// 3. S = Q K^T: each warpgroup computes its partial over its half of D
//    (wgmma m64nBNk16, A and B from shared memory), writes it to shared
//    memory register-major, reads the other's and adds: partial 0 +
//    partial 1 in fp32, the same bits in both, so both hold the whole S
//    and run the same online softmax (exp2 of s * scale * log2(e) - m *
//    scale * log2(e); the row max and sum over a quad). P, rounded to bf16
//    in pairs, is already the register A operand of O += P V (m64n64k16
//    with V read MN-major, the transpose bit of bf16 wgmma), so P never
//    goes through shared memory. The PV of tile j is left in flight while
//    the S of tile j + 1 is issued.
// 4. The grid: 64-row blocks of every head, one block an SM (at D 512, Q,
//    two K and two V stages and the S exchange take 208 KB). Where that
//    leaves more than half the SMs idle (the restore's (1, 4096, 512): 64
//    blocks), the KV range is split in two (ops/flash_attention.py:
//    streamkv_splits): each block writes its fp32 (acc, m, l) to scratch,
//    and the block of a query block that arrives last (an arrival counter
//    a query block, which it sets back to 0) combines the two in the fixed
//    order split 0, split 1 and rounds O once, so that two calls agree bit
//    for bit.

#pragma once

#include <atomic>
#include <climits>

#include "sm90.cuh"

namespace edtr_streamkv {

using namespace edtr_sm90;

constexpr int BM = 64;                 // query rows a block
constexpr int kRow = 128;              // bytes of a 64-column box row
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup (one thread
// issues the loads) hands most of its share to the consumers, whose O
// accumulators take 128 a thread at D 512
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// K/V rows a tile and ring stages beside Q and the S exchange: two stages
// of 64-row tiles at D 256; 32-row tiles above it, two stages at D 512 and
// three at D 384 (a 64-row plan has room for one stage there, which left
// every K and V load exposed: ~0.3 ms at (1, 4096, 512) on an NVIDIA H100
// 80GB HBM3 at 700 W)
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D <= 256 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int stages() {
  return D == 384 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  // alignment slack, Q, the K and V rings, the S exchange (two 64 x BN fp32
  // partials; the output staging at the end), the barriers
  return 1024 + BM * D * 2 + 2 * stages<D>() * tile_rows<D>() * D * 2 +
         2 * BM * tile_rows<D>() * 4 + (1 + 4 * stages<D>()) * 8 + 16;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

struct Args {
  bf16* o;          // (BH * N, D)
  float* lse;       // (BH * N)
  float* part;      // splits 2: (2, BH * N, D) fp32 unnormalised O
  float* ml;        // splits 2: (2, BH * N, 2) fp32 (m, l)
  int* counters;    // splits 2: BH * N / 64 arrival counters, zero
  int n;
  int splits;
  float scale;
};

// grid (N / 64, BH, splits): query block, head, KV split
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    streamkv_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const Args p) {
  constexpr int ST = stages<D>();
  constexpr int BN = tile_rows<D>();
  constexpr int DC = D / 64;             // 64-column chunks of a row
  constexpr int HC = DC / 2;             // a warpgroup's chunks: its half of D
  constexpr int QBYTES = BM * D * 2;
  constexpr int TILE = BN * D * 2;       // a K or V tile: DC chunks of BN x 128 bytes
  constexpr int SR = BN / 2;             // S accumulator registers a thread
  static_assert(D % 128 == 0 && D <= 512, "head dim");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sQ = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // [DC][64][128 B]
  uint8_t* sK = sQ + QBYTES;                                     // [ST][DC][BN][128 B]
  uint8_t* sV = sK + ST * TILE;
  float4* sS = reinterpret_cast<float4*>(sV + ST * TILE);        // [2][SR / 4][128]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sS + 2 * (SR / 4) * 128);
  uint64_t* kfull = qbar + 1;
  uint64_t* kempty = kfull + ST;
  uint64_t* vfull = kempty + ST;
  uint64_t* vempty = vfull + ST;
  int* last = reinterpret_cast<int*>(vempty + ST);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head = (size_t)blockIdx.y * p.n;
  const int row0 = (int)(head + (size_t)blockIdx.x * BM);  // the block's first query row
  const int per = p.n / BN / p.splits;                     // K/V tiles of a split
  const int j0 = blockIdx.z * per;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 2);  // one arrival a warpgroup
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer: Q, then the split's K and V tiles in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(qbar, QBYTES);
      for (int c = 0; c < DC; ++c) tma_load_2d(sQ + c * BM * kRow, &qmap, qbar, c * 64, row0);
      for (int i = 0; i < per; ++i) {
        const int s = i % ST;
        const uint32_t ph = ((i / ST) & 1) ^ 1;
        const int row = (int)(head + (size_t)(j0 + i) * BN);
        mbar_wait(&kempty[s], ph);
        mbar_expect_tx(&kfull[s], TILE);
        for (int c = 0; c < DC; ++c)
          tma_load_2d(sK + s * TILE + c * BN * kRow, &kmap, &kfull[s], c * 64, row);
        mbar_wait(&vempty[s], ph);
        mbar_expect_tx(&vfull[s], TILE);
        for (int c = 0; c < DC; ++c)
          tma_load_2d(sV + s * TILE + c * BN * kRow, &vmap, &vfull[s], c * 64, row);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: warp w4 holds rows w4 * 16 + gq and + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, w4 = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int t128 = tid & 127;
  const bool leader = t128 == 0;
  const float c = p.scale * kLog2e;
  const uint32_t q0 = smem_u32(sQ) + wg * HC * BM * kRow;
  const uint32_t k0 = smem_u32(sK) + wg * HC * BN * kRow;
  const uint32_t v0 = smem_u32(sV) + wg * HC * BN * kRow;
  float sacc[SR], oacc[HC][32];
#pragma unroll
  for (int h = 0; h < HC; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[h][i] = 0.f;
  uint32_t pf[BN / 16][4];  // P as the register A of O += P V, k-step kk
  float m0 = kNegInf, m1 = kNegInf;  // rows gq, gq + 8: max of the raw logits
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums
  float4* mine = sS + wg * (SR / 4) * 128;
  const float4* other = sS + (wg ^ 1) * (SR / 4) * 128;

  mbar_wait(qbar, 0);
  for (int i = 0; i < per; ++i) {
    const int s = i % ST;
    const uint32_t ph = (i / ST) & 1;
    mbar_wait(&kfull[s], ph);
#pragma unroll
    for (int r = 0; r < SR; ++r) sacc[r] = 0.f;
    fence_operands(sacc);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < HC; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<BN>::mma(sacc, sw128_desc(q0 + h * BM * kRow + kk * 32),
                       sw128_desc(k0 + s * TILE + h * BN * kRow + kk * 32));
    wgmma_commit();
    wgmma_wait<0>();  // this tile's S and the PV of the one before
    fence_operands(sacc);
#pragma unroll
    for (int h = 0; h < HC; ++h) fence_operands(oacc[h]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_operands(pf[kk]);
    if (leader) {
      mbar_arrive(&kempty[s]);
      if (i > 0) mbar_arrive(&vempty[(i - 1) % ST]);
    }

    // S = partial 0 + partial 1, the same sum in both warpgroups
#pragma unroll
    for (int r = 0; r < SR / 4; ++r)
      mine[r * 128 + t128] =
          make_float4(sacc[4 * r], sacc[4 * r + 1], sacc[4 * r + 2], sacc[4 * r + 3]);
    consumer_sync();
#pragma unroll
    for (int r = 0; r < SR / 4; ++r) {
      const float4 o = other[r * 128 + t128];
      sacc[4 * r] += o.x;
      sacc[4 * r + 1] += o.y;
      sacc[4 * r + 2] += o.z;
      sacc[4 * r + 3] += o.w;
    }
    consumer_sync();  // both read before the next tile's partials overwrite them

    // online softmax over the tile's BN columns
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
    for (int h = 0; h < HC; ++h)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        oacc[h][4 * t] *= alpha0;
        oacc[h][4 * t + 1] *= alpha0;
        oacc[h][4 * t + 2] *= alpha1;
        oacc[h][4 * t + 3] *= alpha1;
      }

    mbar_wait(&vfull[s], ph);
#pragma unroll
    for (int h = 0; h < HC; ++h) fence_operands(oacc[h]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_operands(pf[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < HC; ++h)
        WgmmaRS<64, 1>::mma(oacc[h], pf[kk],
                            sw128_mn_desc(v0 + s * TILE + h * BN * kRow + kk * 16 * kRow));
    wgmma_commit();  // waited for with the next tile's S, or below
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < HC; ++h) fence_operands(oacc[h]);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = row0 + w4 * 16 + gq;  // this thread's rows r0, r0 + 8

  if (p.splits == 1) {
    // O: the accumulator (register 4t + 2h + e of oacc[hc]: row gq + 8h,
    // column 64 hc + 8t + 2tq + e of the half) scaled by 1 / l, 16 columns
    // at a time through the warp's staging (the S exchange, free now)
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* wstg = reinterpret_cast<bf16*>(sS) + warp * STG_WARP;
    bf16* orow = p.o + (size_t)(row0 + w4 * 16 + (lane >> 1)) * D + wg * (D / 2);
#pragma unroll
    for (int h = 0; h < HC; ++h)
#pragma unroll
      for (int t = 0; t < 8; t += 2) {
        float ov[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) ov[i] = oacc[h][4 * t + i] * ((i & 2) ? inv1 : inv0);
        store16x16_rows(wstg, ov, lane, orow + h * 64 + 8 * t);
      }
    if (wg == 0 && tq == 0) {
      p.lse[r0] = m0 * p.scale + logf(l0);
      p.lse[r0 + 8] = m1 * p.scale + logf(l1);
    }
    return;
  }

  // split: this block's (acc, m, l) to scratch; the query block's last
  // arrival combines both splits
  const size_t rows = (size_t)gridDim.y * p.n;
  float* part = p.part + (size_t)blockIdx.z * rows * D;
#pragma unroll
  for (int h = 0; h < HC; ++h)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = wg * (D / 2) + h * 64 + 8 * t + 2 * tq;
      *reinterpret_cast<float2*>(part + (size_t)r0 * D + col) =
          make_float2(oacc[h][4 * t], oacc[h][4 * t + 1]);
      *reinterpret_cast<float2*>(part + (size_t)(r0 + 8) * D + col) =
          make_float2(oacc[h][4 * t + 2], oacc[h][4 * t + 3]);
    }
  if (wg == 0 && tq == 0) {
    float2* ml = reinterpret_cast<float2*>(p.ml) + (size_t)blockIdx.z * rows;
    ml[r0] = make_float2(m0, l0);
    ml[r0 + 8] = make_float2(m1, l1);
  }
  __threadfence();
  consumer_sync();
  if (tid == 0) {
    int* cnt = p.counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const int arrived = atomicAdd(cnt, 1) + 1;
    *last = arrived == p.splits;
    if (arrived == p.splits) *cnt = 0;  // zero again for the next launch
  }
  consumer_sync();
  if (!*last) return;
  __threadfence();
  // O = (acc0 a0 + acc1 a1) / (l0 a0 + l1 a1), a_i = exp(m_i - m): 8 columns
  // a thread at a time, rows in order
  const float2* ml0 = reinterpret_cast<const float2*>(p.ml);
  const float2* ml1 = ml0 + rows;
  const float* part0 = p.part;
  const float* part1 = p.part + rows * D;
  for (int u = tid; u < BM * (D / 8); u += kConsumers) {
    const size_t r = (size_t)row0 + u / (D / 8);
    const int col = (u % (D / 8)) * 8;
    const float2 a = __ldcg(ml0 + r), b = __ldcg(ml1 + r);
    const float m = fmaxf(a.x, b.x);
    const float wa = ex2((a.x - m) * c), wb = ex2((b.x - m) * c);
    const float l = a.y * wa + b.y * wb;
    const float inv = 1.f / l;
    const float4* x0 = reinterpret_cast<const float4*>(part0 + r * D + col);
    const float4* x1 = reinterpret_cast<const float4*>(part1 + r * D + col);
    const float4 a0 = __ldcg(x0), a1 = __ldcg(x0 + 1), b0 = __ldcg(x1), b1 = __ldcg(x1 + 1);
    uint4 o;
    o.x = edtr::pack_bf16((a0.x * wa + b0.x * wb) * inv, (a0.y * wa + b0.y * wb) * inv);
    o.y = edtr::pack_bf16((a0.z * wa + b0.z * wb) * inv, (a0.w * wa + b0.w * wb) * inv);
    o.z = edtr::pack_bf16((a1.x * wa + b1.x * wb) * inv, (a1.y * wa + b1.y * wb) * inv);
    o.w = edtr::pack_bf16((a1.z * wa + b1.z * wb) * inv, (a1.w * wa + b1.w * wb) * inv);
    *reinterpret_cast<uint4*>(p.o + r * D + col) = o;
    if (col == 0) p.lse[r] = m * p.scale + logf(l);
  }
}

// One launch over (n / 64) x bh x splits blocks. q/k/v/o contiguous (bh, n,
// D) bf16, 16-byte aligned; lse (bh, n) fp32; n a multiple of 64 * splits;
// scale > 0 (the row max is taken over the raw logits); splits 2: part (2,
// bh, n, D) fp32, ml (2, bh, n, 2) fp32 and bh * n / 64 zeroed counters.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, void* part,
           void* ml, void* counters, int bh, int n, int splits, float scale,
           cudaStream_t stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || (splits != 1 && splits != 2) ||
      n % (64 * splits) || !(scale > 0.f) || (long long)bh * n > INT_MAX ||
      (splits == 2 && (part == nullptr || ml == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D>();
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(streamkv_kernel<D>, smem, raised, true);
  CUtensorMap qmap, kmap, vmap;
  if (r == 0) r = cached_matrix_map(q, bh * n, D, BM, &qmap);
  if (r == 0) r = cached_matrix_map(k, bh * n, D, tile_rows<D>(), &kmap);
  if (r == 0) r = cached_matrix_map(v, bh * n, D, tile_rows<D>(), &vmap);
  if (r != 0) return r;
  const Args a = {static_cast<bf16*>(o),     static_cast<float*>(lse),
                  static_cast<float*>(part), static_cast<float*>(ml),
                  static_cast<int*>(counters), n, splits, scale};
  dim3 grid(n / BM, bh, splits);
  streamkv_kernel<D><<<grid, kThreads, smem, stream>>>(qmap, kmap, vmap, a);
  return (int)cudaGetLastError();
}

}  // namespace edtr_streamkv
