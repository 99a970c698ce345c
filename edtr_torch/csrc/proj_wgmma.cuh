// Normalisation + projection GEMM for Hopper (sm_90a) on wgmma, with the
// weights streamed through a TMA ring; shared by ln_matmul.cu (K8a, K8b)
// and geglu.cu (K7a, K7b). bf16 tokens in, bf16 out, fp32 accumulation:
//
//   out = EPI(PRO(x) @ W^T)
//
// Replaces the Pallas TPU kernels edtr_tpu/ops/ln_matmul.py:_kernel
// (ln_matmuls, its pallas_call at :120) and _aff_kernel (affine_matmul,
// :201), and edtr_tpu/ops/geglu.py:_kernel (geglu_proj, :159) and
// _ln_kernel (ln_geglu_proj, :218). x is
// (M, C) tokens, row-major; W is the module's bf16 weight in nn.Linear
// layout (rows = output columns, C contiguous), which is already the
// K-major B operand of wgmma, so nothing is repacked.
//
// What bounds them on an H100: at the main-path shapes (256-4096 tokens, C
// 320-1280, 320-10240 weight rows) a product does 2*C FLOP per output on
// bf16 data, 100-600 FLOP a byte, so the tensor cores bound the wide ones;
// the single C -> C products (K8b, the cross-attention query) sit at or
// below the line and the bytes bound them. Their mma.sync predecessor
// stayed at 7% of the bound on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// a barrier every 32 channels, the prologue redone by every column block,
// no wgmma. Here:
//
// 1. The prologue once per block. A block owns 64 (or 32) token rows. The
//    producer warp brings them into shared memory by TMA, straight into the
//    K-major 128-byte-swizzled layout wgmma reads for A (64-channel chunks
//    of 64 rows x 128 bytes; TMA fills the channels past C with zeros). The
//    256 consumer threads, 4-8 to a row, transform the rows in place as the
//    chunks land and write them back as bf16:
//    PRO_LN   the LayerNorm: two-pass fp32 statistics (ops/_norms.py:ln_f32:
//             biased variance, eps inside the rsqrt), then ((x - mean) *
//             rstd) * s + b. It is latency-bound (8 warps, ~10 instructions
//             an element), so a block takes 64 rows rather than 128: that
//             halves its share and doubles the blocks that share it out
//             (measured on the card, PERF.md);
//    PRO_AFF  the SpatialTransformer's GroupNorm folded to a per-(batch, C)
//             affine: x * mul + add in fp32 without contraction, with the
//             (C) row of the block's batch element (N % 256 == 0, so a block
//             never straddles two); one pass, no statistics;
//    PRO_NONE nothing (K7a): the chunks TMA lands are already wgmma's A,
//             and each product starts as soon as its chunk has arrived. With
//             no prologue to share out, a block may take 128 rows (two
//             wgmma M tiles a warpgroup, both on each weight stage), which
//             halves the weight's reads from L2 where the (128, C) tokens
//             fit beside the ring (C <= 640).
//    A stays resident for the whole block (160 KB at C = 1280): it is read
//    once per weight tile, while the weight streams once per block.
// 2. Weights through a TMA ring. The block walks a range of BN-row tiles of
//    W (a column group: grid (M / BM) x groups, the prologue done once per
//    group instead of once per tile). The producer warp keeps a 2-4 stage
//    mbarrier ring of BN x 64-channel W boxes full (TMA, 128-byte swizzle,
//    zero fill past C). The two consumer warpgroups take the tiles in turn,
//    each issuing wgmma m64nBNk16 with both operands in shared memory and
//    the sums in fp32 registers while the other runs its epilogue; a stage
//    is freed as soon as the wgmma that read it retired. For GEGLU a stage
//    holds BN/2 h rows and the matching BN/2 gate rows (at +inner), as two
//    boxes, so a thread holds both sums of each of its outputs.
// 3. Epilogue from the registers, with the roundings of the Pallas kernels:
//    EPI_STORE rounds each sum to bf16 once and sends weight row n to output
//    n / O (the self-attention q/k/v from one (3*O, C) weight);
//    EPI_GEGLU adds both fp32 biases, applies the erf GELU (erff, the exact
//    GELU of F.gelu) and rounds the product once (geglu.py:_geglu_tile);
//    EPI_BIAS rounds the sum to bf16, adds the fp32 bias rounded to bf16
//    and rounds again (flax Dense in bf16: ln_matmul.py:_aff_kernel).
//    Each warp passes its 16 rows through a 16 x 16 staging buffer, so that
//    the stores fill whole 32-byte sectors.
//
// The tensor maps of W and x are encoded once per (pointer, shape, box)
// and cached (sm90.cuh): the modules keep their bf16 weight copies at a
// stable address (models/layers.py:DerivedWeight).

#pragma once

#include <atomic>

#include "sm90.cuh"

namespace edtr_lnproj {

using namespace edtr_sm90;

constexpr int KC = 64;             // channels per chunk: one 128-byte swizzle row
constexpr int ROW_BYTES = KC * 2;
constexpr int kMaxStages = 4;
constexpr int kMaxChunks = 32;      // C <= 2048
constexpr int AM = 64;              // rows of the A tile: wgmma's M
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
enum { PRO_LN = 0, PRO_AFF = 1, PRO_NONE = 2 };
enum { EPI_STORE = 0, EPI_GEGLU = 1, EPI_BIAS = 2 };

struct Args {
  const float* ln_s;    // (C) LayerNorm scale and shift (PRO_LN)
  const float* ln_b;
  const float* mul;     // (M / n_tok, C) folded GroupNorm (PRO_AFF)
  const float* add;
  const float* bias;    // (2*O) for EPI_GEGLU, (O) for EPI_BIAS
  bf16* out0;           // (M, O) outputs; out1/out2 only for EPI_STORE with K > 1
  bf16* out1;
  bf16* out2;
  int M, C, O;          // rows, channels, columns of each output
  int kch;              // 64-channel chunks, C rounded up
  int tiles;            // BN-row tiles of the weight
  int groups;           // column groups: gridDim.y
  int stages;           // weight ring depth
  int n_tok;            // tokens per batch element (PRO_AFF)
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// byte offset of 16-byte unit q (channels 8q..8q+7) of row r in the A tile
__device__ __forceinline__ int a_offset(int r, int q) {
  return (q >> 3) * (AM * ROW_BYTES) + r * ROW_BYTES + (((q & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ float sum8(const float (&f)[8]) {
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

// The warp's 16 x 16 output block o (store16x16_rows) to rows r0.. of
// `out` (row stride ld), columns c0..c0+15.
__device__ __forceinline__ void store16x16(bf16* stg, const float (&o)[8], int lane, bf16* out,
                                           size_t r0, int ld, int c0) {
  store16x16_rows(stg, o, lane, out + (r0 + (lane >> 1)) * ld + c0);
}

// Two consumer warpgroups, then one producer warp. BM token rows a block (32,
// 64, or with PRO_NONE 128): with 32, rows 32-63 of the A tile are left as
// they are, and their sums are never stored.
template <int BM>
__host__ __device__ constexpr int a_rows() {  // rows of a 64-channel chunk of A
  return BM < AM ? AM : BM;
}

template <int BM, int BN, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    lnproj_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap, const Args p) {
  constexpr int TPR = kConsumers / BM;  // prologue threads a row
  constexpr int UPT = 8 / TPR;          // their 16-byte units in each 64-channel chunk
  constexpr int STAGE_BYTES = BN * ROW_BYTES;
  constexpr int R = BN / 2;             // accumulator registers a thread, an M tile
  constexpr int AR = a_rows<BM>();
  constexpr int MT = AR / AM;           // wgmma M tiles a block
  static_assert((BM == 32 || BM == AM || (BM == 2 * AM && PRO == PRO_NONE)) &&
                    BN % (EPI == EPI_GEGLU ? 32 : 16) == 0,
                "tile shape");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sA = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sB = sA + p.kch * AR * ROW_BYTES;
  bf16* stg = reinterpret_cast<bf16*>(sB + p.stages * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + (kConsumers / 32) * STG_WARP);
  uint64_t* empty = full + kMaxStages;
  uint64_t* order = empty + kMaxStages;  // a warpgroup's turn to issue MMAs
  uint64_t* a_full = order + 2;           // one per 64-channel chunk of A

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int j0 = (int)((long long)blockIdx.y * p.tiles / p.groups);
  const int j1 = (int)((long long)(blockIdx.y + 1) * p.tiles / p.groups);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int kc = 0; kc < p.kch; ++kc) mbar_init(&a_full[kc], 1);
    mbar_init(&order[0], 1);
    mbar_init(&order[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer: the block's rows, then W boxes into the ring
    if (lane == 0) {
      for (int kc = 0; kc < p.kch; ++kc) {
        mbar_expect_tx(&a_full[kc], BM * ROW_BYTES);
        tma_load_2d(sA + kc * AR * ROW_BYTES, &xmap, &a_full[kc], kc * KC, m0);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int t = j0; t < j1; ++t)
        for (int kc = 0; kc < p.kch; ++kc) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          uint8_t* dst = sB + s * STAGE_BYTES;
          if (EPI == EPI_GEGLU) {
            tma_load_2d(dst, &wmap, &full[s], kc * KC, t * (BN / 2));
            tma_load_2d(dst + (BN / 2) * ROW_BYTES, &wmap, &full[s], kc * KC,
                        p.O + t * (BN / 2));
          } else {
            tma_load_2d(dst, &wmap, &full[s], kc * KC, t * BN);
          }
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  // ---- consumers. The main loop: the two warpgroups take the group's tiles
  // in turn, so that one's epilogue overlaps the other's MMAs. Stage n of
  // the ring holds chunk n % kch of tile j0 + n / kch. A warpgroup starts a
  // tile's MMAs only once the other has issued all of its previous tile's
  // (order[wg]), so that it never waits on a ring phase two ahead of the
  // producer (the parity of a phase names it only up to that).
  const int wg = warp >> 2, w4 = warp & 3, tq = lane & 3;
  const uint32_t a0 = smem_u32(sA);
  const uint32_t b0 = smem_u32(sB);
  const bool leader = (tid & 127) == 0;
  float acc[MT][R];
  int prev;  // the ring stage of the chunk before, freed once its MMAs retired
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[mt][i] = 0.f;
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
  };
  auto mma_chunk = [&](int t, int kc) {
    const int n = (t - j0) * p.kch + kc;
    const int s = n % p.stages;
    if (PRO == PRO_NONE) mbar_wait(&a_full[kc], 0);  // the chunk's tokens have landed
    mbar_wait(&full[s], (n / p.stages) & 1);
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        Wgmma<BN>::mma(acc[mt], sw128_desc(a0 + (kc * AR + mt * AM) * ROW_BYTES + kk * 32),
                       sw128_desc(b0 + s * STAGE_BYTES + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // the chunk before this one has been read
    fence_acc();
    if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
    prev = s;
  };

  // The prologue in place over the block's rows (TMA zero-fills the
  // channels past C). TPR neighbouring threads share a row, each taking UPT
  // units of every chunk (unit j of chunk kc: j = sub*UPT + i), so that a
  // quarter-warp's 16-byte loads fall in 8 distinct bank groups. The work
  // starts as each chunk lands.
  if (PRO == PRO_NONE) {
    // nothing to transform: each product waits for its own chunk
  } else if (PRO == PRO_AFF) {
    // x * mul + add in fp32, no contraction (plain_affine_matmul's separate
    // multiply and add), rounded to bf16; the block's batch element's row.
    // No product starts before the whole tile is transformed, so the pass
    // waits for every chunk first and then keeps CU chunks' loads in flight
    // (one chunk at a time, each waiting on its loads, took most of a
    // block's time: PERF.md).
    constexpr int CU = 4 / UPT;
    const int r = tid / TPR, sub = tid % TPR, cu = p.C / 8;
    const size_t row = (size_t)(m0 / p.n_tok) * p.C;
    for (int kc = 0; kc < p.kch; ++kc) mbar_wait(&a_full[kc], 0);
    for (int k0 = 0; k0 < p.kch; k0 += CU) {
      uint4 u[CU][UPT];
      float sc[CU][UPT][8], sh[CU][UPT][8];
#pragma unroll
      for (int k = 0; k < CU; ++k)
#pragma unroll
        for (int i = 0; i < UPT; ++i) {
          const int q = (k0 + k) * 8 + sub * UPT + i;
          if (k0 + k < p.kch && q < cu) {
            u[k][i] = *reinterpret_cast<const uint4*>(sA + a_offset(r, q));
            load8f(p.mul + row + q * 8, sc[k][i]);
            load8f(p.add + row + q * 8, sh[k][i]);
          }
        }
#pragma unroll
      for (int k = 0; k < CU; ++k)
#pragma unroll
        for (int i = 0; i < UPT; ++i) {
          const int q = (k0 + k) * 8 + sub * UPT + i;
          if (k0 + k < p.kch && q < cu) {
            float f[8];
            unpack8(u[k][i], f);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              f[e] = __fadd_rn(__fmul_rn(f[e], sc[k][i][e]), sh[k][i][e]);
            *reinterpret_cast<uint4*>(sA + a_offset(r, q)) =
                make_uint4(edtr::pack_bf16(f[0], f[1]), edtr::pack_bf16(f[2], f[3]),
                           edtr::pack_bf16(f[4], f[5]), edtr::pack_bf16(f[6], f[7]));
          }
        }
    }
  } else {
    const int cu = p.C / 8, kfull = p.C / KC;  // chunks wholly inside C, then a tail
    const float inv_c = 1.f / (float)p.C;
    const int r = tid / TPR, sub = tid % TPR;
    auto unit = [&](int kc, int i) {
      return reinterpret_cast<uint4*>(sA + a_offset(r, kc * 8 + sub * UPT + i));
    };
    auto in_c = [&](int kc, int i) { return kc < kfull || kc * 8 + sub * UPT + i < cu; };
    float sm = 0.f;
    for (int kc = 0; kc < p.kch; ++kc) {
      mbar_wait(&a_full[kc], 0);
#pragma unroll
      for (int i = 0; i < UPT; ++i)
        if (in_c(kc, i)) {
          float f[8];
          unpack8(*unit(kc, i), f);
          sm += sum8(f);
        }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sm += __shfl_xor_sync(0xffffffffu, sm, o);
    const float mean = sm * inv_c;
    float sq[UPT] = {};
    auto sq_chunk = [&](int kc, bool guard) {
#pragma unroll
      for (int i = 0; i < UPT; ++i)
        if (!guard || in_c(kc, i)) {
          float f[8];
          unpack8(*unit(kc, i), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = (f[e] - mean) * (f[e] - mean);
          sq[i] += sum8(f);
        }
    };
#pragma unroll 4
    for (int kc = 0; kc < kfull; ++kc) sq_chunk(kc, false);
    if (kfull < p.kch) sq_chunk(kfull, true);
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < UPT; ++i) v += sq[i];
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float rstd = rsqrtf(v * inv_c + p.eps);
    // ((x - mean) * rstd) * s + b in fp32, rounded to bf16; a chunk's units
    // loaded together, transformed, stored
    auto norm_chunk = [&](int kc, bool guard) {
      uint4 u[UPT];
      float sc[UPT][8], sh[UPT][8];
#pragma unroll
      for (int i = 0; i < UPT; ++i)
        if (!guard || in_c(kc, i)) {
          const int q = kc * 8 + sub * UPT + i;
          u[i] = *unit(kc, i);
          load8f(p.ln_s + q * 8, sc[i]);
          load8f(p.ln_b + q * 8, sh[i]);
        }
#pragma unroll
      for (int i = 0; i < UPT; ++i)
        if (!guard || in_c(kc, i)) {
          float f[8];
          unpack8(u[i], f);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = __fmaf_rn(__fmul_rn(__fsub_rn(f[e], mean), rstd), sc[i][e], sh[i][e]);
          u[i].x = edtr::pack_bf16(f[0], f[1]);
          u[i].y = edtr::pack_bf16(f[2], f[3]);
          u[i].z = edtr::pack_bf16(f[4], f[5]);
          u[i].w = edtr::pack_bf16(f[6], f[7]);
        }
#pragma unroll
      for (int i = 0; i < UPT; ++i)
        if (!guard || in_c(kc, i)) *unit(kc, i) = u[i];
    };
#pragma unroll 2
    for (int kc = 0; kc < kfull; ++kc) norm_chunk(kc, false);
    if (kfull < p.kch) norm_chunk(kfull, true);
  }
  if (PRO != PRO_NONE) {
    // the transformed rows, written by the threads, are read by wgmma (the
    // async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }

  bf16* wstg = stg + warp * STG_WARP;
  uint32_t turn = 0;
  for (int t = j0 + wg; t < j1; t += 2) {
    if (t > j0) {
      mbar_wait(&order[wg], turn);
      turn ^= 1;
    }
    // GEGLU: this thread's biases of the tile, loaded before the MMAs with
    // one M tile; with two the accumulators leave no room for them (a
    // 128-row block spilled), and they are loaded after
    float2 bias[EPI == EPI_GEGLU ? BN / 8 : 1];
    auto load_bias = [&]() {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const int oc = t * (BN / 2) + j * 8 + tq * 2;
        bias[j] = __ldg(reinterpret_cast<const float2*>(p.bias + oc));
        bias[BN / 16 + j] = __ldg(reinterpret_cast<const float2*>(p.bias + p.O + oc));
      }
    };
    if (EPI == EPI_GEGLU && MT == 1) load_bias();
    zero_acc();
    prev = -1;
    for (int kc = 0; kc < p.kch; ++kc) mma_chunk(t, kc);
    if (leader && t + 1 < j1) mbar_arrive(&order[wg ^ 1]);  // the other's turn
    if (EPI == EPI_GEGLU && MT > 1) load_bias();
    wgmma_wait<0>();
    fence_acc();
    if (leader) mbar_arrive(&empty[prev]);

    // accumulator mt (64 x BN): register 4j + 2h + e holds row mt*64 + w4*16
    // + gq + 8h, column 8j + 2tq + e; written 16 columns at a time
    if (w4 * 16 >= BM) continue;  // rows past the block's tokens
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const size_t r0 = (size_t)m0 + mt * AM + w4 * 16;  // the warp's 16 output rows
      if (EPI == EPI_GEGLU) {
#pragma unroll
        for (int j = 0; j < BN / 16; j += 2) {
          float o[8];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 bh = bias[j + n], bg = bias[BN / 16 + j + n];
              const float a = acc[mt][4 * (j + n) + i] + (i & 1 ? bh.y : bh.x);
              const float gt = acc[mt][4 * (BN / 16 + j + n) + i] + (i & 1 ? bg.y : bg.x);
              o[4 * n + i] = a * (gt * 0.5f * (1.f + erff(gt * 0.70710678118654752f)));
            }
          store16x16(wstg, o, lane, p.out0, r0, p.O, t * (BN / 2) + j * 8);
        }
      } else if (EPI == EPI_BIAS) {
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const int n = t * BN + j * 8;
          float o[8];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + n + h * 8 + 2 * tq));
#pragma unroll
            for (int i = 0; i < 4; ++i)
              o[4 * h + i] = edtr::bf16r(edtr::bf16r(acc[mt][4 * (j + h) + i]) +
                                         edtr::bf16r(i & 1 ? b.y : b.x));
          }
          store16x16(wstg, o, lane, p.out0, r0, p.O, n);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const int n = t * BN + j * 8;
          const int k = n / p.O;  // O % 64 == 0: 16 columns never straddle two outputs
          float o[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) o[i] = acc[mt][4 * j + i];
          store16x16(wstg, o, lane, k == 0 ? p.out0 : (k == 1 ? p.out1 : p.out2), r0, p.O,
                     n - k * p.O);
        }
      }
    }
  }
}

// ---- host ------------------------------------------------------------------

// Shared memory of a block: the alignment slack, A (chunks of `rows`
// rows), the ring, the output staging, the barriers.
inline int smem_bytes(int rows, int bn, int kch, int stages) {
  return 1024 + kch * rows * ROW_BYTES + stages * bn * ROW_BYTES +
         (kConsumers / 32) * STG_WARP * (int)sizeof(bf16) + (2 * kMaxStages + 2 + kMaxChunks) * 8;
}

// One launch over (M / BM) x groups blocks, each walking its range of the
// slab_rows / BN weight tiles with as deep a ring as shared memory holds
// (2-4 stages). The dynamic shared-memory limit is raised once per device.
template <int BM, int BN, int PRO, int EPI>
int launch(const void* x, const void* w, int slab_rows, Args a, cudaStream_t stream) {
  // 16 output columns a store: whole within one output (STORE: O % 64); an
  // affine block's rows within one batch element
  if (a.M % BM || slab_rows % BN || a.C % 32 || a.C <= 0 ||
      a.O % (EPI == EPI_GEGLU ? BN / 2 : 64) ||
      (PRO == PRO_AFF && (a.n_tok <= 0 || a.n_tok % BM || a.M % a.n_tok)))
    return (int)cudaErrorInvalidValue;
  a.kch = (a.C + KC - 1) / KC;
  a.tiles = slab_rows / BN;
  if (a.kch > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (a.groups < 1 || a.groups > a.tiles || a.M / BM > 65535) return (int)cudaErrorInvalidValue;
  constexpr int AR = a_rows<BM>();
  a.stages = (kSmemLimit - smem_bytes(AR, BN, a.kch, 0)) / (BN * ROW_BYTES);
  if (a.stages > kMaxStages) a.stages = kMaxStages;
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(lnproj_kernel<BM, BN, PRO, EPI>, kSmemLimit, raised);
  CUtensorMap wmap, xmap;
  if (r == 0) r = cached_matrix_map(w, slab_rows, a.C, EPI == EPI_GEGLU ? BN / 2 : BN, &wmap);
  if (r == 0) r = cached_matrix_map(x, a.M, a.C, BM, &xmap);
  if (r != 0) return r;
  dim3 grid(a.M / BM, a.groups);
  lnproj_kernel<BM, BN, PRO, EPI><<<grid, kThreads, smem_bytes(AR, BN, a.kch, a.stages),
                                    stream>>>(
      wmap, xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace edtr_lnproj
