// The transformer blocks' projection GEMM for Hopper (sm_90a) on mma.sync,
// shared by ln_matmul.cu (affine_matmul, K8b) and geglu.cu (geglu_proj,
// K7a): bf16 tokens in, bf16 out, fp32 accumulation. (The LayerNorm forms,
// K8a and K7b, run on the wgmma kernel of proj_wgmma.cuh.)
//
//   out = EPI(PRO(x) @ W^T)
//
// x is (M, C) tokens, row-major (the (B, N, C) token tensor with B*N rows);
// W is the module's bf16 weight in nn.Linear layout (rows = output columns,
// C contiguous), so no repacking is needed. One block owns a BM x BN tile of
// W's rows ("the slab") and walks C in 32-channel chunks.
//
// Prologue (PRO), applied as each A chunk is staged into shared memory, so
// the transformed tokens never reach device memory (the TPU kernels keep
// them in VMEM):
//   PRO_NONE  x as it is;
//   PRO_AFF   the folded GroupNorm: x * mul + add with the (B, C) fp32 row
//             of the token's batch, rounded to bf16.
// Epilogue (EPI):
//   EPI_BIAS  round to bf16, then add the bias rounded to bf16, rounded
//             again (flax Dense: ln_matmul.py:_aff_kernel);
//   EPI_GEGLU the slab of each warp is half h rows (j) and half gate rows
//             (inner + j) of the packed (2*inner, C) GEGLU weight, so each
//             thread holds both sums of an output element:
//             (h + bh) * gelu_erf(gate + bg) in fp32, rounded once
//             (geglu.py:_geglu_tile; erff, the exact GELU of F.gelu).
//
// 8 warps run mma.sync m16n8k16 from ldmatrix; W chunks stream through a
// 3-deep cp.async ring; A chunks are loaded into registers one step ahead
// and transformed into the other of two shared-memory buffers after the
// step's MMAs. What bounds these GEMMs on an H100: at the main-path shapes
// (256-4096 tokens, C 320-1280, O 320-5120) 2*C FLOP per output element on
// bf16 data is 100-600 FLOP per byte moved, so the tensor cores bound them;
// mma.sync without wgmma/TMA cannot reach the dense peak. Small grids (256
// tokens) take 64-row and 64-column tiles (the Python wrapper's plan), not a
// split over C.

#pragma once

#include <atomic>

#include "common.cuh"

namespace edtr_proj {

using edtr::bf16;

constexpr int BK = 32;          // channels per chunk
constexpr int LDS = BK + 8;     // padded smem row (elements): 80 B, ldmatrix conflict-free
constexpr int kThreads = 256;   // 8 warps
constexpr int kStages = 3;      // weight chunks in flight
enum { PRO_NONE = 0, PRO_AFF = 2 };
enum { EPI_BIAS = 1, EPI_GEGLU = 2 };

struct ProjArgs {
  const bf16* x;        // (M, C) tokens
  const bf16* w;        // (slab rows, C): O (BIAS) or 2*O (GEGLU)
  const float* mul;     // (M / n_tok, C) folded GroupNorm (PRO_AFF)
  const float* add;
  const float* bias;    // (O) for EPI_BIAS, (2*O) for EPI_GEGLU
  bf16* out0;           // (M, O) output
  int M, C, O;          // rows, channels, output columns
  int n_tok;            // tokens per batch element (PRO_AFF)
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __low2float(h[j]);
    f[2 * j + 1] = __high2float(h[j]);
  }
}

__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BM + kStages * BN) * LDS * sizeof(bf16);
}

template <int BM, int BN, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads) proj_gemm_kernel(const ProjArgs p) {
  constexpr int WARPS_M = BM / 32;
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WN = BN / WARPS_N;           // slab rows per warp
  constexpr int NT = WN / 8;                 // n8 tiles per warp
  constexpr int HALF = WN / 2;               // GEGLU: h rows, then as many gate rows
  constexpr int A_CH = BM * (BK / 8) / kThreads;
  constexpr int B_CH = BN * (BK / 8) / kThreads;
  static_assert(NT % 2 == 0 && A_CH >= 1 && B_CH >= 1, "tile shape");
  static_assert(EPI != EPI_GEGLU || HALF % 8 == 0, "GEGLU halves of whole n8 tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [2][BM][LDS] transformed tokens
  bf16* sB = sA + 2 * BM * LDS;                  // [kStages][BN][LDS] weight chunks

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int m0 = blockIdx.x * BM;
  const int nk = p.C / BK;

  // W row of slab row r
  auto w_row = [&](int r) -> int {
    if (EPI == EPI_GEGLU) {
      const int j0 = blockIdx.y * (BN / 2) + (r / WN) * HALF, rr = r % WN;
      return rr < HALF ? j0 + rr : p.O + j0 + rr - HALF;
    }
    return blockIdx.y * BN + r;
  };

  uint4 a_reg[A_CH];

  // registers <- this thread's 8-channel pieces of A chunk kc
  auto load_a = [&](int kc) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * kThreads, row = c >> 2, col = (c & 3) * 8;
      a_reg[i] = __ldg(reinterpret_cast<const uint4*>(p.x + (size_t)(m0 + row) * p.C +
                                                      kc * BK + col));
    }
  };

  // A buffer buf <- the registers, through the prologue
  auto store_a = [&](int kc, int buf) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * kThreads, row = c >> 2, col = (c & 3) * 8;
      uint4 v = a_reg[i];
      if (PRO != PRO_NONE) {
        const int c0 = kc * BK + col;
        float f[8], sc[8], sh[8];
        unpack8(v, f);
        const size_t b0 = (size_t)((m0 + row) / p.n_tok) * p.C + c0;
        load8f(p.mul + b0, sc);
        load8f(p.add + b0, sh);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = __fadd_rn(__fmul_rn(f[j], sc[j]), sh[j]);
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) u[j] = edtr::pack_bf16(f[2 * j], f[2 * j + 1]);
      }
      *reinterpret_cast<uint4*>(sA + (buf * BM + row) * LDS + col) = v;
    }
  };

  // weight ring slot of chunk kc; commits a group every call (empty past
  // the end) so the wait counts stay uniform
  auto load_b = [&](int kc) {
    if (kc < nk) {
      bf16* dst = sB + (kc % kStages) * BN * LDS;
#pragma unroll
      for (int i = 0; i < B_CH; ++i) {
        const int c = tid + i * kThreads, r = c >> 2, col = (c & 3) * 8;
        edtr::cp_async16(dst + r * LDS + col, p.w + (size_t)w_row(r) * p.C + kc * BK + col);
      }
    }
    edtr::cp_async_commit();
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  load_a(0);
  store_a(0, 0);
  load_b(0);
  load_b(1);
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    edtr::cp_async_wait<1>();
    __syncthreads();  // chunk kc visible; ring slot of kc+2 and A buffer buf^1 free
    load_b(kc + 2);
    const bool next = kc + 1 < nk;
    if (next) load_a(kc + 1);
    const bf16* A = sA + buf * BM * LDS;
    const bf16* Bt = sB + (kc % kStages) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        edtr::ldmatrix_x4(af[mt], A + (wm * 32 + mt * 16 + (lane & 15)) * LDS + kk * 16 +
                                      (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        edtr::ldmatrix_x4(b, Bt + (wn * WN + np * 16 + (mi >> 1) * 8 + (lane & 7)) * LDS +
                                 kk * 16 + (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          edtr::mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
          edtr::mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
    if (next) store_a(kc + 1, buf ^ 1);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t m = (size_t)m0 + wm * 32 + mt * 16 + g + half * 8;
      if (EPI == EPI_GEGLU) {
#pragma unroll
        for (int t = 0; t < NT / 2; ++t) {
          const int j = blockIdx.y * (BN / 2) + wn * HALF + t * 8 + tig * 2;
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc[mt][t][2 * half + e] + p.bias[j + e];
            const float gt = acc[mt][t + NT / 2][2 * half + e] + p.bias[p.O + j + e];
            o[e] = a * (gt * 0.5f * (1.f + erff(gt * 0.70710678118654752f)));
          }
          *reinterpret_cast<uint32_t*>(p.out0 + m * p.O + j) = edtr::pack_bf16(o[0], o[1]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n = blockIdx.y * BN + wn * WN + t * 8 + tig * 2;
          const float o0 = bf16r(bf16r(acc[mt][t][2 * half]) + bf16r(p.bias[n]));
          const float o1 = bf16r(bf16r(acc[mt][t][2 * half + 1]) + bf16r(p.bias[n + 1]));
          *reinterpret_cast<uint32_t*>(p.out0 + m * p.O + n) = edtr::pack_bf16(o0, o1);
        }
      }
    }
}

// One launch over a grid of (M / BM) x (slab rows / BN) blocks; the dynamic
// shared-memory limit is raised once per device (one bit each).
template <int BM, int BN, int PRO, int EPI>
int launch(const ProjArgs& a, int slab_rows, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN>();
  static std::atomic<unsigned> raised{0u};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!((raised.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(proj_gemm_kernel<BM, BN, PRO, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(1u << dev);
  }
  if (a.M % BM || slab_rows % BN || a.C % BK) return (int)cudaErrorInvalidValue;
  dim3 grid(a.M / BM, slab_rows / BN);
  proj_gemm_kernel<BM, BN, PRO, EPI><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// launch<bm, bn, PRO, EPI> for a run-time tile: bm, bn in {64, 128}
template <int PRO, int EPI>
int launch_tile(int bm, int bn, const ProjArgs& a, int slab_rows, cudaStream_t stream) {
  if (bm == 64 && bn == 64) return launch<64, 64, PRO, EPI>(a, slab_rows, stream);
  if (bm == 64 && bn == 128) return launch<64, 128, PRO, EPI>(a, slab_rows, stream);
  if (bm == 128 && bn == 64) return launch<128, 64, PRO, EPI>(a, slab_rows, stream);
  if (bm == 128 && bn == 128) return launch<128, 128, PRO, EPI>(a, slab_rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace edtr_proj
