// The GEGLU projection GEMM for Hopper (sm_90a) on mma.sync: geglu.cu's
// geglu_proj (K7a), bf16 tokens in, bf16 out, fp32 accumulation. (Every
// other projection, K8a, K8b and K7b, runs on the wgmma kernel of
// proj_wgmma.cuh.)
//
//   out = (x@wh + bh) * gelu_erf(x@wg + bg)
//
// x is (M, C) tokens, row-major (the (B, N, C) token tensor with B*N rows);
// W is the module's packed (2*inner, C) bf16 weight in nn.Linear layout
// (rows = output columns, C contiguous), so no repacking is needed. One
// block owns a BM x BN tile of W's rows ("the slab") and walks C in
// 32-channel chunks. The slab of each warp is half h rows (j) and half gate
// rows (inner + j), so each thread holds both sums of an output element:
// (h + bh) * gelu_erf(gate + bg) in fp32, rounded once (geglu.py:_geglu_tile;
// erff, the exact GELU of F.gelu).
//
// 8 warps run mma.sync m16n8k16 from ldmatrix; W chunks stream through a
// 3-deep cp.async ring; A chunks are loaded into registers one step ahead
// and stored into the other of two shared-memory buffers after the step's
// MMAs. What bounds this GEMM on an H100: at 4096 tokens x 320 channels ->
// 2 x 1280 columns it does 2*C FLOP per output element on bf16 data, ~300
// FLOP per byte moved, so the tensor cores bound it; it is not on the
// default path and already runs at F.linear's speed (PERF.md).

#pragma once

#include <atomic>

#include "common.cuh"

namespace edtr_proj {

using edtr::bf16;

constexpr int BK = 32;          // channels per chunk
constexpr int LDS = BK + 8;     // padded smem row (elements): 80 B, ldmatrix conflict-free
constexpr int kThreads = 256;   // 8 warps
constexpr int kStages = 3;      // weight chunks in flight

struct ProjArgs {
  const bf16* x;        // (M, C) tokens
  const bf16* w;        // (2*O, C): h rows, then gate rows
  const float* bias;    // (2*O)
  bf16* out0;           // (M, O) output
  int M, C, O;          // rows, channels, output columns
};

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BM + kStages * BN) * LDS * sizeof(bf16);
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) proj_gemm_kernel(const ProjArgs p) {
  constexpr int WARPS_M = BM / 32;
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WN = BN / WARPS_N;           // slab rows per warp
  constexpr int NT = WN / 8;                 // n8 tiles per warp
  constexpr int HALF = WN / 2;               // h rows, then as many gate rows
  constexpr int A_CH = BM * (BK / 8) / kThreads;
  constexpr int B_CH = BN * (BK / 8) / kThreads;
  static_assert(NT % 2 == 0 && A_CH >= 1 && B_CH >= 1, "tile shape");
  static_assert(HALF % 8 == 0, "GEGLU halves of whole n8 tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [2][BM][LDS] tokens
  bf16* sB = sA + 2 * BM * LDS;                  // [kStages][BN][LDS] weight chunks

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int m0 = blockIdx.x * BM;
  const int nk = p.C / BK;

  // W row of slab row r
  auto w_row = [&](int r) -> int {
    const int j0 = blockIdx.y * (BN / 2) + (r / WN) * HALF, rr = r % WN;
    return rr < HALF ? j0 + rr : p.O + j0 + rr - HALF;
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

  // A buffer buf <- the registers
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * kThreads, row = c >> 2, col = (c & 3) * 8;
      *reinterpret_cast<uint4*>(sA + (buf * BM + row) * LDS + col) = a_reg[i];
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
  store_a(0);
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
    if (next) store_a(buf ^ 1);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t m = (size_t)m0 + wm * 32 + mt * 16 + g + half * 8;
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
    }
}

// One launch over a grid of (M / BM) x (slab rows / BN) blocks; the dynamic
// shared-memory limit is raised once per device (one bit each).
template <int BM, int BN>
int launch(const ProjArgs& a, int slab_rows, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN>();
  static std::atomic<unsigned> raised{0u};
  const cudaError_t err = edtr::raise_smem_once(proj_gemm_kernel<BM, BN>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  if (a.M % BM || slab_rows % BN || a.C % BK) return (int)cudaErrorInvalidValue;
  dim3 grid(a.M / BM, slab_rows / BN);
  proj_gemm_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// launch<bm, bn> for a run-time tile: bm, bn in {64, 128}
inline int launch_tile(int bm, int bn, const ProjArgs& a, int slab_rows, cudaStream_t stream) {
  if (bm == 64 && bn == 64) return launch<64, 64>(a, slab_rows, stream);
  if (bm == 64 && bn == 128) return launch<64, 128>(a, slab_rows, stream);
  if (bm == 128 && bn == 64) return launch<128, 64>(a, slab_rows, stream);
  if (bm == 128 && bn == 128) return launch<128, 128>(a, slab_rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace edtr_proj
