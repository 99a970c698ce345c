// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * s) V and
// the per-row logsumexp, bf16 in and out, fp32 logits/softmax/accumulators.
//
// Replaces four Pallas TPU kernels of edtr_tpu/ops/flash_attention.py:
//
//   flash_wgmma_kernel (flash_wgmma.cuh)
//                     <- _qblock_wholekv_kernel (_qblock_wholekv_fwd_flat),
//                        _whole_fwd_kernel (_whole_fwd_flat) and
//                        _fwd_kernel (_flash_fwd_flat): head dim 64.
//   flash_fwd_d512    <- _fwd_kernel_streamkv (_streamkv_fwd_flat): head
//                        dim 512 (the VAE mid-block attention).
//
// The TPU kernels keep a whole (256 x N) or (N x N) fp32 logit slab in
// megabytes of VMEM. A Hopper block has at most 227 KB of shared memory, so
// both kernels here stream K/V in tiles through shared memory with an online
// softmax (running max m, running sum l, rescale alpha = exp(m_old - m_new)).
// The function is the TPU kernels': scale applied to the fp32 logits,
// P cast to bf16 before the PV product, l summed from the fp32 P,
// O = acc / l in bf16 and lse = m + log(l) in fp32.
//
// What bounds them on an H100: at the main-path shapes both do 4*N^2*D
// flops per head on N*D*8 bytes, far above the card's ~295 flop/byte ridge,
// so the tensor cores bound them. Head dim 64 runs on wgmma fed by TMA
// (flash_wgmma.cuh has its design). flash_fwd_d512 issues mma.sync
// m16n8k16 (bf16 -> fp32) from registers fed by ldmatrix, and hides the
// K/V loads behind the math with a cp.async double buffer; without
// wgmma/TMA/warp specialisation it cannot reach the dense bf16 peak.
//
// flash_fwd_d512: a 32 x 512 fp32 accumulator is too large for the registers
//   of one warp, so the output columns are split across 8 warps (64 each).
//   The QK^T contraction is 512 deep: each warp computes one 16 x 8 logit
//   sub-tile over the full depth, and the 32 x 32 logit tile is shared
//   through shared memory, where 8 threads per row do the online softmax.
//   Q (32 rows) plus double-buffered K and V tiles (32 rows each) take
//   ~174 KB of dynamic shared memory, so one block runs per SM.

#include "common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace edtr;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// head dim 512
// ---------------------------------------------------------------------------

constexpr int D512 = 512;
constexpr int BM512 = 32;        // query rows per block
constexpr int BN512 = 32;        // kv rows per tile
constexpr int LD512 = D512 + 8;  // padded smem row (elements): 1040 B
constexpr int LDS512 = BN512 + 4;  // fp32 logit tile row
constexpr int LDP512 = BN512 + 8;  // bf16 probability tile row: 80 B
constexpr int kThreads512 = 256;   // 8 warps, 64 output columns each
constexpr size_t kSmem512 = (size_t)(BM512 + 4 * BN512) * LD512 * sizeof(bf16) +
                            (size_t)BM512 * LDS512 * sizeof(float) +
                            (size_t)BM512 * LDP512 * sizeof(bf16) + 3 * BM512 * sizeof(float);

__device__ __forceinline__ void load_rows512(bf16* dst, const bf16* src, int rows, int tid) {
  for (int c = tid; c < rows * (D512 / 8); c += kThreads512) {
    const int r = c / (D512 / 8), col = (c % (D512 / 8)) * 8;
    cp_async16(dst + r * LD512 + col, src + (size_t)r * D512 + col);
  }
}

__global__ void __launch_bounds__(kThreads512, 1)
    flash_fwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int n, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM512 * LD512;        // [2][BN512][LD512]
  bf16* sV = sK + 2 * BN512 * LD512;    // [2][BN512][LD512]
  float* sS = reinterpret_cast<float*>(sV + 2 * BN512 * LD512);  // [BM512][LDS512]
  bf16* sP = reinterpret_cast<bf16*>(sS + BM512 * LDS512);       // [BM512][LDP512]
  float* sAlpha = reinterpret_cast<float*>(sP + BM512 * LDP512);
  float* sM = sAlpha + BM512;
  float* sL = sM + BM512;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM512;
  const size_t base = (size_t)bh * n * D512;
  const bf16* kg = k + base;
  const bf16* vg = v + base;

  if (tid < BM512) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  load_rows512(sQ, q + base + (size_t)q0 * D512, BM512, tid);
  load_rows512(sK, kg, BN512, tid);
  load_rows512(sV, vg, BN512, tid);
  cp_async_commit();

  // phase-1 tile of this warp: logit rows mt*16.., kv columns nt*8..
  const int mt = warp >> 2, nt = warp & 3;
  // phase-3 output columns of this warp
  const int c0 = warp * 64;
  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[a][t][0] = acc[a][t][1] = acc[a][t][2] = acc[a][t][3] = 0.f;

  // phase-2 mapping: 8 threads per logit row, 4 columns each
  const int srow = tid >> 3, scol = (tid & 7) * 4;

  const int nkv = n / BN512;
  for (int j = 0; j < nkv; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < nkv) {
      const int b = (j + 1) & 1;
      load_rows512(sK + b * BN512 * LD512, kg + (size_t)(j + 1) * BN512 * D512, BN512, tid);
      load_rows512(sV + b * BN512 * LD512, vg + (size_t)(j + 1) * BN512 * D512, BN512, tid);
      cp_async_commit();
    }
    const bf16* cK = sK + (j & 1) * BN512 * LD512;
    const bf16* cV = sV + (j & 1) * BN512 * LD512;

    // phase 1: one 16 x 8 logit sub-tile per warp, contracted over 512
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < D512 / 32; ++kk) {
        uint32_t b[4];  // b0/b1 of k-steps 2kk and 2kk+1
        ldmatrix_x4(b, cK + (nt * 8 + (lane & 7)) * LD512 + kk * 32 + mi * 8);
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, sQ + (mt * 16 + (lane & 15)) * LD512 + kk * 32 + (lane >> 4) * 8);
        ldmatrix_x4(a1, sQ + (mt * 16 + (lane & 15)) * LD512 + kk * 32 + 16 + (lane >> 4) * 8);
        mma_bf16(s, a0, b[0], b[1]);
        mma_bf16(s, a1, b[2], b[3]);
      }
      float* r0 = sS + (mt * 16 + g) * LDS512 + nt * 8 + tig * 2;
      float* r1 = r0 + 8 * LDS512;
      r0[0] = s[0] * scale; r0[1] = s[1] * scale;
      r1[0] = s[2] * scale; r1[1] = s[3] * scale;
    }
    __syncthreads();

    // phase 2: online softmax over the 32 x 32 logit tile
    {
      const float* srow_p = sS + srow * LDS512 + scol;
      const float x0 = srow_p[0], x1 = srow_p[1], x2 = srow_p[2], x3 = srow_p[3];
      const float m_old = sM[srow];
      float mx = fmaxf(m_old, fmaxf(fmaxf(x0, x1), fmaxf(x2, x3)));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float p0 = __expf(x0 - mx), p1 = __expf(x1 - mx);
      const float p2 = __expf(x2 - mx), p3 = __expf(x3 - mx);
      float ps = (p0 + p1) + (p2 + p3);
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      uint32_t* pp = reinterpret_cast<uint32_t*>(sP + srow * LDP512 + scol);
      pp[0] = pack_bf16(p0, p1);
      pp[1] = pack_bf16(p2, p3);
      if ((tid & 7) == 0) {
        const float alpha = __expf(m_old - mx);
        sAlpha[srow] = alpha;
        sM[srow] = mx;
        sL[srow] = sL[srow] * alpha + ps;
      }
    }
    __syncthreads();

    // phase 3: rescale and accumulate P V into this warp's 64 columns
    {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float al0 = sAlpha[a * 16 + g], al1 = sAlpha[a * 16 + g + 8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          acc[a][t][0] *= al0; acc[a][t][1] *= al0;
          acc[a][t][2] *= al1; acc[a][t][3] *= al1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN512 / 16; ++kk) {
        uint32_t pa[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
          ldmatrix_x4(pa[a], sP + (a * 16 + (lane & 15)) * LDP512 + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, cV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD512 + c0 + dp * 16 + (mi >> 1) * 8);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            mma_bf16(acc[a][2 * dp], pa[a], b[0], b[1]);
            mma_bf16(acc[a][2 * dp + 1], pa[a], b[2], b[3]);
          }
        }
      }
    }
  }

  // sL/sM were last written before the final phase-3 barrier: visible here
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r0 = a * 16 + g, r1 = r0 + 8;
    const float inv0 = 1.f / sL[r0], inv1 = 1.f / sL[r1];
    bf16* o0 = o + base + (size_t)(q0 + r0) * D512 + c0;
    bf16* o1 = o + base + (size_t)(q0 + r1) * D512 + c0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = t * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[a][t][0] * inv0, acc[a][t][1] * inv0);
      *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[a][t][2] * inv1, acc[a][t][3] * inv1);
    }
  }
  if (tid < BM512) lse[(size_t)bh * n + q0 + tid] = sM[tid] + logf(sL[tid]);
}

}  // namespace

// Plain C interface (loaded with ctypes). q/k/v/o are contiguous (bh, n, d)
// bf16, lse is (bh, n) fp32; n must be a multiple of the kernel's row tile
// (the Python wrappers check it). Launches on `stream`; returns
// cudaGetLastError(), or the error of the one-time raise of the kernel's
// shared-memory limit.
extern "C" int edtr_flash_fwd_d512(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int n, float scale, void* stream) {
  static std::atomic<unsigned> raised{0u};
  const cudaError_t err = edtr::raise_smem_once(flash_fwd_d512_kernel, kSmem512, raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / BM512, bh);
  flash_fwd_d512_kernel<<<grid, kThreads512, kSmem512, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n, scale);
  return (int)cudaGetLastError();
}

// The wgmma kernel of flash_wgmma.cuh at head dim 64, in tile plan `plan`
// (ops/flash_attention.py:FLASH_PLANS, (BN, STAGES, MINB)); n a multiple of
// 64 and of the plan's BN, scale > 0.
extern "C" int edtr_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int bh, int n, float scale, int plan,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plan) {
    case 0: return edtr_flash::launch<64, 3, 3>(q, k, v, o, lse, bh, n, scale, st);
    case 1: return edtr_flash::launch<128, 2, 2>(q, k, v, o, lse, bh, n, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
