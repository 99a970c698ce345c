// Windowed attention of SwinIR for Hopper (sm_90a):
//
//   O[w, :, h, :] = softmax(Q K^T * scale + bias[h] + mask[w mod nW]) V
//
// over one 64-token window per block row, bf16 in and out, fp32 logits,
// softmax and accumulators.
//
// Replaces the Pallas TPU kernel of edtr_tpu/ops/window_attention.py:
// _win_kernel (_win_fwd). Its numerics: S = (Q K^T) * scale in fp32, + the
// relative-position bias of the head, + the shift mask row of the window
// (window w takes row w mod nW, windows image-major), row max, exp, sum,
// P normalised in fp32 and only then rounded to bf16 (unlike the flash
// kernels, which round the unnormalised P), O = P V accumulated in fp32 and
// rounded once. JAX's window grouping G (_pick_g) is a TPU block-shape
// artefact and has no counterpart here.
//
// Layout (JAX's): q, k, v are (BW, N, H, D) with unit stride along D and
// any even strides elsewhere, so they may be the strided q/k/v slices of the
// packed (BW, N, 3C) windows swin_pre writes; bias is (H, N, N) fp32, mask
// (nW, N, N) fp32 or null; O is contiguous (BW, N, H, D), which is the
// (BW, N, C) window tensor swin_post reads.
//
// Design. One block per (head, window): 128 threads, 4 warps of 16 query
// rows. SwinIR's head dim D = 30 is zero-padded to 32 in shared memory so
// that Q K^T is two k16 steps of mma.sync m16n8k16. A 30-wide head slice is
// only 4-byte aligned (60-byte rows at 1080-byte strides), so Q, K and V are
// staged with 4-byte loads, not 16-byte cp.async. The 16 x 64 logit tile of
// a warp stays in registers; bias and mask are read there as fp32 pairs
// (from L2: one head's bias is 16 KB, the mask 1 MB, shared by all blocks).
//
// What bounds it on an H100: at the main-path shape (64 windows x 6 heads,
// N 64, D 30) it moves ~7 MB (q, k, v, O, mask) for 0.19 GFLOP, 27 FLOP per
// byte, so memory bounds it (~2 us); the grid of 384 small blocks and the
// launch itself dominate far above that bound.

#include "common.cuh"

namespace {

using namespace edtr;

constexpr int kN = 64;          // tokens per window (win 8)
constexpr int kD = 32;          // head dim, padded
constexpr int kLD = kD + 8;     // smem row (elements): 80 B, ldmatrix conflict-free
constexpr int kThreads = 128;   // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// rows x D of (row stride `stride`) into smem [kN][kLD], zero-padded to kD
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long stride, int d,
                                      int tid) {
  for (int c = tid; c < kN * (kD / 2); c += kThreads) {
    const int r = c / (kD / 2), col = (c % (kD / 2)) * 2;
    const uint32_t v = col < d ? ldg_u32(src + r * stride + col) : 0u;
    *reinterpret_cast<uint32_t*>(dst + r * kLD + col) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ mask, bf16* __restrict__ o, int heads,
                            int d, long long s_w, long long s_n, long long s_h, int n_mask,
                            float scale) {
  __shared__ __align__(16) bf16 sQ[kN * kLD];
  __shared__ __align__(16) bf16 sK[kN * kLD];
  __shared__ __align__(16) bf16 sV[kN * kLD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int h = blockIdx.x, w = blockIdx.y;
  const long long off = (long long)w * s_w + (long long)h * s_h;

  stage(sQ, q + off, s_n, d, tid);
  stage(sK, k + off, s_n, d, tid);
  stage(sV, v + off, s_n, d, tid);
  __syncthreads();

  // S = Q K^T: 16 rows x 64 key columns per warp, 8 n-tiles of 8
  float s[kN / 8][4];
#pragma unroll
  for (int t = 0; t < kN / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * kLD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sK + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * kLD + ks * 16 + (mi & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // + bias[h] (+ mask[w mod nW]); this thread holds rows r0 = g, r1 = g + 8
  // of the warp's 16 and columns t*8 + tig*2 + {0, 1}
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float* b0 = bias + ((size_t)h * kN + r0) * kN;
  const float* b1 = bias + ((size_t)h * kN + r1) * kN;
  const float* m0 = mask ? mask + ((size_t)(w % n_mask) * kN + r0) * kN : nullptr;
  const float* m1 = mask ? mask + ((size_t)(w % n_mask) * kN + r1) * kN : nullptr;
  float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
  for (int t = 0; t < kN / 8; ++t) {
    const int col = t * 8 + tig * 2;
    const float2 bb0 = __ldg(reinterpret_cast<const float2*>(b0 + col));
    const float2 bb1 = __ldg(reinterpret_cast<const float2*>(b1 + col));
    s[t][0] = s[t][0] * scale + bb0.x;
    s[t][1] = s[t][1] * scale + bb0.y;
    s[t][2] = s[t][2] * scale + bb1.x;
    s[t][3] = s[t][3] * scale + bb1.y;
    if (mask) {
      const float2 mm0 = __ldg(reinterpret_cast<const float2*>(m0 + col));
      const float2 mm1 = __ldg(reinterpret_cast<const float2*>(m1 + col));
      s[t][0] += mm0.x;
      s[t][1] += mm0.y;
      s[t][2] += mm1.x;
      s[t][3] += mm1.y;
    }
    mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
    mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
  }
  // a row's 64 columns live in the 4 threads of a quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int t = 0; t < kN / 8; ++t) {
    s[t][0] = expf(s[t][0] - mx0);
    s[t][1] = expf(s[t][1] - mx0);
    s[t][2] = expf(s[t][2] - mx1);
    s[t][3] = expf(s[t][3] - mx1);
    l0 += s[t][0] + s[t][1];
    l1 += s[t][2] + s[t][3];
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // O = P V with P normalised in fp32 before its bf16 rounding (the A
  // operand of the PV product, repacked from the logit fragments)
  float acc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0] / l0, s[2 * kk][1] / l0);
    a[1] = pack_bf16(s[2 * kk][2] / l1, s[2 * kk][3] / l1);
    a[2] = pack_bf16(s[2 * kk + 1][0] / l0, s[2 * kk + 1][1] / l0);
    a[3] = pack_bf16(s[2 * kk + 1][2] / l1, s[2 * kk + 1][3] / l1);
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kLD + dp * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }

  // contiguous (BW, N, H, D) output; d is even, so a column pair is whole
  bf16* o0 = o + (((size_t)w * kN + r0) * heads + h) * d;
  bf16* o1 = o + (((size_t)w * kN + r1) * heads + h) * d;
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    const int col = t * 8 + tig * 2;
    if (col < d) {
      *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[t][0], acc[t][1]);
      *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[t][2], acc[t][3]);
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). q/k/v (bw, 64, heads, d) bf16 at
// the element strides s_w, s_n, s_h (unit stride along d; all even, d even
// and <= 32, pointers 4-byte aligned: the Python wrapper checks); bias
// (heads, 64, 64) fp32; mask (n_mask, 64, 64) fp32 or null (n_mask > 0
// then); o (bw, 64, heads, d) bf16, contiguous. Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int edtr_window_attention(const void* q, const void* k, const void* v,
                                     const void* bias, const void* mask, void* o, int bw,
                                     int heads, int d, long long s_w, long long s_n,
                                     long long s_h, int n_mask, float scale, void* stream) {
  if (d <= 0 || d > kD || d % 2 || bw <= 0 || heads <= 0 || (mask && n_mask <= 0))
    return (int)cudaErrorInvalidValue;
  dim3 grid(heads, bw);
  window_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<bf16*>(o),
      heads, d, s_w, s_n, s_h, n_mask, scale);
  return (int)cudaGetLastError();
}
