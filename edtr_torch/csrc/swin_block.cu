// The two halves of a SwinIR transformer block for Hopper (sm_90a), in
// rolled token space, bf16 in and out with fp32 statistics and accumulators:
//
//   swin_pre_kernel   LN1 + cyclic roll + qkv projection + window partition
//   swin_post_kernel  window reverse + proj + residual + LN2 + fc1 + GELU +
//                     fc2 + residual
//
// Replace the Pallas TPU kernels of edtr_tpu/ops/swin_block.py: _pre_kernel
// (swin_pre) and _post_kernel (swin_post), with the numerics of _pre_ref and
// _post_body: LayerNorm in fp32 (two-pass mean and variance, eps inside the
// rsqrt, affine in fp32) rounded to bf16; every projection accumulated in
// fp32 with its fp32 bias added before the single bf16 rounding; the exact
// erf GELU in fp32, rounded once; the residual adds bf16 + bf16. Window
// attention (window_attention.cu) runs between the two.
//
// Rolled space, as in JAX: swin_pre gathers window token (y, x) from
// ((y + d) mod h, (x + d) mod w) of its input (d = shift - in_offset, 0 or
// +-win/2) and writes the gathered token to xr at (y, x); swin_post works
// on rolled positions throughout, so a block hands its successor tokens
// rolled by its own shift and the RSTB un-rolls once before its conv.
//
// Design. SwinIR's widths (C 180, 3C 540, hidden 360) are multiples of
// neither 16 nor 32, and its 360-byte rows make odd rows only 8-byte
// aligned. So every operand is staged with 4- or 8-byte copies, the K walk
// of each GEMM is zero-padded to a multiple of 32 in shared memory, and the
// ragged column edge is masked in the epilogue. A block owns a tile of
// tokens (swin_pre: one window of 64; swin_post: half of one, so that the
// 64 windows of a 512² image give 128 blocks for 132 SMs) and computes each
// projection in slabs of 192 output columns: 8 warps of mma.sync m16n8k16 fed by ldmatrix, the weight rows of
// the slab streaming through a 3-deep cp.async ring of 32-channel chunks
// (the three post weights, 324 KB in bf16, do not fit in shared memory
// together). The normalised tokens, x1 = xr + proj and the 32 x 360 GELU
// hidden stay in shared memory; only x, qkv, xr, the attention output and
// the block output touch device memory. swin_pre splits the 540 qkv
// columns over three blocks per window (192 blocks at bs 1).
//
// What bounds them on an H100: at the main-path shape (1 x 4096 tokens,
// C 180) swin_pre moves ~7.6 MB for 0.80 GFLOP and swin_post ~4.7 MB for
// 1.33 GFLOP: under 300 FLOP per byte, so memory bounds both (~2.3 and
// ~1.4 us). mma.sync from shared memory, a grid of 128-192 blocks and the
// serial LN/GEMM phases keep these simple kernels well above that bound.

#include "common.cuh"

namespace {

using namespace edtr;

constexpr int kThreads = 256;               // 8 warps
constexpr int kWinTok = 64;                 // tokens per window (win 8)
constexpr int BK = 32;                      // K chunk of the weight ring
constexpr int kStages = 3;                  // weight chunks in flight
constexpr int kSlab = 192;                  // output columns per GEMM slab
constexpr int LDW = BK + 8;                 // ring row: 80 B, ldmatrix conflict-free
constexpr int kMaxC = 192;                  // channels, padded K of qkv/proj/fc1
constexpr int kMaxHidden = 384;             // MLP hidden, padded K of fc2
constexpr int LDA = kMaxC + 8;              // token row: 400 B
constexpr int LDH = kMaxHidden + 8;         // hidden row: 784 B
constexpr size_t kRingBytes = (size_t)kStages * kSlab * LDW * sizeof(bf16);

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return make_float2(__low2float(h), __high2float(h));
}

// One warp: the LayerNorm of a row of c bf16 channels, held as pairs u[j]
// at columns (lane + 32 j) * 2 (zero past c), into dst as bf16, columns c to
// kMaxC zeroed (the K padding of the next GEMM).
__device__ __forceinline__ void ln_row(const uint32_t (&u)[3], int c, int lane,
                                       const float* __restrict__ s,
                                       const float* __restrict__ sh, float eps, bf16* dst) {
  float f[3][2], sum = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float2 v = unpack2(u[j]);
    f[j][0] = v.x;
    f[j][1] = v.y;
    sum += v.x + v.y;
  }
  const float mean = warp_sum(sum) / (float)c;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if ((lane + 32 * j) * 2 < c) {
      const float d0 = f[j][0] - mean, d1 = f[j][1] - mean;
      q += d0 * d0 + d1 * d1;
    }
  const float rstd = rsqrtf(warp_sum(q) / (float)c + eps);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int cc = (lane + 32 * j) * 2;
    uint32_t out = 0u;
    if (cc < c) {
      const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[j][0], mean), rstd), s[cc]), sh[cc]);
      const float y1 =
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[j][1], mean), rstd), s[cc + 1]), sh[cc + 1]);
      out = pack_bf16(y0, y1);
    }
    *reinterpret_cast<uint32_t*>(dst + cc) = out;
  }
}

// The warp grid of a TM-row tile over a kSlab-column slab
template <int TM>
struct Tile {
  static constexpr int WARPS_M = TM / 16;
  static constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  static constexpr int WN = kSlab / WARPS_N;  // slab columns per warp
  static constexpr int NT = WN / 8;           // n8 tiles per warp
  static_assert(NT % 2 == 0, "whole ldmatrix_x4 pairs of n8 tiles");
};

// acc = this warp's 16 x WN part of A[TM, :k] @ W[n0 : n0 + kSlab, :k]^T.
// A: shared memory, rows of lda elements, zero in columns k .. the next
// multiple of 32. W: (n_rows, k) bf16 in device memory (nn.Linear layout),
// rows past n_rows and columns past k read as zeros; k % 4 == 0 and W 8-byte
// aligned, so each piece is one 8-byte cp.async. Ends with every thread past
// its last read of A and of the ring.
template <int TM>
__device__ void slab_gemm(float (&acc)[Tile<TM>::NT][4], const bf16* sA, int lda, int k,
                          const bf16* __restrict__ W, int n_rows, int n0, bf16* ring) {
  using T = Tile<TM>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, mi = lane >> 3;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int nk = (k + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < T::NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  // ring slot of chunk kc; commits a group every call (empty past the end)
  auto load = [&](int kc) {
    if (kc < nk) {
      bf16* dst = ring + (kc % kStages) * kSlab * LDW;
      for (int i = tid; i < kSlab * (BK / 4); i += kThreads) {
        const int r = i / (BK / 4), col = (i % (BK / 4)) * 4;
        const int gr = n0 + r, gc = kc * BK + col;
        bf16* d = dst + r * LDW + col;
        if (gr < n_rows && gc < k)
          cp_async8(d, W + (size_t)gr * k + gc);
        else
          *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
      }
    }
    cp_async_commit();
  };

  load(0);
  load(1);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<1>();
    __syncthreads();  // chunk kc visible; the slot of chunk kc+2 (read at kc-1) free
    load(kc + 2);
    const bf16* Bt = ring + (kc % kStages) * kSlab * LDW;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sA + (wm * 16 + (lane & 15)) * lda + kc * BK + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Bt + (wn * T::WN + np * 16 + (mi >> 1) * 8 + (lane & 7)) * LDW + kk * 16 +
                           (mi & 1) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// f(row, col, v0, v1) for each pair of this thread's accumulators: tile
// row, slab column (even) and the two fp32 sums
template <int TM, class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[Tile<TM>::NT][4], F f) {
  using T = Tile<TM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < T::NT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      f(wm * 16 + g + half * 8, wn * T::WN + t * 8 + tig * 2, acc[t][2 * half],
        acc[t][2 * half + 1]);
}

struct Geometry {  // a block's window and its tokens' rolled positions
  int b, wy, wx, win, w, L;
  __device__ Geometry(int window, int h_, int w_, int win_) : win(win_), w(w_), L(h_ * w_) {
    const int nww = w_ / win_, nw = (h_ / win_) * nww;
    b = window / nw;
    wy = (window % nw) / nww;
    wx = (window % nw) % nww;
  }
  __device__ int y(int i) const { return wy * win + i / win; }
  __device__ int x(int i) const { return wx * win + i % win; }
  __device__ size_t token(int i) const { return (size_t)b * L + (size_t)y(i) * w + x(i); }
};

struct PreArgs {
  const bf16* x;        // (B, h*w, C) tokens, rolled by the caller's in_offset
  const float* ln_s;    // (C) LN1 affine
  const float* ln_b;
  const bf16* wqkv;     // (3C, C) qkv weight
  const float* bias;    // (3C)
  bf16* qkv;            // (B, nW, 64, 3C) windows
  bf16* xr;             // (B, h*w, C) x rolled by d
  int h, w, win, c, d;
  float eps;
};

// grid (B * nW, ceil(3C / kSlab)): one window, one slab of qkv columns
__global__ void __launch_bounds__(kThreads) swin_pre_kernel(const PreArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [64][LDA] LN1 tokens
  bf16* ring = sA + kWinTok * LDA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Geometry geo(blockIdx.x, p.h, p.w, p.win);
  const int c3 = 3 * p.c, n0 = blockIdx.y * kSlab;

  for (int r = warp; r < kWinTok; r += kThreads / 32) {
    const int ys = ((geo.y(r) + p.d) % p.h + p.h) % p.h;
    const int xs = ((geo.x(r) + p.d) % p.w + p.w) % p.w;
    const bf16* src = p.x + ((size_t)geo.b * geo.L + (size_t)ys * p.w + xs) * p.c;
    bf16* dst_xr = p.xr + geo.token(r) * p.c;
    uint32_t u[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int cc = (lane + 32 * j) * 2;
      u[j] = cc < p.c ? *reinterpret_cast<const uint32_t*>(src + cc) : 0u;
      if (blockIdx.y == 0 && cc < p.c) *reinterpret_cast<uint32_t*>(dst_xr + cc) = u[j];
    }
    ln_row(u, p.c, lane, p.ln_s, p.ln_b, p.eps, sA + r * LDA);
  }
  __syncthreads();

  float acc[Tile<64>::NT][4];
  slab_gemm<64>(acc, sA, LDA, p.c, p.wqkv, c3, n0, ring);
  bf16* out = p.qkv + (size_t)blockIdx.x * kWinTok * c3;
  for_pairs<64>(acc, [&](int row, int col, float v0, float v1) {
    const int n = n0 + col;
    if (n < c3)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * c3 + n) =
          pack_bf16(v0 + p.bias[n], v1 + p.bias[n + 1]);
  });
}

struct PostArgs {
  const bf16* attn;     // (B, nW, 64, C) attention output windows
  const bf16* xr;       // (B, h*w, C) rolled shortcut
  const bf16* wp;       // (C, C) proj
  const float* bp;
  const float* ln_s;    // (C) LN2 affine
  const float* ln_b;
  const bf16* w1;       // (hidden, C) fc1
  const float* b1;
  const bf16* w2;       // (C, hidden) fc2
  const float* b2;
  bf16* out;            // (B, h*w, C), rolled
  int h, w, win, c, hidden;
  float eps;
};

constexpr int kPostTM = 32;  // tokens per swin_post block
constexpr size_t kPostSmem = (size_t)kPostTM * (2 * LDA + LDH) * sizeof(bf16) + kRingBytes;

// grid (B * nW * 2): half a window each
__global__ void __launch_bounds__(kThreads) swin_post_kernel(const PostArgs p) {
  constexpr int TM = kPostTM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [TM][LDA] attention rows, then LN2(x1)
  bf16* sX = sA + TM * LDA;                      // [TM][LDA] xr, then x1
  bf16* sH = sX + TM * LDA;                      // [TM][LDH] GELU hidden
  bf16* ring = sH + TM * LDH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kParts = kWinTok / TM;
  const Geometry geo(blockIdx.x / kParts, p.h, p.w, p.win);
  const int i0 = (blockIdx.x % kParts) * TM;  // first window token of the tile
  const bf16* attn = p.attn + ((size_t)(blockIdx.x / kParts) * kWinTok + i0) * p.c;

  // attention rows (zero K padding) and the shortcut rows of the tile's tokens
  for (int i = tid; i < TM * (kMaxC / 4); i += kThreads) {
    const int r = i / (kMaxC / 4), col = (i % (kMaxC / 4)) * 4;
    if (col < p.c) {
      cp_async8(sA + r * LDA + col, attn + (size_t)r * p.c + col);
      cp_async8(sX + r * LDA + col, p.xr + geo.token(i0 + r) * p.c + col);
    } else {
      *reinterpret_cast<uint2*>(sA + r * LDA + col) = make_uint2(0u, 0u);
    }
  }
  const int kh = (p.hidden + BK - 1) / BK * BK;  // fc2's K walk reads up to here
  for (int i = tid; i < TM * ((kh - p.hidden) / 4); i += kThreads) {
    const int per = (kh - p.hidden) / 4;
    *reinterpret_cast<uint2*>(sH + (i / per) * LDH + p.hidden + (i % per) * 4) =
        make_uint2(0u, 0u);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float acc[Tile<TM>::NT][4];
  // x1 = xr + bf16(attn @ Wp^T + bp)
  slab_gemm<TM>(acc, sA, LDA, p.c, p.wp, p.c, 0, ring);
  for_pairs<TM>(acc, [&](int row, int col, float v0, float v1) {
    if (col < p.c) {
      uint32_t* x = reinterpret_cast<uint32_t*>(sX + row * LDA + col);
      const float2 r = unpack2(*x);
      *x = pack_bf16(bf16r(v0 + p.bp[col]) + r.x, bf16r(v1 + p.bp[col + 1]) + r.y);
    }
  });
  __syncthreads();

  for (int r = warp; r < TM; r += kThreads / 32) {
    uint32_t u[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int cc = (lane + 32 * j) * 2;
      u[j] = cc < p.c ? *reinterpret_cast<const uint32_t*>(sX + r * LDA + cc) : 0u;
    }
    ln_row(u, p.c, lane, p.ln_s, p.ln_b, p.eps, sA + r * LDA);
  }
  __syncthreads();

  // hidden = bf16(gelu(LN2(x1) @ W1^T + b1)), kSlab columns at a time
  for (int n0 = 0; n0 < p.hidden; n0 += kSlab) {
    slab_gemm<TM>(acc, sA, LDA, p.c, p.w1, p.hidden, n0, ring);
    for_pairs<TM>(acc, [&](int row, int col, float v0, float v1) {
      const int n = n0 + col;
      if (n < p.hidden) {
        const float a0 = v0 + p.b1[n], a1 = v1 + p.b1[n + 1];
        *reinterpret_cast<uint32_t*>(sH + row * LDH + n) =
            pack_bf16(a0 * 0.5f * (1.f + erff(a0 * 0.70710678118654752f)),
                      a1 * 0.5f * (1.f + erff(a1 * 0.70710678118654752f)));
      }
    });
  }
  __syncthreads();

  // out = x1 + bf16(hidden @ W2^T + b2), at the tokens' rolled positions
  slab_gemm<TM>(acc, sH, LDH, p.hidden, p.w2, p.c, 0, ring);
  for_pairs<TM>(acc, [&](int row, int col, float v0, float v1) {
    if (col < p.c) {
      const float2 x1 = unpack2(*reinterpret_cast<const uint32_t*>(sX + row * LDA + col));
      *reinterpret_cast<uint32_t*>(p.out + geo.token(i0 + row) * p.c + col) =
          pack_bf16(bf16r(v0 + p.b2[col]) + x1.x, bf16r(v1 + p.b2[col + 1]) + x1.y);
    }
  });
}

bool shape_ok(int h, int w, int win, int c) {
  return win * win == kWinTok && h % win == 0 && w % win == 0 && h >= win && w >= win &&
         c > 0 && c <= kMaxC && c % 4 == 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). Shapes the kernels take (the
// Python wrappers check them, with dtypes, contiguity and devices): window
// 8 (64 tokens), h and w multiples of it, C <= 192 and a multiple of 4,
// hidden <= 384 and a multiple of 4, pointers 16-byte aligned. Launch on
// `stream`; return cudaGetLastError(), or cudaErrorInvalidValue for a shape
// the kernels do not take.
extern "C" int edtr_swin_pre(const void* x, const void* ln_s, const void* ln_b, const void* w,
                             const void* bias, void* qkv, void* xr, int batch, int h, int wd,
                             int win, int c, int d, float eps, void* stream) {
  if (!shape_ok(h, wd, win, c) || batch <= 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = (size_t)kWinTok * LDA * sizeof(bf16) + kRingBytes;
  cudaError_t err =
      cudaFuncSetAttribute(swin_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  PreArgs a = {static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
               static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
               static_cast<const float*>(bias), static_cast<bf16*>(qkv), static_cast<bf16*>(xr),
               h, wd, win, c, d, eps};
  dim3 grid(batch * (h / win) * (wd / win), (3 * c + kSlab - 1) / kSlab);
  swin_pre_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int edtr_swin_post(const void* attn, const void* xr, const void* wp, const void* bp,
                              const void* ln_s, const void* ln_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, void* out,
                              int batch, int h, int wd, int win, int c, int hidden, float eps,
                              void* stream) {
  if (!shape_ok(h, wd, win, c) || batch <= 0 || hidden <= 0 || hidden > kMaxHidden ||
      hidden % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(swin_post_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kPostSmem);
  if (err != cudaSuccess) return (int)err;
  PostArgs a = {static_cast<const bf16*>(attn), static_cast<const bf16*>(xr),
                static_cast<const bf16*>(wp),   static_cast<const float*>(bp),
                static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                static_cast<const bf16*>(w1),   static_cast<const float*>(b1),
                static_cast<const bf16*>(w2),   static_cast<const float*>(b2),
                static_cast<bf16*>(out),        h, wd, win, c, hidden, eps};
  const int blocks = batch * (h / win) * (wd / win) * (kWinTok / kPostTM);
  swin_post_kernel<<<blocks, kThreads, kPostSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
