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
// swin_post. SwinIR's widths (C 180, 3C 540, hidden 360) are multiples of
// neither 16 nor 32, and its 360-byte rows make odd rows only 8-byte
// aligned. So every operand is staged with 4- or 8-byte copies, the K walk
// of each GEMM is zero-padded to a multiple of 32 in shared memory, and the
// ragged column edge is masked in the epilogue. A block owns half a window
// (32 tokens, so that the 64 windows of a 512² image give 128 blocks for
// 132 SMs) and computes each projection in slabs of 192 output columns: 8
// warps of mma.sync m16n8k16 fed by ldmatrix, the weight rows of the slab
// streaming through a 3-deep cp.async ring of 32-channel chunks (the three
// weights, 324 KB in bf16, do not fit in shared memory together). x1 = xr +
// proj, its LN2 and the 32 x 360 GELU hidden stay in shared memory.
//
// swin_pre (pre_wgmma below), on wgmma with the weights fed by TMA. Its
// mma.sync predecessor (21.9 us of device time a call at the main-path
// shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) ran three serial
// phases a block and streamed the 360-byte weight rows in 8-byte
// cp.asyncs. Here a block owns
// one window (64 tokens: wgmma's M) and one slab of 192 qkv columns (grid
// 64 x 3 at bs 1, two blocks an SM):
// - the weights come from a bf16 copy zero-padded along K to a multiple of
//   64 channels (384-byte rows at C 180, ops/swin_block.py:pad_weight, cached
//   by models/layers.py:Linear.padded_weight), which a TMA map describes:
//   thread 0 issues the slab's 192 rows (72 KB, zeros past 3C) as 64-channel
//   boxes in the 128-byte swizzle at block start, so they land while the
//   block gathers and normalises;
// - the 256 threads gather the window's rolled rows, 8 lanes a token
//   (8-byte loads: x, qkv and the unpadded rows have no 16-byte stride, so
//   TMA cannot describe them; a row's statistics take 3 shuffle steps),
//   copy them to xr (slab 0 only), and write the LayerNorm, rounded to
//   bf16, straight into the swizzled K-major layout wgmma reads for A,
//   zeros past C;
// - each warpgroup issues wgmma m64n96k16 over its 96 columns (12 k-steps
//   at C 180); its epilogue adds the fp32 bias before the one rounding,
//   stages the 64 x 96 tile in its own (retired) weight rows and writes
//   the window-partitioned qkv a row's 8-byte pieces at a time, masked past
//   3C. (4-byte stores straight from the accumulator, each touching 8 rows
//   1080 bytes apart, and a warp a token with 5-step reductions were the two
//   largest costs of a first version on the card; PERF.md, PR 9.)
//
// What bounds them on an H100: at the main-path shape (1 x 4096 tokens,
// C 180) swin_pre moves ~7.6 MB for 0.80 GFLOP and swin_post ~4.7 MB for
// 1.33 GFLOP: under 300 FLOP per byte, so memory bounds both (~2.3 and
// ~1.4 us at 3.35 TB/s).

#include "sm90.cuh"

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
  const float* bias;    // (3C) qkv bias
  bf16* qkv;            // (B, nW, 64, 3C) windows
  bf16* xr;             // (B, h*w, C) x rolled by d
  int h, w, win, c, d;
  float eps;
};

// swin_pre on wgmma: a block owns one window (64 tokens, wgmma's M) and one
// slab of kSlab qkv columns, 96 for each of its two warpgroups.
namespace pre_wgmma {

using namespace edtr_sm90;

constexpr int kHalf = kSlab / 2;       // a warpgroup's qkv columns: wgmma m64n96k16
constexpr int kChunk = 64;             // channels a 128-byte swizzle row holds
constexpr int kRow = kChunk * 2;

template <int KCH>
constexpr int smem_bytes() {  // slack, A, the weight slab, the barrier, the LN affine
  return 1024 + KCH * (kWinTok + kSlab) * kRow + 8 + 2 * kMaxC * 4;
}

// byte offset of piece pc (channels 4pc..4pc+3) of token row r in the A
// tile: 64-channel chunks of 64 rows x 128 bytes, the 16-byte units of a
// row swizzled by its index (sw128_desc's layout)
__device__ __forceinline__ int a_offset(int r, int pc) {
  const int unit = (pc & 15) >> 1;
  return (pc >> 4) * (kWinTok * kRow) + r * kRow + ((unit ^ (r & 7)) << 4) + ((pc & 1) << 3);
}

// 4-byte word w of row r of a warpgroup's 64 x 96 bf16 output staging
// (192-byte rows), rotated by 4 (r % 8) words within the row, so that the 8
// rows an accumulator store touches start in distinct banks; 8-byte pairs
// (w even, w + 1) stay whole
__device__ __forceinline__ int stg_word(int r, int w) {
  return r * (kHalf / 2) + (w + ((r & 7) << 2)) % (kHalf / 2);
}

// grid (B * nW, ceil(3C / kSlab)); KCH = ceil(C / 64) chunks of K
template <int KCH>
__global__ void __launch_bounds__(kThreads, 2)
    swin_pre_kernel(const __grid_constant__ CUtensorMap wmap, const PreArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sA = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // [KCH][64][128 B]
  uint8_t* sW = sA + KCH * kWinTok * kRow;                      // [KCH][kSlab][128 B]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sW + KCH * kSlab * kRow);
  float* sLn = reinterpret_cast<float*>(bar + 1);  // [2][kMaxC]: LN scale, shift
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Geometry geo(blockIdx.x, p.h, p.w, p.win);
  const int c3 = 3 * p.c, n0 = blockIdx.y * kSlab;

  if (tid == 0) {  // the slab's weight rows (zeros past 3C), landing during the LayerNorm
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, KCH * kSlab * kRow);
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc) tma_load_2d(sW + kc * kSlab * kRow, &wmap, bar, kc * kChunk, n0);
  }
  for (int i = tid; i < 2 * kMaxC; i += kThreads) {
    const int ch = i % kMaxC;
    sLn[i] = ch < p.c ? __ldg((i < kMaxC ? p.ln_s : p.ln_b) + ch) : 0.f;
  }

  // Warp w takes tokens 8w..8w+7 in two passes of four, 8 lanes a token:
  // lane takes the 4-channel pieces sub, sub + 8, ... (sub = lane % 8) of
  // its token's rolled source row. Both passes' loads go out first.
  constexpr int PPL = kMaxC / 4 / 8;  // pieces a lane: 6
  const int units = p.c / 4, sub = lane & 7;
  uint2 u[2][PPL];
#pragma unroll
  for (int ps = 0; ps < 2; ++ps) {
    const int r = warp * 8 + ps * 4 + (lane >> 3);
    const int ys = ((geo.y(r) + p.d) % p.h + p.h) % p.h;
    const int xs = ((geo.x(r) + p.d) % p.w + p.w) % p.w;
    const bf16* src = p.x + ((size_t)geo.b * geo.L + (size_t)ys * p.w + xs) * p.c;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int pc = sub + 8 * k;
      u[ps][k] = pc < units ? __ldg(reinterpret_cast<const uint2*>(src + 4 * pc))
                            : make_uint2(0u, 0u);
    }
  }
  if (blockIdx.y == 0) {  // xr: the rolled tokens, once a window
#pragma unroll
    for (int ps = 0; ps < 2; ++ps) {
      bf16* dst = p.xr + geo.token(warp * 8 + ps * 4 + (lane >> 3)) * p.c;
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        const int pc = sub + 8 * k;
        if (pc < units) *reinterpret_cast<uint2*>(dst + 4 * pc) = u[ps][k];
      }
    }
  }
  __syncthreads();  // sLn

  // LayerNorm in fp32 (two passes, eps inside the rsqrt, affine without
  // contraction), rounded to bf16 into A; the channels from C to the end of
  // the last chunk are zeros (the weights' K padding is zero, but 0 * NaN
  // is not)
#pragma unroll
  for (int ps = 0; ps < 2; ++ps) {
    const int r = warp * 8 + ps * 4 + (lane >> 3);
    float f[PPL][4], sum = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const float2 lo = unpack2(u[ps][k].x), hi = unpack2(u[ps][k].y);
      f[k][0] = lo.x; f[k][1] = lo.y; f[k][2] = hi.x; f[k][3] = hi.y;
      sum += (f[k][0] + f[k][1]) + (f[k][2] + f[k][3]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / (float)p.c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k)
      if (sub + 8 * k < units)
#pragma unroll
        for (int e = 0; e < 4; ++e) q += (f[k][e] - mean) * (f[k][e] - mean);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q / (float)p.c + p.eps);
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int pc = sub + 8 * k;
      if (pc < KCH * 16) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[k][e], mean), rstd), sLn[4 * pc + e]),
                           sLn[kMaxC + 4 * pc + e]);
        const uint2 v = pc < units ? make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]))
                                   : make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(sA + a_offset(r, pc)) = v;
      }
    }
  }
  // the threads' A is read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // warpgroup wg: slab columns 96 wg .. 96 wg + 95, KCH x 4 k-steps; this
  // thread's bias pairs (columns 8t + 2tq) loaded while the MMAs run
  const int wg = warp >> 2, w4 = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int cb = n0 + wg * kHalf;  // the half's first column
  float2 bias[kHalf / 8];
#pragma unroll
  for (int t = 0; t < kHalf / 8; ++t) {
    const int col = cb + 8 * t + 2 * tq;
    bias[t] = col < c3 ? make_float2(__ldg(p.bias + col), __ldg(p.bias + col + 1))
                       : make_float2(0.f, 0.f);
  }
  const uint32_t a0 = smem_u32(sA), w0 = smem_u32(sW) + wg * kHalf * kRow;
  float acc[kHalf / 2];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar, 0);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KCH; ++kc)
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      Wgmma<kHalf>::mma(acc, sw128_desc(a0 + kc * kWinTok * kRow + kk * 32),
                        sw128_desc(w0 + kc * kSlab * kRow + kk * 32));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);

  // epilogue: + the fp32 bias, one rounding to bf16 (register 4t + 2h + e:
  // window token w4 * 16 + gq + 8h, column 8t + 2tq + e of the half), staged
  // in the half's own weight rows of chunk 0 (only its own wgmmas read
  // them, and they have retired), then stored a row's 8-byte pieces at a
  // time: the qkv rows (1080 bytes at C 180) are only 8-byte aligned
  uint32_t* stg = reinterpret_cast<uint32_t*>(sW + wg * kHalf * kRow);
#pragma unroll
  for (int t = 0; t < kHalf / 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      stg[stg_word(w4 * 16 + gq + 8 * h, 4 * t + tq)] =
          pack_bf16(acc[4 * t + 2 * h] + bias[t].x, acc[4 * t + 2 * h + 1] + bias[t].y);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int pieces = min(kHalf, c3 - cb) / 4;  // 8-byte pieces of a row (3C % 12 == 0)
  bf16* out = p.qkv + (size_t)blockIdx.x * kWinTok * c3 + cb;
  for (int i = tid & 127; i < kWinTok * pieces; i += 128) {
    const int r = i / pieces, pc = i % pieces;
    const uint2 v = *reinterpret_cast<const uint2*>(stg + stg_word(r, 2 * pc));
    *reinterpret_cast<uint2*>(out + (size_t)r * c3 + 4 * pc) = v;
  }
}

// the slab's weights: rows of the (3C, 64 KCH) zero-padded bf16 weight,
// which TMA reads in boxes of 64 channels x kSlab rows; 2 blocks an SM
template <int KCH>
int launch(const PreArgs& a, const void* w, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<KCH>();
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(swin_pre_kernel<KCH>, smem, raised, true);
  CUtensorMap wmap;
  if (r == 0) r = cached_matrix_map(w, 3 * a.c, KCH * kChunk, kSlab, &wmap);
  if (r != 0) return r;
  dim3 grid(batch * (a.h / a.win) * (a.w / a.win), (3 * a.c + kSlab - 1) / kSlab);
  swin_pre_kernel<KCH><<<grid, kThreads, smem, stream>>>(wmap, a);
  return (int)cudaGetLastError();
}

}  // namespace pre_wgmma

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
// hidden <= 384 and a multiple of 4, pointers 16-byte aligned; swin_pre's
// `w` is the (3C, 64 ceil(C / 64)) zero-padded weight. Launch on `stream`;
// return cudaGetLastError(), cudaErrorInvalidValue for a shape the kernels
// do not take, or the error of the one-time raise of a kernel's
// shared-memory limit (or, negated, of encoding a tensor map).
extern "C" int edtr_swin_pre(const void* x, const void* ln_s, const void* ln_b, const void* w,
                             const void* bias, void* qkv, void* xr, int batch, int h, int wd,
                             int win, int c, int d, float eps, void* stream) {
  if (!shape_ok(h, wd, win, c) || batch <= 0) return (int)cudaErrorInvalidValue;
  const PreArgs a = {static_cast<const bf16*>(x),     static_cast<const float*>(ln_s),
                     static_cast<const float*>(ln_b), static_cast<const float*>(bias),
                     static_cast<bf16*>(qkv),         static_cast<bf16*>(xr),
                     h, wd, win, c, d, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((c + pre_wgmma::kChunk - 1) / pre_wgmma::kChunk) {
    case 1: return pre_wgmma::launch<1>(a, w, batch, st);
    case 2: return pre_wgmma::launch<2>(a, w, batch, st);
    default: return pre_wgmma::launch<3>(a, w, batch, st);
  }
}

extern "C" int edtr_swin_post(const void* attn, const void* xr, const void* wp, const void* bp,
                              const void* ln_s, const void* ln_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, void* out,
                              int batch, int h, int wd, int win, int c, int hidden, float eps,
                              void* stream) {
  if (!shape_ok(h, wd, win, c) || batch <= 0 || hidden <= 0 || hidden > kMaxHidden ||
      hidden % 4)
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> raised{0u};
  const cudaError_t err = edtr::raise_smem_once(swin_post_kernel, kPostSmem, raised);
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
