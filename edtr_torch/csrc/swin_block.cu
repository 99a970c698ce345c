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
// Both run on wgmma with their weights fed by TMA. SwinIR's widths (C 180,
// 3C 540, hidden 360) are multiples of neither 16 nor 64, and its 360-byte
// token rows are only 8-byte aligned, so TMA cannot describe the tokens;
// the weights come from bf16 copies zero-padded along K to a multiple of 64
// channels (ops/swin_block.py:pad_weight, cached by
// models/layers.py:Linear.padded_weight), whose 128-byte-multiple rows a
// TMA map reads in 64-channel boxes in the 128-byte swizzle. A block owns
// one window (64 tokens: wgmma's M); its threads gather the tokens with
// 8-byte loads and write them, or their LayerNorm, straight into the
// swizzled K-major layout wgmma reads for A, zeros past C.
//
// swin_pre (pre_wgmma below). Its mma.sync predecessor (21.9 us of device
// time a call at the main-path shape on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md) ran three serial phases a block and streamed the 360-byte weight
// rows in 8-byte cp.asyncs. Here a block owns one window and one slab of
// 192 qkv columns (grid 64 x 3 at bs 1, two blocks an SM):
// - thread 0 issues the slab's 192 padded weight rows (72 KB, zeros past
//   3C) at block start, so they land while the block gathers and
//   normalises;
// - the 256 threads gather the window's rolled rows, 8 lanes a token (a
//   row's statistics take 3 shuffle steps), copy them to xr (slab 0 only),
//   and write the LayerNorm into A;
// - each warpgroup issues wgmma m64n96k16 over its 96 columns (12 k-steps
//   at C 180); its epilogue adds the fp32 bias before the one rounding,
//   stages the 64 x 96 tile in its own (retired) weight rows and writes
//   the window-partitioned qkv a row's 8-byte pieces at a time, masked past
//   3C. (4-byte stores straight from the accumulator, each touching 8 rows
//   1080 bytes apart, and a warp a token with 5-step reductions were the two
//   largest costs of a first version on the card; PERF.md, PR 9.)
//
// swin_post (post_wgmma below). Its mma.sync predecessor gave a block 32
// tokens and ran the three GEMMs in 192-column slabs, each streaming the
// whole weight through a 3-deep ring of 32-channel chunks in 8-byte
// cp.asyncs: 128 blocks each read all 324 KB of weights from L2, ~41 MB a
// call in 8-byte pieces, behind a __syncthreads every phase (31.75 us a
// call at the main-path shape on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md). Here:
// - a producer warp first brings the window's tokens by 1-D bulk copies:
//   its attention rows are one contiguous block, and in rolled token space
//   each of its 8 rows of tokens is 8 contiguous shortcut rows; then it
//   streams the three padded weights through a ring of 5 stages of 192
//   rows x 64 channels (24 KB, one TMA box): proj's, fc1's (a 192-column
//   slab of the hidden at a time) and fc2's, in the order the consumers
//   read them, so that the next GEMM's weights land during the previous
//   one's epilogue and LayerNorm;
// - four consumer warpgroups split every GEMM's output columns, 48 each
//   (wgmma m64n48k16, A from shared memory, each reading its quarter of
//   the stage's rows); a stage is freed once all four have retired the
//   wgmmas that read it. Four and not two: between the small GEMMs the
//   block's time goes to epilogues, the LayerNorm and the GELU, issue-bound
//   at one block an SM, and twice the warps halve each thread's share (a
//   two-warpgroup build took 18.5 us a call, this one 16.7);
// - x1 = xr + proj stays in shared memory (row-major, over the shortcut);
//   LN2 is computed in the proj epilogue from the accumulator registers,
//   each row's sum and squared deviations summed over a quad and across the
//   warpgroups through shared memory, and written to the swizzled A tile;
//   the 64 x 360 GELU hidden goes to a swizzled K-major tile that is fc2's
//   A; the biases are loaded while each GEMM's wgmmas run (in a first
//   version, loops of dependent loads and a warp a LayerNorm row took 20 of
//   a block's 23 us on an NVIDIA H100 80GB HBM3 at 700 W);
// - at bs 1 a window's work is split over a two-block cluster (64 windows
//   give 128 blocks for 132 SMs): both blocks compute x1 and its LN2, each
//   takes one 192-column slab of fc1's hidden and the matching 192 rows of
//   fc2's K, and each finishes half of the output columns from its own
//   fp32 partial plus its peer's, read through distributed shared memory,
//   always in the order slab 0 + slab 1, so that two calls agree bit for
//   bit; a block reads 216 KB of weights instead of 360. Where the windows
//   alone fill the card (bs 2) or the hidden is one slab, one block takes a
//   window (ops/swin_block.py:post_split), and writes its 8 rows of tokens
//   back by bulk copies.
//
// What bounds them on an H100: at the main-path shape (1 x 4096 tokens,
// C 180) swin_pre moves ~7.6 MB for 0.80 GFLOP and swin_post ~4.7 MB for
// 1.33 GFLOP: under 300 FLOP per byte, so memory bounds both (~2.3 and
// ~1.4 us at 3.35 TB/s); each block's weights come from L2.

#include "sm90.cuh"

namespace {

using namespace edtr;

constexpr int kThreads = 256;               // swin_pre: 8 warps
constexpr int kWinTok = 64;                 // tokens per window (win 8)
constexpr int kSlab = 192;                  // swin_pre: qkv columns a block
constexpr int kMaxC = 192;                  // channels, padded K of qkv/proj/fc1
constexpr int kMaxHidden = 384;             // MLP hidden, padded K of fc2

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return make_float2(__low2float(h), __high2float(h));
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

// swin_post on wgmma: a block owns one window (64 tokens, wgmma's M) or, in
// a two-block cluster (SPLIT 2), one window and half of its MLP hidden.
namespace post_wgmma {

using namespace edtr_sm90;

constexpr int kBoxRows = 192;             // weight rows a stage holds (all warpgroups')
constexpr int kGroups = 4;                 // consumer warpgroups, each kCols of a stage's rows
constexpr int kCols = kBoxRows / kGroups;  // a warpgroup's output columns: wgmma m64n48k16
constexpr int kChunk = 64;                 // channels a 128-byte swizzle row holds
constexpr int kRow = kChunk * 2;
constexpr int kSlabChunks = kBoxRows / kChunk;  // fc2 K chunks of one hidden slab
constexpr int kTile = kWinTok * kRow;      // one 64-channel chunk of the 64 rows: 8 KB
constexpr int kStage = kBoxRows * kRow;    // 24 KB
constexpr int kStages = 5;
constexpr int kMaxKC = kMaxC / kChunk;
constexpr int kMaxKH = kMaxHidden / kChunk;
constexpr int kConsumers = 128 * kGroups;
constexpr int kPostThreads = kConsumers + 32;  // and one producer warp
// slack, A, the hidden, the ring, x1, the LN2 affine, the row-statistics
// exchange, the barriers
constexpr int kSmem = 1024 + kMaxKC * kTile + kMaxKH * kTile + kStages * kStage +
                      kWinTok * kMaxC * 2 + 2 * kMaxC * 4 + 2 * kGroups * kWinTok * 4 +
                      (2 * kStages + 1) * 8;

struct PostArgs {
  const bf16* attn;     // (B, nW, 64, C) attention output windows
  const bf16* xr;       // (B, h*w, C) rolled shortcut
  const float* bp;      // (C) proj bias
  const float* ln_s;    // (C) LN2 affine
  const float* ln_b;
  const float* b1;      // (hidden) fc1 bias
  const float* b2;      // (C) fc2 bias
  bf16* out;            // (B, h*w, C), rolled
  int h, w, win, c, hidden;
  float eps;
};

// byte offset of element `col` (even) of token row r in a K-major A tile of
// 64-channel chunks (8 KB each), the 16-byte units of a row swizzled by the
// row's index (sw128_desc's layout)
__device__ __forceinline__ int sw_offset(int r, int col) {
  return (col >> 6) * kTile + r * kRow + ((((col & 63) >> 3) ^ (r & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of `p`'s counterpart in block `rank` of the
// cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// this thread's bias pairs of a warpgroup's kCols columns (column base + 8t +
// 2tq, zeros from `limit` on), loaded before the wgmmas whose epilogue adds
// them, so that their latency hides behind the MMAs
__device__ __forceinline__ void load_bias(float2 (&b)[kCols / 8], const float* __restrict__ bias,
                                          int base, int limit, int tq) {
#pragma unroll
  for (int t = 0; t < kCols / 8; ++t) {
    const int col = base + 8 * t + 2 * tq;
    b[t] = col < limit ? __ldg(reinterpret_cast<const float2*>(bias + col))
                       : make_float2(0.f, 0.f);
  }
}

// the two rows' sums of a quad (the 4 threads that share rows gq, gq + 8)
__device__ __forceinline__ void quad_sum(float& a, float& b) {
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
}

struct Ring {
  uint32_t base;    // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int it;           // stages consumed so far
};

// acc = A (nk chunks of 64 channels from a0, 8 KB apart) times the next nk
// ring stages' rows kCols wg .. kCols (wg + 1) - 1 (as B^T, K-major); a
// stage is released once this warpgroup's wgmmas that read it have retired
__device__ __forceinline__ void gemm(float (&acc)[kCols / 2], uint32_t a0, int nk, Ring& ring,
                                     int wg, bool leader) {
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int j = 0; j < nk; ++j, ++ring.it) {
    const int s = ring.it % kStages;
    mbar_wait(&ring.full[s], (ring.it / kStages) & 1);
    const uint32_t b0 = ring.base + s * kStage + wg * kCols * kRow;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      Wgmma<kCols>::mma(acc, sw128_desc(a0 + j * kTile + kk * 32), sw128_desc(b0 + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // the chunk before this one has been read
    fence_operands(acc);
    if (prev >= 0 && leader) mbar_arrive(&ring.empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (prev >= 0 && leader) mbar_arrive(&ring.empty[prev]);
}

// grid (B * nW * SPLIT), clusters of SPLIT blocks along x
template <int SPLIT>
__global__ void __launch_bounds__(kPostThreads, 1)
    swin_post_kernel(const __grid_constant__ CUtensorMap wpmap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map, const PostArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sA = smem_raw + (((raw + 1023u) & ~1023u) - raw);     // [kMaxKC][64][128 B]
  uint8_t* sH = sA + kMaxKC * kTile;                                // [kMaxKH][64][128 B]
  uint8_t* sRing = sH + kMaxKH * kTile;                             // [kStages][192][128 B]
  bf16* sX = reinterpret_cast<bf16*>(sRing + kStages * kStage);     // [64][C]
  float* sLn = reinterpret_cast<float*>(sX + kWinTok * kMaxC);       // [2][kMaxC]
  float* sRed = sLn + 2 * kMaxC;                              // [2 passes][kGroups][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sRed + 2 * kGroups * kWinTok);
  uint64_t* empty = full + kStages;
  uint64_t* in_bar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int window = blockIdx.x / SPLIT;
  uint32_t rank = 0;
  if (SPLIT > 1) asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const Geometry geo(window, p.h, p.w, p.win);
  const int c = p.c;
  const int kc_n = (c + kChunk - 1) / kChunk;            // K chunks of proj and fc1
  const int kh_n = (p.hidden + kChunk - 1) / kChunk;     // K chunks of fc2
  // this block's 192-column slabs of fc1's output and fc2's K chunks
  const int nb0 = SPLIT > 1 ? (int)rank : 0;
  const int nb_n = SPLIT > 1 ? 1 : (p.hidden + kBoxRows - 1) / kBoxRows;
  const int k3_0 = nb0 * kSlabChunks;
  const int k3_n = SPLIT > 1 ? min(kSlabChunks, kh_n - k3_0) : kh_n;
  const bf16* attn = p.attn + (size_t)window * kWinTok * c;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGroups);  // one arrival a warpgroup
    }
    mbar_init(in_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer: the tokens, then the weights as they are read
    if (lane == 0) {
      // the window's attention rows (contiguous, 64 x C) into sH, free until
      // fc1's epilogue; the shortcut's 8 window rows (8 contiguous tokens
      // each, at their rolled positions) into sX
      mbar_expect_tx(in_bar, 2 * kWinTok * c * 2);
      bulk_load(sH, attn, kWinTok * c * 2, in_bar);
      for (int y = 0; y < 8; ++y)
        bulk_load(sX + 8 * y * c, p.xr + geo.token(8 * y) * c, 8 * c * 2, in_bar);
      int it = 0;
      auto push = [&](const CUtensorMap* map, int col, int row) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        tma_load_2d(sRing + s * kStage, map, &full[s], col, row);
        ++it;
      };
      for (int kc = 0; kc < kc_n; ++kc) push(&wpmap, kc * kChunk, 0);
      for (int nb = nb0; nb < nb0 + nb_n; ++nb)
        for (int kc = 0; kc < kc_n; ++kc) push(&w1map, kc * kChunk, nb * kBoxRows);
      for (int kc = k3_0; kc < k3_0 + k3_n; ++kc) push(&w2map, kc * kChunk, 0);
    }
    if (SPLIT > 1) {  // every thread of the cluster takes part in its barriers
      __syncwarp();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int wg = warp >> 2, w4 = warp & 3, gq = lane >> 2, tq = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int r0 = w4 * 16 + gq;  // this thread's window rows r0, r0 + 8
  for (int i = tid; i < 2 * kMaxC; i += kConsumers) {
    const int ch = i % kMaxC;
    sLn[i] = ch < c ? __ldg((i < kMaxC ? p.ln_s : p.ln_b) + ch) : 0.f;
  }
  // the attention rows from sH into A's swizzled K-major layout, zeros up
  // to the chunk edge: a thread's 2 kc_n 8-byte pieces (of 64 rows x 16
  // kc_n)
  mbar_wait(in_bar, 0);
  {
    constexpr int kMaxPer = kWinTok * kMaxKC * (kChunk / 4) / kConsumers;
    const int pieces = kc_n * (kChunk / 4), per = kMaxPer * kc_n / kMaxKC, units = c / 4;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int i = tid + k * kConsumers, r = i / pieces, pc = i % pieces;
      if (k < per)
        *reinterpret_cast<uint2*>(sA + sw_offset(r, 4 * pc)) =
            pc < units ? *reinterpret_cast<const uint2*>(sH + (r * c + 4 * pc) * 2)
                       : make_uint2(0u, 0u);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // A is read by wgmma
  consumer_sync();

  Ring ring{smem_u32(sRing), full, empty, 0};
  const uint32_t a0 = smem_u32(sA), h0 = smem_u32(sH);
  const int cw = wg * kCols;  // the warpgroup's first column of a 192-column slab
  // SPLIT 2: the warpgroups whose columns this block finishes
  const bool finisher = SPLIT == 1 || wg / (kGroups / 2) == (int)rank;
  // accumulator register 4t + 2h + e: window row r0 + 8h, column cw + 8t +
  // 2tq + e of the slab
  float acc[kCols / 2];
  float2 bias[kCols / 8];

  // x1 = xr + bf16(attn @ Wp^T + bp), over xr in sX; then LN2(x1) from the
  // rows' statistics, summed over each quad and across the warpgroups'
  // columns (in their order) through shared memory (two passes: mean, then
  // variance)
  load_bias(bias, p.bp, cw, c, tq);
  gemm(acc, a0, kc_n, ring, wg, leader);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int t = 0; t < kCols / 8; ++t) {
    const int col = cw + 8 * t + 2 * tq;
    if (col < c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* x = reinterpret_cast<uint32_t*>(sX + (r0 + 8 * h) * c + col);
        const float2 r = unpack2(*x);
        const uint32_t v = pack_bf16(bf16r(acc[4 * t + 2 * h] + bias[t].x) + r.x,
                                     bf16r(acc[4 * t + 2 * h + 1] + bias[t].y) + r.y);
        *x = v;
        const float2 f = unpack2(v);
        (h ? s1 : s0) += f.x + f.y;
      }
    }
  }
  quad_sum(s0, s1);
  if (tq == 0) {
    sRed[wg * kWinTok + r0] = s0;
    sRed[wg * kWinTok + r0 + 8] = s1;
  }
  consumer_sync();  // x1 whole; every warpgroup past its reads of A
  float mean0 = 0.f, mean1 = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    mean0 += sRed[g * kWinTok + r0];
    mean1 += sRed[g * kWinTok + r0 + 8];
  }
  mean0 /= (float)c;
  mean1 /= (float)c;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int t = 0; t < kCols / 8; ++t) {
    const int col = cw + 8 * t + 2 * tq;
    if (col < c) {
      const float2 f0 = unpack2(*reinterpret_cast<const uint32_t*>(sX + r0 * c + col));
      const float2 f1 = unpack2(*reinterpret_cast<const uint32_t*>(sX + (r0 + 8) * c + col));
      q0 += (f0.x - mean0) * (f0.x - mean0) + (f0.y - mean0) * (f0.y - mean0);
      q1 += (f1.x - mean1) * (f1.x - mean1) + (f1.y - mean1) * (f1.y - mean1);
    }
  }
  quad_sum(q0, q1);
  if (tq == 0) {
    sRed[(kGroups + wg) * kWinTok + r0] = q0;
    sRed[(kGroups + wg) * kWinTok + r0 + 8] = q1;
  }
  consumer_sync();
  // ((x - mean) * rstd) * s + b in fp32 (eps inside the rsqrt), rounded to
  // bf16 into A; zeros from C to the chunk edge (the weights' K padding is
  // zero, but 0 * NaN is not)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float mean = h ? mean1 : mean0;
    float var = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) var += sRed[(kGroups + g) * kWinTok + r];
    const float rstd = rsqrtf(var / (float)c + p.eps);
#pragma unroll
    for (int t = 0; t < kCols / 8; ++t) {
      const int col = cw + 8 * t + 2 * tq;
      if (col < kc_n * kChunk) {
        uint32_t v = 0u;
        if (col < c) {
          const float2 f = unpack2(*reinterpret_cast<const uint32_t*>(sX + r * c + col));
          v = pack_bf16(
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.x, mean), rstd), sLn[col]),
                        sLn[kMaxC + col]),
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f.y, mean), rstd), sLn[col + 1]),
                        sLn[kMaxC + col + 1]));
        }
        *reinterpret_cast<uint32_t*>(sA + sw_offset(r, col)) = v;
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();

  // hidden = bf16(gelu(LN2(x1) @ W1^T + b1)) into sH, a 192-column slab at
  // a time (columns past the hidden are zeros: W1's rows past it read as
  // zeros, their bias is 0 and gelu(0) = 0)
  for (int nb = nb0; nb < nb0 + nb_n; ++nb) {
    load_bias(bias, p.b1, nb * kBoxRows + cw, p.hidden, tq);
    gemm(acc, a0, kc_n, ring, wg, leader);
#pragma unroll
    for (int t = 0; t < kCols / 8; ++t) {
      const int n = nb * kBoxRows + cw + 8 * t + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * t + 2 * h] + bias[t].x, v1 = acc[4 * t + 2 * h + 1] + bias[t].y;
        *reinterpret_cast<uint32_t*>(sH + sw_offset(r0 + 8 * h, n)) =
            pack_bf16(v0 * 0.5f * (1.f + erff(v0 * 0.70710678118654752f)),
                      v1 * 0.5f * (1.f + erff(v1 * 0.70710678118654752f)));
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();  // the hidden whole; A free

  // fc2 over this block's hidden chunks
  load_bias(bias, p.b2, cw, c, tq);
  gemm(acc, h0 + k3_0 * kTile, k3_n, ring, wg, leader);

  if (SPLIT > 1) {
    // the fp32 partial of the columns the peer finishes goes to A (free
    // now), register-major so that the peer's warpgroup of the same index
    // reads it in its own layout
    float4* xch = reinterpret_cast<float4*>(sA) + (wg % (kGroups / 2)) * (kCols / 8) * 128;
    const int t128 = tid & 127;
    if (!finisher)
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i)
        xch[i * 128 + t128] =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    cluster_sync();
    if (finisher) {
      const uint32_t peer = peer_addr(xch, rank ^ 1u);
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i) {  // slab 0's partial + slab 1's, in either block
        const float4 v = ld_peer4(peer + (uint32_t)(i * 128 + t128) * 16u);
        acc[4 * i] += v.x;
        acc[4 * i + 1] += v.y;
        acc[4 * i + 2] += v.z;
        acc[4 * i + 3] += v.w;
      }
    }
  }
  // out = x1 + bf16(hidden @ W2^T + b2), over x1 in sX
  if (finisher) {
#pragma unroll
    for (int t = 0; t < kCols / 8; ++t) {
      const int col = cw + 8 * t + 2 * tq;
      if (col < c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* x = reinterpret_cast<uint32_t*>(sX + (r0 + 8 * h) * c + col);
          const float2 r = unpack2(*x);
          *x = pack_bf16(bf16r(acc[4 * t + 2 * h] + bias[t].x) + r.x,
                         bf16r(acc[4 * t + 2 * h + 1] + bias[t].y) + r.y);
        }
      }
    }
  }
  if (SPLIT == 1) {
    // the 8 window rows, 8 contiguous tokens each, by bulk copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    if (tid == 0) {
      for (int y = 0; y < 8; ++y)
        bulk_store(p.out + geo.token(8 * y) * c, sX + 8 * y * c, 8 * c * 2);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    return;
  }
  // this block's output columns, 8-byte pieces at a time
  consumer_sync();
  {
    const int lo = min(c, (int)rank * (kBoxRows / 2)), hi = min(c, lo + kBoxRows / 2);
    const int np = (hi - lo) / 4;
    for (int i = tid; i < kWinTok * np; i += kConsumers) {
      const int r = i / np, pc = lo / 4 + i % np;
      *reinterpret_cast<uint2*>(p.out + geo.token(r) * c + 4 * pc) =
          *reinterpret_cast<const uint2*>(sX + r * c + 4 * pc);
    }
  }
  cluster_sync();  // the peer has read this block's partial
}

// the three padded weights ((C, 64 kc), (hidden, 64 kc), (C, 64 kh) bf16),
// read by TMA in boxes of 64 channels x 192 rows; one block an SM
template <int SPLIT>
int launch(const PostArgs& a, const void* wp, const void* w1, const void* w2, int batch,
           cudaStream_t stream) {
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(swin_post_kernel<SPLIT>, kSmem, raised, true);
  const int kc = (a.c + kChunk - 1) / kChunk, kh = (a.hidden + kChunk - 1) / kChunk;
  CUtensorMap m0, m1, m2;
  if (r == 0) r = cached_matrix_map(wp, a.c, kc * kChunk, kBoxRows, &m0);
  if (r == 0) r = cached_matrix_map(w1, a.hidden, kc * kChunk, kBoxRows, &m1);
  if (r == 0) r = cached_matrix_map(w2, a.c, kh * kChunk, kBoxRows, &m2);
  if (r != 0) return r;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * (a.h / a.win) * (a.w / a.win) * SPLIT);
  cfg.blockDim = dim3(kPostThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, swin_post_kernel<SPLIT>, m0, m1, m2, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace post_wgmma

bool shape_ok(int h, int w, int win, int c) {
  return win * win == kWinTok && h % win == 0 && w % win == 0 && h >= win && w >= win &&
         c > 0 && c <= kMaxC && c % 4 == 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). Shapes the kernels take (the
// Python wrappers check them, with dtypes, contiguity and devices): window
// 8 (64 tokens), h and w multiples of it, C <= 192 and a multiple of 4,
// hidden <= 384 and a multiple of 4, pointers 16-byte aligned; the weights
// are the zero-padded bf16 copies (ops/swin_block.py:pad_weight): swin_pre's
// `w` (3C, 64 ceil(C / 64)), swin_post's `wp` (C, 64 ceil(C / 64)), `w1`
// (hidden, 64 ceil(C / 64)) and `w2` (C, 64 ceil(hidden / 64)). Launch on
// `stream`; return cudaGetLastError(), cudaErrorInvalidValue for a shape the
// kernels do not take, or the error of the one-time raise of a kernel's
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

// `split` (ops/swin_block.py:post_split): 1, a block a window, or 2, a
// two-block cluster a window, each block one 192-column slab of the hidden
// (hidden > 192)
extern "C" int edtr_swin_post(const void* attn, const void* xr, const void* wp, const void* bp,
                              const void* ln_s, const void* ln_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, void* out,
                              int batch, int h, int wd, int win, int c, int hidden, float eps,
                              int split, void* stream) {
  if (!shape_ok(h, wd, win, c) || batch <= 0 || hidden <= 0 || hidden > kMaxHidden ||
      hidden % 4 || (split != 1 && split != 2) ||
      (split == 2 && hidden <= post_wgmma::kBoxRows))
    return (int)cudaErrorInvalidValue;
  const post_wgmma::PostArgs a = {
      static_cast<const bf16*>(attn), static_cast<const bf16*>(xr),
      static_cast<const float*>(bp),  static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const float*>(b1),
      static_cast<const float*>(b2),  static_cast<bf16*>(out),
      h, wd, win, c, hidden, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return split == 2 ? post_wgmma::launch<2>(a, wp, w1, w2, batch, st)
                    : post_wgmma::launch<1>(a, wp, w1, w2, batch, st);
}
