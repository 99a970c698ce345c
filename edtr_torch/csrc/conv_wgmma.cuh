// Nearest-2x + conv3x3 for Hopper (sm_90a): a phase-folded implicit GEMM on
// wgmma, fed by TMA. bf16 NHWC in and out, fp32 accumulation, zero padding
// 1; included by gn_conv.cu (upsample_conv, K6).
//
// Replaces the Pallas TPU kernel edtr_tpu/ops/gn_conv.py:_ups_kernel
// (upsample_conv, its pallas_call at :874):
//
//   out = act(conv3x3(nearest2x(x)) + b), act none or LeakyReLU(0.2)
//
// The function. Output pixel (2i+a, 2j+b) -- phase p = 2a+b -- reads only
// the low-res pixels (i+r, j+c) with r in {a-1, a}, c in {b-1, b}: nearest
// duplication sends two of the three hi-res taps of each axis to one
// low-res pixel, so each phase is a 2x2 conv of the low-res input with
// folded taps (ops/gn_conv.py:fold_subpixel_weights, JAX's
// _fold_subpixel_weights: 4/9 of the 9-tap work). Over the 9 low-res
// offsets (r, c) in {-1, 0, 1}^2 the 16 (phase, tap) products of a channel
// chunk fall as: the centre feeds 4 phases, each edge 2, each corner 1.
//
// What bounds it on an H100: 2*4*Cin FLOP per output element on bf16 data,
// hundreds of FLOP per byte at every site but the 8x8-input UNet one
// (Cin = Cout = 1280, 30 MB of weights for 64 input pixels: bytes), so the
// tensor cores bound it. Its predecessor (conv3x3_kernel's nearest-2x mode,
// mma.sync) ran all 9 taps on the hi-res gather and staged the halo through
// registers with a barrier per 32 channels. Here:
//
// 1. A block owns a low-res tile of 8 x 16 (or 16 x 8) pixels, two 8 x 8
//    halves, one to each of two consumer warpgroups (wgmma's 64 rows), and
//    64 output channels of all 4 phases.
// 2. A operand. For each 64-channel chunk and each offset (r, c) the
//    producer TMA-loads the two halves' shifted 8 x 8 windows
//    from the NHWC input (4-D boxes {64 ch, 8, 8, 1} at (c0, x+c, y+r,
//    img)): each lands as a canonical K-major 128-byte-swizzled A tile, 64
//    pixel rows of 128 bytes. TMA's zero fill outside the image is exactly
//    the conv's zero padding: the kernel applies no activation to its input.
// 3. B operand. The folded weights, (4 phases, 2, 2, Cout, Cin) bf16, come
//    through the same ring: the stage of offset (r, c) also holds the 64 x
//    64-channel box of each phase that offset feeds, and the window is
//    multiplied by each (wgmma m64n64k16, both operands in shared memory),
//    each phase summing into its own 32-register accumulator: 16 products a
//    chunk, 4/9 of the 9-tap conv's 36 on the hi-res gather (offset_mma).
//    The 4 accumulators of 64 x 64 fp32 are 128 registers a thread. A producer
//    warpgroup (setmaxnreg: 40 registers, the consumers 232) keeps a
//    4-stage mbarrier ring of 48 KB stages (2 windows, up to 4 weight
//    boxes) full, refilling a stage as soon as both consumer warpgroups'
//    wgmmas that read it retired, so the consumers never wait on each
//    other. (Issuing the loads from a consumer thread, which first waited
//    for the other warpgroup, was 1.3x slower at the large sites; a 6-stage
//    ring of 32 KB stages, the centre in two steps, slower still: PERF.md.)
// 4. Small grids (the UNet's 8^2 and 16^2 inputs at 1280 channels give 20
//    and 40 blocks) split the channel chunks across blocks (gridDim.z):
//    each writes an fp32 partial, and the last block of a tile to arrive (an
//    atomic counter per tile, reset by that block) sums them in split order,
//    so the result does not depend on arrival order.
// 5. Epilogue from the registers: round to bf16, add the fp32 bias rounded
//    to bf16 and round again, then LeakyReLU(0.2) on the rounded value at
//    the SwinIR sites (gn_conv.py:_ups_act_kernel); each phase goes to its
//    strided hi-res pixels through a 16 x 16 staging buffer per warp,
//    whole 32-byte sectors a store.

#pragma once

#include <atomic>
#include <type_traits>

#include "sm90.cuh"

namespace edtr_upconv {

using namespace edtr_sm90;

constexpr int KC = 64;                       // input channels a chunk
constexpr int BN = 64;                       // output channels a block, each phase
constexpr int WIN = 8;                       // a warpgroup's window: 8 x 8 pixels
constexpr int A_BYTES = WIN * WIN * KC * 2;  // 8 KB: one shifted window
constexpr int B_BYTES = BN * KC * 2;         // 8 KB: one (phase, tap) weight box
constexpr int STAGE_BYTES = 2 * A_BYTES + 4 * B_BYTES;
constexpr int kStages = 4;
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup (one thread
// issues the loads) hands most of its share to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmem = 1024 + kStages * STAGE_BYTES + (kConsumers / 32) * STG_WARP * 2 +
                      2 * kStages * 8 + 16;

struct UpArgs {
  const float* bias;    // (cout)
  bf16* out;            // NHWC (batch, 2h, 2w, cout)
  float* partial;       // (splits, batch*2h*2w, cout) fp32 when gridDim.z > 1
  int* counters;        // one zeroed arrival counter per output tile
  int batch, h, w, cin, cout;  // h, w: the low-res input
  int tw;               // tile width: 16 (halves side by side) or 8 (stacked)
  int chunks_per_split;
  int lrelu;
};

// offset o = 0..8 is (r, c) = (o / 3 - 1, o % 3 - 1); the phases a of a row
// offset r: r = -1 feeds a = 0 (tap row 0), r = 0 both (a = 0 with tap row
// 1, a = 1 with tap row 0), r = 1 a = 1 (tap row 1); the same for columns
__host__ __device__ constexpr int lo_of(int r) { return r == 1 ? 1 : 0; }
__host__ __device__ constexpr int hi_of(int r) { return r == -1 ? 0 : 1; }
__host__ __device__ constexpr int phases_of(int o) {
  return (hi_of(o / 3 - 1) - lo_of(o / 3 - 1) + 1) *
         (hi_of(o % 3 - 1) - lo_of(o % 3 - 1) + 1);
}

// The wgmmas of offset O over one k16 step: the window (shared memory at
// a) against the stacked weight boxes (at b) of the phases it feeds, in
// phase order, one m64n64k16 product into each phase's accumulator. (One
// wider product over several phases' accumulators at once made ptxas
// serialise the wgmma pipeline, C7511: a wgmma's accumulator is one
// register range, and the column edges' two phases, b and 2+b, are not.)
template <int O>
__device__ __forceinline__ void offset_mma(float (&acc)[4][32], uint32_t a, uint32_t b) {
  constexpr int r = O / 3 - 1, c = O % 3 - 1;
  const uint64_t da = sw128_desc(a);
  int i = 0;
#pragma unroll
  for (int pa = lo_of(r); pa <= hi_of(r); ++pa)
#pragma unroll
    for (int pb = lo_of(c); pb <= hi_of(c); ++pb, ++i)
      Wgmma<64>::mma(acc[2 * pa + pb], da, sw128_desc(b + i * B_BYTES));
}

template <int O>
__device__ __forceinline__ void offset_mmas(float (&acc)[4][32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) offset_mma<O>(acc, a + kk * 32, b + kk * 32);
}

template <int R>
__device__ __forceinline__ void fence_all(float (&acc)[4][R]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) fence_operands(acc[p]);
}

__global__ void __launch_bounds__(kThreads, 1)
    upconv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap, const UpArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  bf16* stg = reinterpret_cast<bf16*>(ring + kStages * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + (kConsumers / 32) * STG_WARP);
  uint64_t* empty = full + kStages;
  int* s_last = reinterpret_cast<int*>(empty + kStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tw = p.tw, th = 128 / tw;
  const int tiles_x = (p.w + tw - 1) / tw, tiles_y = (p.h + th - 1) / th;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * th, x0 = tx * tw;
  const int n0 = blockIdx.y * BN;
  const int kch = (p.cin + KC - 1) / KC;
  const int c_begin = blockIdx.z * p.chunks_per_split;
  const int c_end = min(kch, c_begin + p.chunks_per_split);
  const int steps = 9 * (c_end - c_begin);
  // the origin of warpgroup g's 8 x 8 half within the tile
  auto half_y = [&](int g) { return tw == 16 ? 0 : WIN * g; };
  auto half_x = [&](int g) { return tw == 16 ? WIN * g : 0; };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival from each warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step n: chunk c_begin + n / 9, offset n % 9, ring stage n % kStages.
  // Its loads: the two windows, then the weight box of each phase the
  // offset feeds, in phase order.
  auto load_step = [&](int n) {
    const int s = n % kStages, kc = c_begin + n / 9, o = n % 9;
    const int r = o / 3 - 1, c = o % 3 - 1;
    mbar_expect_tx(&full[s], 2 * A_BYTES + phases_of(o) * B_BYTES);
    uint8_t* dst = ring + s * STAGE_BYTES;
    for (int h = 0; h < 2; ++h)
      tma_load_4d(dst + h * A_BYTES, &xmap, &full[s], kc * KC, x0 + half_x(h) + c,
                  y0 + half_y(h) + r, img);
    int i = 0;
    for (int a = lo_of(r); a <= hi_of(r); ++a)
      for (int b = lo_of(c); b <= hi_of(c); ++b, ++i) {
        const int tap = 2 * (r + 1 - a) + (c + 1 - b);  // (dr, dc) of phase (a, b)
        tma_load_2d(dst + 2 * A_BYTES + i * B_BYTES, &wmap, &full[s], kc * KC,
                    ((2 * a + b) * 4 + tap) * p.cout + n0);
      }
  };
  if (warp >= kConsumers / 32) {  // the producer: every step's loads, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0)
      for (int n = 0; n < steps; ++n) {
        mbar_wait(&empty[n % kStages], ((n / kStages) & 1) ^ 1);
        load_step(n);
      }
    return;
  }

  // consumer warpgroup g multiplies its window of every stage
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = warp >> 2, w4 = warp & 3, gq = lane >> 2, tq = lane & 3;
  const bool leader = (tid & 127) == 0;
  const uint32_t ring0 = smem_u32(ring);
  float acc[4][32];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
  auto step = [&](auto o_const, int n) {
    constexpr int O = decltype(o_const)::value;
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    fence_all(acc);
    wgmma_fence();
    const uint32_t base = ring0 + s * STAGE_BYTES;
    offset_mmas<O>(acc, base + g * A_BYTES, base + 2 * A_BYTES);
    wgmma_commit();
    wgmma_wait<1>();  // step n - 1's products have read their stage
    fence_all(acc);
    if (n > 0 && leader) mbar_arrive(&empty[(n - 1) % kStages]);  // refill it
  };
  for (int n = 0; n < steps; n += 9) {
    step(std::integral_constant<int, 0>(), n);
    step(std::integral_constant<int, 1>(), n + 1);
    step(std::integral_constant<int, 2>(), n + 2);
    step(std::integral_constant<int, 3>(), n + 3);
    step(std::integral_constant<int, 4>(), n + 4);
    step(std::integral_constant<int, 5>(), n + 5);
    step(std::integral_constant<int, 6>(), n + 6);
    step(std::integral_constant<int, 7>(), n + 7);
    step(std::integral_constant<int, 8>(), n + 8);
  }
  wgmma_wait<0>();
  fence_all(acc);

  // accumulator row m of warpgroup g: low-res pixel (y0 + half_y + m / 8,
  // x0 + half_x + m % 8); its hi-res pixel of phase (a, b), or -1 outside
  const int h2 = 2 * p.h, w2 = 2 * p.w;
  auto hi_pixel = [&](int m, int a, int b) -> long long {
    const int y = y0 + half_y(g) + (m >> 3), x = x0 + half_x(g) + (m & 7);
    if (y >= p.h || x >= p.w) return -1;
    return ((long long)img * h2 + 2 * y + a) * w2 + 2 * x + b;
  };

  // split K: publish this block's partial; the last block of the tile sums
  if (gridDim.z > 1) {
    const size_t M2 = (size_t)p.batch * h2 * w2;
    float* part = p.partial + (size_t)blockIdx.z * M2 * p.cout;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long m = hi_pixel(w4 * 16 + gq + 8 * hh, q >> 1, q & 1);
        if (m < 0) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(part + (size_t)m * p.cout + n0 + 8 * j + 2 * tq) =
              make_float2(acc[q][4 * j + 2 * hh], acc[q][4 * j + 2 * hh + 1]);
      }
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) *s_last = atomicAdd(p.counters + tile, 1) == (int)gridDim.z - 1;
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (!*s_last) return;
    __threadfence();
    // the sum in split order; each split's 64 loads a thread issued together
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
    for (int z = 0; z < (int)gridDim.z; ++z)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long m = hi_pixel(w4 * 16 + gq + 8 * hh, q >> 1, q & 1);
          if (m < 0) continue;
          const float* row = p.partial + ((size_t)z * M2 + m) * p.cout + n0 + 2 * tq;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(row + 8 * j));
            acc[q][4 * j + 2 * hh] += v.x;
            acc[q][4 * j + 2 * hh + 1] += v.y;
          }
        }
    if (tid == 0) p.counters[tile] = 0;  // ready for the next launch
  }

  // epilogue: round, + bias in bf16, LeakyReLU; 16 x 16 blocks through the
  // warp's staging buffer, lane l storing half l % 2 of row l / 2
  bf16* wstg = stg + warp * STG_WARP;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long m = hi_pixel(w4 * 16 + (lane >> 1), q >> 1, q & 1);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float o[8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 8 * (j + hh) +
                                                               2 * tq));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = edtr::bf16r(edtr::bf16r(acc[q][4 * (j + hh) + i]) +
                                edtr::bf16r(i & 1 ? b.y : b.x));
          if (p.lrelu && v < 0.f) v = edtr::bf16r(v * 0.2f);
          o[4 * hh + i] = v;
        }
      }
      store16x16_rows(wstg, o, lane, m < 0 ? nullptr : p.out + m * p.cout + n0 + 8 * j);
    }
  }
}

// One launch over batch x ceil(h / th) x ceil(w / tw) tiles x cout / 64
// column blocks x splits; the dynamic shared-memory limit is raised once
// per device. x (batch, h, w, cin) NHWC bf16, w (16 * cout, cin) bf16.
inline int launch(const void* x, const void* w, UpArgs a, int splits, cudaStream_t stream) {
  if ((a.tw != 8 && a.tw != 16) || a.cin % 32 || a.cin <= 0 || a.cout % BN || a.cout <= 0 ||
      splits < 1 || a.chunks_per_split < 1)
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(upconv_wgmma_kernel, kSmem, raised);
  CUtensorMap wmap, xmap;
  if (r == 0) r = cached_matrix_map(w, 16 * a.cout, a.cin, BN, &wmap);
  if (r == 0) {
    const uint64_t dims[4] = {(uint64_t)a.cin, (uint64_t)a.w, (uint64_t)a.h,
                              (uint64_t)a.batch};
    const uint32_t box[4] = {KC, WIN, WIN, 1};
    r = cached_map(x, 4, dims, box, &xmap);
  }
  if (r != 0) return r;
  const int th = 128 / a.tw;
  const int tiles = a.batch * ((a.h + th - 1) / th) * ((a.w + a.tw - 1) / a.tw);
  dim3 grid(tiles, a.cout / BN, splits);
  upconv_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(wmap, xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace edtr_upconv
