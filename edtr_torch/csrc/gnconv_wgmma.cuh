// GroupNorm-affine + SiLU + conv3x3 for Hopper (sm_90a): an implicit GEMM on
// wgmma, fed by TMA, that activates each halo pixel once per channel chunk.
// bf16 NHWC in and out, fp32 accumulation, zero padding 1; included by
// gn_conv.cu (gn_conv_whole, K5a; gn_conv_band, K5b).
//
// Replaces the Pallas TPU kernels edtr_tpu/ops/gn_conv.py:_kernel_{plain,
// emb,res,emb_res} (_call, the whole-image tier, its pallas_call at :501)
// and _band_{plain,emb,res,emb_res} (_band_call, the row-band tier, :570):
//
//   out = conv3x3(silu(bf16(x * mul + add))) + b [+ emb] [+ res]
//
// with the roundings of JAX's _body/_band_body: the affine in fp32 without
// contraction, rounded to bf16; SiLU in fp32 on the rounded value, rounded;
// fp32 sums; the epilogue rounds the sum, adds the bias rounded to bf16,
// then emb, then res, rounding after each add (gn_conv.py:_epilogue).
//
// What bounds it on an H100: 2*9*Cin FLOP per output element on bf16 data.
// The row-band shapes (16^2-512^2, Cin 128-2560) do hundreds of FLOP a
// byte: the tensor cores bound them. The whole-image tier (8^2 latents, 64
// pixels an image) reads 29.5-59 MB of weights for 64 pixels: the weight
// bytes bound it. Its predecessor (mma.sync, 32-channel steps with a
// barrier each, a 3-deep cp.async weight ring, the halo activated between
// taps by every thread) reached a third of cuDNN's speed. Here:
//
// 1. Work items. An item is a tile of TH x 8 output pixels and BN output
//    channels over a range of 64-channel chunks (all of them, or one split
//    of them). Row-band tier: TH = 16, each of two consumer warpgroups
//    takes 8 x 8 pixels (wgmma's M = 64) and all BN channels. Whole-image
//    tier: TH = 8, one 8 x 8 tile whose BN channels the warpgroups split.
//    A block walks items blockIdx.x, + gridDim.x, ... (at most one block
//    an SM), so that one item's loads and activation run while the item
//    before ends.
// 2. The halo once per chunk, activated in place. A producer warp TMA-loads
//    the chunk's (TH + 2) x 10 halo of x as 8 boxes of 8 channels (one per
//    16-byte channel group, no swizzle) into a three-stage ring, in the
//    layout wgmma reads (below); a stage is refilled once the consumers'
//    wgmmas that read it retired, and the third stage lets the load of
//    chunk j + 1 wait for that while the weights of chunk j stream. TMA's
//    zero fill outside the image is the conv's zero padding AFTER the
//    activation, since silu(0 * mul + add) is not 0: three activation
//    warps apply the affine and SiLU in place to the pixels inside the
//    image only, once a chunk (1.4-1.6x the tile's pixels, not 9x), while
//    the consumer warpgroups multiply the chunk before. Each activation
//    thread keeps one channel group's mul and add in registers for the
//    chunk. SiLU uses the fast exp and division intrinsics: s / (1 + e^-s)
//    in fp32 within a few fp32 ulps of the exact quotient, which the bf16
//    rounding after it hides but at rare ties (with the exact expf and
//    division the activation warps bounded the kernel: 1.6x slower,
//    PERF.md).
// 3. Shifted windows without copies. The halo is K-major WITHOUT swizzle:
//    channel group k (8 channels, 16 bytes) of halo pixel p at k * LBO + p *
//    16 bytes. wgmma's core matrix there is 8 rows of 16 bytes, 16 bytes
//    apart, so the window of tap (dr, dc) is the same tile at pixel offset
//    dr * 10 + dc (descriptor: a 16-byte aligned start, the next 8 output
//    pixels one halo row = 160 bytes on, the next channel group LBO bytes
//    on). Nine taps read one halo: no 1024-byte swizzle atom has to line up
//    with a window.
// 4. Weights through an mbarrier ring. The packed weights (3, 3, Cout, Cin)
//    are one (9 * Cout, Cin) matrix; each (chunk, tap) step is one BN x 64
//    TMA box (128-byte swizzle), 4 steps in flight. Each warpgroup issues
//    wgmma m64nWNk16 (A and B from shared memory) per step and frees a
//    stage once both warpgroups' wgmmas that read it retired.
// 5. Split K for small grids (the 8^2 and 16^2 UNet sites): the chunks are
//    split across blocks; each writes an fp32 partial, and the last block
//    of a tile to arrive (an atomic counter per tile, reset by that block)
//    sums them in split order, each split's loads issued together, so the
//    result does not depend on arrival order.
// 6. Epilogue from the registers, through a 16 x 16 staging buffer per warp
//    (whole 32-byte sectors a store). The residual rows of the item are
//    prefetched into L2 when its last chunk starts.

#pragma once

#include <atomic>

#include "sm90.cuh"

namespace edtr_gnconv {

using namespace edtr_sm90;
using edtr::bf16r;
using edtr::pack_bf16;

constexpr int KC = 64;                       // input channels a chunk
constexpr int TW = 8;                        // tile width in pixels
constexpr int HW = TW + 2;                   // halo width
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kActivators = 96;              // three activation warps
constexpr int kThreads = kConsumers + 32 + kActivators;  // and the producer warp
constexpr int kGroupThreads = kActivators / (KC / 8);    // 12 a channel group
constexpr int kRing = 3;                     // halo stages
constexpr int kStages = 4;                   // weight ring: deeper measured no faster
constexpr int kSmemLimit = 232448;
constexpr int kBarConsumers = 1;             // named barriers
constexpr int kBarActivators = 2;

struct Args {
  const float* mul;     // (batch, cin) folded GroupNorm
  const float* add;
  const float* bias;    // (cout)
  const bf16* emb;      // (batch, cout) or nullptr
  const bf16* res;      // NHWC (batch, h, w, cout) or nullptr
  bf16* out;            // NHWC (batch, h, w, cout)
  float* partial;       // (splits, batch*h*w, cout) fp32 when splits > 1
  int* counters;        // one zeroed arrival counter per output tile
  int batch, h, w, cin, cout;
  int splits, chunks_per_split;
};

// The tile of a kernel instance. SPLITN (the whole-image tier): one 8 x 8
// tile, BN = 2 * WN channels, a warpgroup each WN of them. Otherwise 16 x
// 8 pixels, a warpgroup each 8 x 8 of them and all BN = WN channels.
template <int WN, bool SPLITN>
struct Tile {
  static constexpr int TH = SPLITN ? 8 : 16;
  static constexpr int BN = SPLITN ? 2 * WN : WN;
  static constexpr int P = (TH + 2) * HW;               // halo pixels
  static constexpr int LBO = (P * 16 + 127) / 128 * 128;  // one channel group of them
  static constexpr int HALO_BYTES = (KC / 8) * LBO;
  static constexpr int W_BYTES = BN * KC * 2;
  // the alignment slack, the weight and halo rings, the output staging,
  // the barriers
  static constexpr int SMEM = 1024 + kStages * W_BYTES + kRing * HALO_BYTES +
                              (kConsumers / 32) * STG_WARP * 2 +
                              (3 * kRing + 2 * kStages) * 8 + 16;
  static_assert(SMEM <= kSmemLimit, "shared memory of a block");
};

// 8 channels of x -> silu(bf16(x * m + a)) in fp32 (fast exp and division),
// each rounded to bf16 once, by the packing
__device__ __forceinline__ uint4 activate8(const uint4& v, const float (&m)[8],
                                           const float (&a)[8]) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float s = bf16r(__fadd_rn(__fmul_rn(f[e], m[e]), a[e]));
    f[e] = __fdividef(s, 1.f + __expf(-s));
  }
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// Work item w: tile (fastest; consecutive blocks share a weight column
// block), column block, split.
struct Item {
  int img, y0, x0, tile, n0, c_begin, nch;
};

template <int TH, int BN>
__device__ __forceinline__ Item item_of(const Args& p, int w) {
  const int tiles_x = (p.w + TW - 1) / TW, tiles_y = (p.h + TH - 1) / TH;
  const int tiles = p.batch * tiles_y * tiles_x, ncb = p.cout / BN;
  Item it;
  const int t = w % tiles, cb = (w / tiles) % ncb, z = w / (tiles * ncb);
  it.x0 = (t % tiles_x) * TW;
  it.y0 = ((t / tiles_x) % tiles_y) * TH;
  it.img = t / (tiles_x * tiles_y);
  it.tile = cb * tiles + t;
  it.n0 = cb * BN;
  it.c_begin = z * p.chunks_per_split;
  it.nch = min(p.cin / KC, it.c_begin + p.chunks_per_split) - it.c_begin;  // >= 1
  return it;
}

template <int WN, bool SPLITN>
__global__ void __launch_bounds__(kThreads, 1)
    gnconv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap, const Args p) {
  typedef Tile<WN, SPLITN> T;
  constexpr int TH = T::TH, BN = T::BN, P = T::P, LBO = T::LBO;
  constexpr int HALO_BYTES = T::HALO_BYTES, W_BYTES = T::W_BYTES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sw = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // weight ring
  uint8_t* shalo = sw + kStages * W_BYTES;                       // halo ring
  bf16* stg = reinterpret_cast<bf16*>(shalo + kRing * HALO_BYTES);
  uint64_t* halo_full = reinterpret_cast<uint64_t*>(stg + (kConsumers / 32) * STG_WARP);
  uint64_t* halo_ready = halo_full + kRing;  // activated
  uint64_t* halo_empty = halo_ready + kRing;
  uint64_t* w_full = halo_empty + kRing;
  uint64_t* w_empty = w_full + kStages;
  int* s_last = reinterpret_cast<int*>(w_empty + kStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int items = p.batch * ((p.h + TH - 1) / TH) * ((p.w + TW - 1) / TW) *
                    (p.cout / BN) * p.splits;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&halo_full[s], 1);
      mbar_init(&halo_ready[s], 1);
      mbar_init(&halo_empty[s], 2);  // one arrival from each consumer warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer: each chunk's halo ahead of its weights
    if (lane == 0) {
      int r = 0, s = 0;
      uint32_t ph = 0;
      auto load_halo = [&](const Item& it, int j) {  // chunk j of the item, ring slot r
        const int q = r % kRing;
        mbar_wait(&halo_empty[q], ((r / kRing) & 1) ^ 1);
        mbar_expect_tx(&halo_full[q], P * KC * 2);
        for (int k = 0; k < KC / 8; ++k)
          tma_load_4d(shalo + q * HALO_BYTES + k * LBO, &xmap, &halo_full[q],
                      (it.c_begin + j) * KC + 8 * k, it.x0 - 1, it.y0 - 1, it.img);
        ++r;
      };
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it = item_of<TH, BN>(p, w);
        load_halo(it, 0);
        for (int j = 0; j < it.nch; ++j) {
          if (j + 1 < it.nch) load_halo(it, j + 1);
          for (int t = 0; t < 9; ++t) {
            mbar_wait(&w_empty[s], ph ^ 1);
            mbar_expect_tx(&w_full[s], W_BYTES);
            tma_load_2d(sw + s * W_BYTES, &wmap, &w_full[s], (it.c_begin + j) * KC,
                        t * p.cout + it.n0);
            if (++s == kStages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  if (warp > kConsumers / 32) {  // the activation warps: in place, in-image pixels only
    const int ta = tid - kConsumers - 32;
    const int k = ta / kGroupThreads, sub = ta - k * kGroupThreads;  // channel group, lane in it
    int r = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item it = item_of<TH, BN>(p, w);
      for (int j = 0; j < it.nch; ++j, ++r) {
        const int q = r % kRing;
        const size_t c0 = (size_t)it.img * p.cin + (size_t)(it.c_begin + j) * KC + 8 * k;
        float m[8], a[8];
        load8f(p.mul + c0, m);
        load8f(p.add + c0, a);
        mbar_wait(&halo_full[q], (r / kRing) & 1);
        uint8_t* plane = shalo + q * HALO_BYTES + k * LBO;
        // consecutive threads take consecutive pixels of one channel group
#pragma unroll 3
        for (int px = sub; px < P; px += kGroupThreads) {
          const int hr = px / HW, y = it.y0 - 1 + hr, x = it.x0 - 1 + (px - hr * HW);
          if (y >= 0 && y < p.h && x >= 0 && x < p.w) {
            uint4* u = reinterpret_cast<uint4*>(plane + px * 16);
            *u = activate8(*u, m, a);
          }
        }
        // the halo complete for the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, %1;\n" ::"n"(kBarActivators), "n"(kActivators) : "memory");
        if (ta == 0) mbar_arrive(&halo_ready[q]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g
  const int g = warp >> 2, w4 = warp & 3, gq = lane >> 2, tq = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int row0 = SPLITN ? 0 : 8 * g;  // the warpgroup's first output row in the tile
  const uint32_t halo0 = smem_u32(shalo) + row0 * HW * 16;
  const uint32_t w0 = smem_u32(sw) + (SPLITN ? g * WN * KC * 2 : 0);
  bf16* wstg = stg + warp * STG_WARP;
  const size_t M = (size_t)p.batch * p.h * p.w;
  float acc[WN / 2];
  int r = 0, s = 0, prev = -1, held = -1;  // held: the halo stage in-flight wgmmas read
  uint32_t ph = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it = item_of<TH, BN>(p, w);
    const int nc0 = it.n0 + (SPLITN ? g * WN : 0);
    // accumulator register 4q + 2h + e: row w4*16 + gq + 8h (tile pixel
    // (row0 + row / 8, row % 8)), column 8q + 2tq + e of the warpgroup's WN
    auto pixel = [&](int rr) -> long long {
      const int y = it.y0 + row0 + (rr >> 3), x = it.x0 + (rr & 7);
      return (y < p.h && x < p.w) ? ((long long)it.img * p.h + y) * p.w + x : -1;
    };
    const long long pm[2] = {pixel(w4 * 16 + gq), pixel(w4 * 16 + gq + 8)};
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < it.nch; ++j, ++r) {
      const int q = r % kRing;
      mbar_wait(&halo_ready[q], (r / kRing) & 1);
      const uint32_t a0 = halo0 + q * HALO_BYTES;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        mbar_wait(&w_full[s], ph);
        fence_operands(acc);
        wgmma_fence();
        const uint32_t a = a0 + ((t / 3) * HW + t % 3) * 16;  // window of tap (t / 3, t % 3)
        const uint32_t b = w0 + s * W_BYTES;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          Wgmma<WN>::mma(acc, kmajor_desc(a + kk * 2 * LBO, LBO, HW * 16),
                         sw128_desc(b + kk * 32));
        wgmma_commit();
        wgmma_wait<1>();  // the step before has read its stages
        fence_operands(acc);
        if (leader) {
          if (prev >= 0) mbar_arrive(&w_empty[prev]);
          if (t == 0 && held >= 0) mbar_arrive(&halo_empty[held]);
        }
        if (t == 0) held = q;
        if (t == 0 && j + 1 == it.nch && p.res != nullptr) {  // this thread's quarter of its rows
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (pm[h] >= 0)
              asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p.res + pm[h] * p.cout + nc0 +
                                                              tq * (WN / 4)));
        }
        prev = s;
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (leader) {
      mbar_arrive(&w_empty[prev]);
      mbar_arrive(&halo_empty[held]);
    }
    prev = held = -1;

    // split K: publish this item's partial; the last block of the tile sums
    if (p.splits > 1) {
      const int z = it.c_begin / p.chunks_per_split;
      float* part = p.partial + (size_t)z * M * p.cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pm[h] < 0) continue;
#pragma unroll
        for (int qq = 0; qq < WN / 8; ++qq)
          *reinterpret_cast<float2*>(part + (size_t)pm[h] * p.cout + nc0 + 8 * qq + 2 * tq) =
              make_float2(acc[4 * qq + 2 * h], acc[4 * qq + 2 * h + 1]);
      }
      __threadfence();
      asm volatile("bar.sync %0, %1;\n" ::"n"(kBarConsumers), "n"(kConsumers) : "memory");
      if (tid == 0) *s_last = atomicAdd(p.counters + it.tile, 1) == p.splits - 1;
      asm volatile("bar.sync %0, %1;\n" ::"n"(kBarConsumers), "n"(kConsumers) : "memory");
      if (!*s_last) continue;
      __threadfence();
      // the sum in split order; each split's loads a thread issued together
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
      for (int zz = 0; zz < p.splits; ++zz)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pm[h] < 0) continue;
          const float* row = p.partial + ((size_t)zz * M + pm[h]) * p.cout + nc0 + 2 * tq;
#pragma unroll
          for (int qq = 0; qq < WN / 8; ++qq) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(row + 8 * qq));
            acc[4 * qq + 2 * h] += v.x;
            acc[4 * qq + 2 * h + 1] += v.y;
          }
        }
      if (tid == 0) p.counters[it.tile] = 0;  // ready for the next launch
    }

    // epilogue: round, + bias, + emb, + res (each in bf16); 16 x 16 blocks
    // through the warp's staging buffer, lane l storing half l % 2 of row l / 2
    const long long mo = pixel(w4 * 16 + (lane >> 1));
#pragma unroll
    for (int qq = 0; qq < WN / 8; qq += 2) {
      float o[8];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int n = nc0 + 8 * (qq + nb) + 2 * tq;
        const float2 bv = __ldg(reinterpret_cast<const float2*>(p.bias + n));
        float2 ev = make_float2(0.f, 0.f);
        if (p.emb != nullptr) {
          const __nv_bfloat162 e =
              *reinterpret_cast<const __nv_bfloat162*>(p.emb + (size_t)it.img * p.cout + n);
          ev = make_float2(__low2float(e), __high2float(e));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = bf16r(bf16r(acc[4 * (qq + nb) + 2 * h]) + bf16r(bv.x));
          float v1 = bf16r(bf16r(acc[4 * (qq + nb) + 2 * h + 1]) + bf16r(bv.y));
          if (p.emb != nullptr) {
            v0 = bf16r(v0 + ev.x);
            v1 = bf16r(v1 + ev.y);
          }
          if (p.res != nullptr && pm[h] >= 0) {
            const __nv_bfloat162 rv =
                *reinterpret_cast<const __nv_bfloat162*>(p.res + (size_t)pm[h] * p.cout + n);
            v0 = bf16r(v0 + __low2float(rv));
            v1 = bf16r(v1 + __high2float(rv));
          }
          o[4 * nb + 2 * h] = v0;
          o[4 * nb + 2 * h + 1] = v1;
        }
      }
      store16x16_rows(wstg, o, lane, mo < 0 ? nullptr : p.out + mo * p.cout + nc0 + 8 * qq);
    }
  }
}

// One launch over the items (batch x ceil(h / TH) x ceil(w / 8) tiles x
// cout / BN column blocks x splits), at most `sms` blocks, with a 4-stage
// weight ring; the dynamic shared-memory limit is raised once per device.
// x (batch, h, w, cin) NHWC bf16, w (9 * cout, cin) bf16.
template <int WN, bool SPLITN>
int launch(const void* x, const void* w, Args a, int sms, cudaStream_t stream) {
  typedef Tile<WN, SPLITN> T;
  const int chunks = a.cin / KC;
  if (a.cin % KC || a.cin <= 0 || a.cout % T::BN || a.cout <= 0 || a.h <= 0 || a.w <= 0 ||
      a.batch <= 0 || a.splits < 1 || a.chunks_per_split < 1 || sms < 1 ||
      (a.splits - 1) * a.chunks_per_split >= chunks || a.splits * a.chunks_per_split < chunks)
    return (int)cudaErrorInvalidValue;  // every split non-empty, every chunk in one
  const long long items = (long long)a.batch * ((a.h + T::TH - 1) / T::TH) *
                          ((a.w + TW - 1) / TW) * (a.cout / T::BN) * a.splits;
  if (items > (1LL << 30)) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> raised{0u};
  int r = (int)edtr::raise_smem_once(gnconv_wgmma_kernel<WN, SPLITN>, kSmemLimit, raised);
  CUtensorMap wmap, xmap;
  if (r == 0) r = cached_matrix_map(w, 9 * a.cout, a.cin, T::BN, &wmap);
  if (r == 0) {
    const uint64_t dims[4] = {(uint64_t)a.cin, (uint64_t)a.w, (uint64_t)a.h, (uint64_t)a.batch};
    const uint32_t box[4] = {8, HW, T::TH + 2, 1};
    r = cached_map(x, 4, dims, box, &xmap, false);
  }
  if (r != 0) return r;
  const int blocks = (int)(items < sms ? items : sms);
  gnconv_wgmma_kernel<WN, SPLITN>
      <<<blocks, kThreads, T::SMEM, stream>>>(wmap, xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace edtr_gnconv
