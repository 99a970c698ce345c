// Windowed attention of SwinIR for Hopper (sm_90a) on wgmma, a window's
// packed q/k/v rows brought into shared memory by one 1-D bulk copy:
//
//   O[w, :, h, :] = softmax(Q K^T * scale + bias[h] + mask[w mod nW]) V
//
// over 64-token windows, bf16 in and out, fp32 logits, softmax and
// accumulators.
//
// Replaces the Pallas TPU kernel of edtr_tpu/ops/window_attention.py:
// _win_kernel (_win_fwd, its pallas_call at :95). Its numerics: S = (Q K^T)
// * scale in fp32, + the relative-position bias of the head, + the shift
// mask row of the window (window w takes row w mod nW, windows
// image-major), row max, exp, sum, P normalised in fp32 and only then
// rounded to bf16 (unlike the flash kernels, which round the unnormalised
// P), O = P V accumulated in fp32 and rounded once. JAX's window grouping
// G (_pick_g) is a TPU block-shape artefact and has no counterpart here.
//
// Layout: q, k, v are the three strided slices of the packed (BW,
// N, 3C) windows swin_pre writes (k = q + C, v = q + 2C, strides (N 3C,
// 3C, D, 1)), so a window is one contiguous range of N * 3C bf16 (69,120
// bytes at SwinIR's C = 180), which one bulk copy brings in; bias is (H, N,
// N) fp32, mask (nW, N, N) fp32 or null; O is contiguous (BW, N, H, D),
// which is the (BW, N, C) window tensor swin_post reads. The wrapper takes
// no other q/k/v layout.
//
// What bounds it on an H100: at the main-path shape (64 windows x 6 heads,
// N 64, D 30) a call moves ~6.0 MB (q, k, v, O, the bias; 7.0 with the
// mask) for 0.19 GFLOP, ~30 FLOP a byte, so the bytes bound it (1.8-2.1
// us at 3.35 TB/s). Its mma.sync predecessor, one block per (head,
// window), took 7.9 us unmasked and 18.7 masked on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md); it staged q/k/v by 4-byte loads, read
// the bias and mask from L2 inside the logit loop, and normalised P by
// fp32 divisions, which take the slow path on the denormal exp of the
// -100 mask entries. Here (5.8 and 6.5 us on that card):
//
// 1. A window is the unit: one block (or, at bs 1, two blocks of half the
//    heads each: window_split in ops/window_attention.py fills the 132 SMs
//    with 2 x 64 windows). Thread 0 starts two bulk copies on one mbarrier:
//    the window's packed rows, and its 16 KB mask, read once a window, not
//    once a head. The block then moves the mask into 288-byte rows, so that
//    the accumulator layout's float2 reads are conflict-free (64 copies of
//    256-byte rows took twice as long to land as the window alone on that
//    card: PERF.md). Each warpgroup loads its first head's bias pairs from
//    L2 under the copies, and each later head's under the head before.
// 2. One warpgroup a head, three warpgroups looping over the block's heads.
//    64 window tokens are wgmma's M. A head's 60-byte K and V slices are
//    not 16-byte aligned, so the warpgroup repacks them from the staged
//    rows into two 64 x 128-byte tiles in the 128-byte swizzle (D zero-padded
//    to 32; columns 32-63 are never read): K-major K for S = Q K^T, and the
//    same layout read MN-major (the transpose bit) as V for O = P V, as the
//    flash kernels read V.
// 3. S = Q K^T as two wgmma m64n64k16 with Q as the register A operand,
//    loaded from the staged rows. Scale, bias, mask, the row max and sum
//    across a quad, exp, and P normalised by one reciprocal a row, all in
//    fp32 registers; P rounded to bf16 is the register A of O = P V, four
//    wgmma m64n32k16.
// 4. O rounded once to bf16 into the window's (64, C) output rows in shared
//    memory, then one bulk store of the window (64 C bf16, 23,040 bytes at C
//    180), or, where two blocks share a window, each block's 4-byte words of
//    its heads' columns.
//
// No atomics: two calls give bit-identical outputs.

#include <atomic>

#include "sm90.cuh"

namespace {

using namespace edtr_sm90;

constexpr int kN = 64;               // tokens a window (window 8): wgmma's M
constexpr int kD = 32;               // head dim, zero-padded: K of S, N of O
constexpr int kRow = 128;            // bytes a K / V tile row (128-byte swizzle)
constexpr int kTile = kN * kRow;     // one K or V tile, 8 KB
constexpr int kWG = 3;               // warpgroups, one head each at a time
constexpr int kThreads = kWG * 128;
constexpr int kMaskLd = 72;          // floats a mask row in shared memory (288 bytes)
constexpr int kMaskBytes = kN * kN * 4;
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use

struct Args {
  const bf16* qkv;     // packed (BW, 64, 3C) rows: q, k, v of each token
  const float* bias;   // (H, 64, 64)
  const float* mask;   // (n_mask, 64, 64) or null
  bf16* o;             // (BW, 64, H, D), contiguous
  int heads, d, n_mask;
  int split;           // blocks a window, each ceil(H / split) heads
  float scale;
};

// dynamic shared memory: the alignment slack, the K/V tiles of each
// warpgroup, the window's (64, 3C) rows, its (64, C) output rows, the mask
// rows, the mbarrier
__host__ __device__ constexpr int smem_bytes(int c) {
  return 1024 + kWG * 2 * kTile + kN * 3 * c * 2 + kN * c * 2 + kN * kMaskLd * 4 + 16;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1) window_attention_kernel(const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sKV = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int c = p.heads * p.d, c3 = 3 * c;
  bf16* sWin = reinterpret_cast<bf16*>(sKV + kWG * 2 * kTile);
  bf16* sO = sWin + kN * c3;
  float* sMask = reinterpret_cast<float*>(sO + kN * c);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sMask + kN * kMaskLd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w4 = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int w = blockIdx.x / p.split, part = blockIdx.x % p.split;
  const int hb = (p.heads + p.split - 1) / p.split;  // heads of this block: h0 ..
  const int h0 = part * hb, h1 = min(p.heads, h0 + hb);

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const float* mrow = p.mask ? p.mask + (size_t)(w % p.n_mask) * kN * kN : nullptr;
  if (tid == 0) {  // the mask lands dense where the K/V tiles will be
    mbar_expect_tx(bar, kN * c3 * 2 + (mrow ? kMaskBytes : 0));
    bulk_load(sWin, p.qkv + (size_t)w * kN * c3, kN * c3 * 2, bar);
    if (mrow) bulk_load(sKV, mrow, kMaskBytes, bar);
  }
  const int r0 = w4 * 16 + gq;  // this thread's accumulator rows r0, r0 + 8
  // the first head's bias pairs (rows r0, r0 + 8, columns 8j + 2tq), under
  // the copies; each later head's under the head before
  float2 bb[16];
  auto load_bias = [&](int h) {
    const float* brow = p.bias + ((size_t)h * kN + r0) * kN + 2 * tq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bb[2 * j] = __ldg(reinterpret_cast<const float2*>(brow + 8 * j));
      bb[2 * j + 1] = __ldg(reinterpret_cast<const float2*>(brow + 8 * kN + 8 * j));
    }
  };
  if (h0 + wg < h1) load_bias(h0 + wg);
  mbar_wait(bar, 0);
  if (mrow) {  // into 288-byte rows: the accumulator layout's float2 reads
               // are then conflict-free; then the tiles' space is free
    for (int i = tid; i < kN * kN / 4; i += kThreads)
      *reinterpret_cast<float4*>(sMask + (i >> 4) * kMaskLd + 4 * (i & 15)) =
          reinterpret_cast<const float4*>(sKV)[i];
    __syncthreads();
  }

  uint8_t* sK = sKV + wg * 2 * kTile;
  uint8_t* sV = sK + kTile;
  const uint32_t kaddr = smem_u32(sK), vaddr = smem_u32(sV);
  const int wt = tid & 127;
  for (int h = h0 + wg; h < h1; h += kWG) {
    if (h != h0 + wg) wg_sync(wg);  // every thread past the last head's MMAs: the tiles are free

    // K and V of head h into the swizzled tiles: a thread writes column pair
    // e (d = 2e) of 8 rows; lanes 16-31 take the row 4 on, so that a warp's
    // two rows fall in different 16-byte columns of the swizzle
    {
      const int e = wt & 15, rb = (wt >> 5) + 4 * ((wt >> 4) & 1);
      const int off = (((e >> 2)) << 4) + (e & 3) * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * i + rb;
        const bf16* src = sWin + r * c3 + h * p.d + 2 * e;
        const uint32_t kv = 2 * e < p.d ? ld32(src + c) : 0u;
        const uint32_t vv = 2 * e < p.d ? ld32(src + 2 * c) : 0u;
        const int dst = r * kRow + (off ^ ((r & 7) << 4));
        *reinterpret_cast<uint32_t*>(sK + dst) = kv;
        *reinterpret_cast<uint32_t*>(sV + dst) = vv;
      }
    }
    // Q as the register A of S = Q K^T (k-step kk: columns 16kk..16kk+15)
    uint32_t qf[2][4];
    {
      const bf16* q0 = sWin + r0 * c3 + h * p.d + 2 * tq;
      const bf16* q1 = q0 + 8 * c3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int col = 16 * kk + 2 * tq;
        qf[kk][0] = col < p.d ? ld32(q0 + 16 * kk) : 0u;
        qf[kk][1] = col < p.d ? ld32(q1 + 16 * kk) : 0u;
        qf[kk][2] = col + 8 < p.d ? ld32(q0 + 16 * kk + 8) : 0u;
        qf[kk][3] = col + 8 < p.d ? ld32(q1 + 16 * kk + 8) : 0u;
      }
    }
    // the tiles, written by the threads, are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_operands(s);
    fence_operands(qf[0]);
    fence_operands(qf[1]);
    wgmma_fence();
    WgmmaRS<64, 0>::mma(s, qf[0], sw128_desc(kaddr), 0);
    WgmmaRS<64, 0>::mma(s, qf[1], sw128_desc(kaddr + 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // register 4j + 2hh + e: row r0 + 8hh, column 8j + 2tq + e
    float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = s[4 * j] * p.scale + bb[2 * j].x;
      s[4 * j + 1] = s[4 * j + 1] * p.scale + bb[2 * j].y;
      s[4 * j + 2] = s[4 * j + 2] * p.scale + bb[2 * j + 1].x;
      s[4 * j + 3] = s[4 * j + 3] * p.scale + bb[2 * j + 1].y;
      if (mrow) {
        const float2 m0 = *reinterpret_cast<const float2*>(sMask + r0 * kMaskLd + 8 * j + 2 * tq);
        const float2 m1 =
            *reinterpret_cast<const float2*>(sMask + (r0 + 8) * kMaskLd + 8 * j + 2 * tq);
        s[4 * j] += m0.x;
        s[4 * j + 1] += m0.y;
        s[4 * j + 2] += m1.x;
        s[4 * j + 3] += m1.y;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // a row's 64 columns live in the 4 threads of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = __expf(s[4 * j] - mx0);
      s[4 * j + 1] = __expf(s[4 * j + 1] - mx0);
      s[4 * j + 2] = __expf(s[4 * j + 2] - mx1);
      s[4 * j + 3] = __expf(s[4 * j + 3] - mx1);
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    if (h + kWG < h1) load_bias(h + kWG);  // bb is free
    // P normalised in fp32, then rounded: registers 8kk..8kk+7 are the A of
    // the k-step over keys 16kk..16kk+15
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = edtr::pack_bf16(s[8 * kk] * inv0, s[8 * kk + 1] * inv0);
      pf[kk][1] = edtr::pack_bf16(s[8 * kk + 2] * inv1, s[8 * kk + 3] * inv1);
      pf[kk][2] = edtr::pack_bf16(s[8 * kk + 4] * inv0, s[8 * kk + 5] * inv0);
      pf[kk][3] = edtr::pack_bf16(s[8 * kk + 6] * inv1, s[8 * kk + 7] * inv1);
    }

    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    fence_operands(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(pf[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<32, 1>::mma(o, pf[kk], sw128_mn_desc(vaddr + kk * 16 * kRow), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);

    // O rounded once into the window's output rows (register 4j + 2hh + e:
    // row r0 + 8hh, column 8j + 2tq + e); D is even, so a pair is whole
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < p.d) {
        *reinterpret_cast<uint32_t*>(sO + r0 * c + h * p.d + col) =
            edtr::pack_bf16(o[4 * j], o[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(sO + (r0 + 8) * c + h * p.d + col) =
            edtr::pack_bf16(o[4 * j + 2], o[4 * j + 3]);
      }
    }
  }

  // the output rows, written by the threads, are read by the bulk store
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  bf16* out = p.o + (size_t)w * kN * c;
  if (p.split == 1) {
    if (tid == 0) {
      bulk_store(out, sO, kN * c * 2);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else if (h0 < h1) {  // this block's heads: (h1 - h0) D / 2 words a row
    const int words = (h1 - h0) * p.d / 2;
    for (int i = tid; i < kN * words; i += kThreads) {
      const int r = i / words, off = r * c + h0 * p.d + 2 * (i % words);
      *reinterpret_cast<uint32_t*>(out + off) = *reinterpret_cast<const uint32_t*>(sO + off);
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). qkv: the packed (bw, 64, 3 heads
// d) bf16 rows, 16-byte aligned, whose q/k/v slices are (bw, 64, heads, d)
// (d even and <= 32, heads * d within the shared memory: the Python
// wrapper checks). bias (heads, 64, 64) fp32; mask (n_mask, 64, 64) fp32,
// 16-byte aligned, or null (n_mask > 0 then); o (bw, 64, heads, d) bf16,
// contiguous and 16-byte aligned; split 1 or 2 blocks a window. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int edtr_window_attention(const void* qkv, const void* bias, const void* mask,
                                     void* o, int bw, int heads, int d, int n_mask,
                                     float scale, int split, void* stream) {
  if (d <= 0 || d > kD || d % 2 || bw <= 0 || heads <= 0 || (mask && n_mask <= 0) ||
      split < 1 || split > 2 || smem_bytes(heads * d) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> raised{0u};
  const cudaError_t err = edtr::raise_smem_once(window_attention_kernel, kSmemLimit, raised);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.o = static_cast<bf16*>(o);
  a.heads = heads;
  a.d = d;
  a.n_mask = n_mask;
  a.split = split;
  a.scale = scale;
  window_attention_kernel<<<bw * split, kThreads, smem_bytes(heads * d),
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
