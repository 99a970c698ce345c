// Fused conv3x3 kernels for Hopper (sm_90a): bf16 in and out, fp32
// accumulation, zero padding 1, stride 1, NHWC (channels-last) activations.
//
// Replaces the Pallas TPU kernels of edtr_tpu/ops/gn_conv.py:
//
//   conv3x3_kernel       <- _kernel_{plain,emb,res,emb_res} (_call, the
//                           whole-image tier) and _band_{plain,emb,res,
//                           emb_res} (_band_call, the row-band tier):
//                           out = conv3x3(silu(x*mul + add)) + b
//                                 [+ emb] [+ res]
//   upconv_wgmma_kernel  <- _ups_kernel (upsample_conv):
//   (conv_wgmma.cuh)        out = act(conv3x3(nearest2x(x)) + b),
//                           act none or LeakyReLU(0.2), as a phase-folded
//                           wgmma implicit GEMM fed by TMA (see its header)
//
// conv3x3_kernel:
//
// The TPU kernels keep a whole image, or a row band plus its halo rows, of
// the activated input in VMEM and run the conv as 9 shifted (rows x Cin) @
// (Cin x Cout) MXU products. Here the conv is an implicit GEMM: M = B*H*W
// output pixels, N = Cout, K = 9*Cin. A block owns a BM x BN output tile
// whose BM pixels are a TH x TW rectangle of one image (TW 8 or 16, BM 64
// or 128), and walks K as 32-channel chunks, each followed through the 9
// taps. For each chunk it stages the (TH+2) x (TW+2) halo of the ACTIVATED
// input in shared memory once (1.4-1.7x the tile's pixels instead of 9x),
// and every tap reads its shifted window of that halo: each lane gives
// ldmatrix the address of its own (shifted) pixel row. 8 warps issue
// mma.sync m16n8k16 (bf16 -> fp32).
//
// Staging a halo: each thread loads 8 channels of a few halo pixels into
// registers at the chunk's first tap and, after the chunk's last tap has
// been issued, applies a = x*mul + add in fp32 (no fma contraction, as the
// plain version's separate multiply and add), rounds to bf16, applies silu
// in fp32 on the rounded value and rounds to bf16, then stores it into the
// other halo buffer. A halo pixel outside the image
// stores zeros AFTER the activation: the conv pads silu(GN(x)) with zeros,
// not x (gn_conv.py:381-386). The weights are a packed bf16 copy
// (9, Cout, Cin) made once per module; a (tap, chunk) slab of BN rows
// streams through a 3-deep cp.async ring, so the loads run two steps ahead
// of the tensor cores.
//
// The epilogue rounds the fp32 sum to bf16, then adds the bias (fp32 rounded
// to bf16), emb and res in bf16, each sum rounded (gn_conv.py:_epilogue).
//
// What bounds it on an H100: the row-band shapes (M >= 256)
// do 2*9*Cin FLOP per output element on bf16 data, hundreds of FLOP per
// byte, so the tensor cores bound them; this version issues mma.sync
// without wgmma/TMA and cannot reach the dense peak. The whole-image tier
// (8x8 latents, M = 64 at batch 1) reads up to 59 MB of weights for 4 GFLOP
// and is bound by those bytes; one 64-pixel tile per Cout block would keep
// only 10-20 SMs streaming them, so small grids split the channel chunks
// across blocks (gridDim.z): each block writes an fp32 partial, and the last
// block of a tile to arrive (an atomic counter per tile, reset by that
// block) sums the partials in split order, so the result does not depend on
// arrival order, and runs the epilogue.

#include <atomic>

#include "common.cuh"
#include "conv_wgmma.cuh"

namespace {

using namespace edtr;

constexpr int BK = 32;          // input channels per chunk
constexpr int LDS = BK + 8;     // padded smem row (elements): 80 B, ldmatrix conflict-free
constexpr int kThreads = 256;   // 8 warps
constexpr int kStagesB = 3;     // weight slabs in flight

struct Conv3x3Args {
  const bf16* x;        // NHWC (batch, h, wd, cin)
  const float* mul;     // (batch, cin) folded GroupNorm
  const float* add;
  const bf16* wt;       // (9, cout, cin): tap-major, cin contiguous
  const float* bias;    // (cout)
  const bf16* emb;      // (batch, cout) or nullptr
  const bf16* res;      // NHWC (batch, h, wd, cout) or nullptr
  bf16* out;            // NHWC (batch, h, wd, cout)
  float* partial;       // (splits, M, cout) fp32 when gridDim.z > 1
  int* counters;        // one zeroed arrival counter per output tile
  int batch, h, wd, cin, cout;  // output geometry
  int tw;               // tile width in pixels (8 or 16); tile height BM / tw
  int chunks_per_split;
};

// most halo pixels a BM-pixel tile needs: (BM/TW + 2) x (TW + 2)
template <int BM>
__host__ __device__ constexpr int halo_max() { return BM == 128 ? 180 : 108; }

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return (size_t)(2 * halo_max<BM>() + kStagesB * BN) * LDS * sizeof(bf16);
}

// silu on a bf16-rounded value, in fp32, rounded: the plain version's F.silu
__device__ __forceinline__ float silu_r(float s) {
  return bf16r(__fdiv_rn(s, __fadd_rn(1.f, expf(-s))));
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(const Conv3x3Args p) {
  constexpr int WARPS_M = BM / 32;
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WN = BN / WARPS_N;                    // output columns per warp
  constexpr int NT = WN / 8;                          // n8 tiles per warp
  constexpr int HMAX = halo_max<BM>();
  constexpr int A_CH = (HMAX * (BK / 8) + kThreads - 1) / kThreads;  // halo chunks per thread
  constexpr int B_CH = BN * (BK / 8) / kThreads;      // 16-byte weight chunks per thread
  static_assert(NT % 2 == 0 && B_CH >= 1, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [2][HMAX][LDS] activated halo
  bf16* sB = sA + 2 * HMAX * LDS;                // [kStagesB][BN][LDS] weight slabs
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int tw = p.tw, th = BM / tw, hrow = tw + 2, hp = (th + 2) * hrow;
  const int tiles_x = (p.wd + tw - 1) / tw, tiles_y = (p.h + th - 1) / th;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * th, x0 = tx * tw;
  const int M = p.batch * p.h * p.wd;
  const int n0 = blockIdx.y * BN;
  const int chunks = p.cin / BK;
  const int c_begin = blockIdx.z * p.chunks_per_split;
  const int c_end = min(chunks, c_begin + p.chunks_per_split);
  const int s_begin = 9 * c_begin, s_end = 9 * c_end;

  uint4 a_reg[A_CH];
  bool a_ok[A_CH];
  int a_c0 = 0;

  // registers <- 8 channels of this thread's halo pixels, chunk cc
  auto load_halo = [&](int cc) {
    a_c0 = cc * BK;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * kThreads, q = c >> 2, col = (c & 3) * 8;
      const int yy = y0 - 1 + q / hrow, xx = x0 - 1 + q % hrow;
      a_ok[i] = q < hp && yy >= 0 && yy < p.h && xx >= 0 && xx < p.wd;
      a_reg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (a_ok[i])
        a_reg[i] = __ldg(reinterpret_cast<const uint4*>(
            p.x + (((size_t)img * p.h + yy) * p.wd + xx) * p.cin + a_c0 + col));
    }
  };

  // halo buffer buf <- the activated registers (zeros outside the image)
  auto store_halo = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * kThreads, q = c >> 2, col = (c & 3) * 8;
      if (q >= hp) continue;
      uint4 v = a_reg[i];
      if (a_ok[i]) {
        const size_t cb = (size_t)img * p.cin + a_c0 + col;
        const float4 m_lo = __ldg(reinterpret_cast<const float4*>(p.mul + cb));
        const float4 m_hi = __ldg(reinterpret_cast<const float4*>(p.mul + cb + 4));
        const float4 d_lo = __ldg(reinterpret_cast<const float4*>(p.add + cb));
        const float4 d_hi = __ldg(reinterpret_cast<const float4*>(p.add + cb + 4));
        const float mm[8] = {m_lo.x, m_lo.y, m_lo.z, m_lo.w, m_hi.x, m_hi.y, m_hi.z, m_hi.w};
        const float dd[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w, d_hi.x, d_hi.y, d_hi.z, d_hi.w};
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&u[j]);
          const float lo = silu_r(bf16r(__fadd_rn(__fmul_rn(__low2float(pr), mm[2 * j]), dd[2 * j])));
          const float hi = silu_r(bf16r(__fadd_rn(__fmul_rn(__high2float(pr), mm[2 * j + 1]),
                                                  dd[2 * j + 1])));
          u[j] = pack_bf16(lo, hi);
        }
      }
      *reinterpret_cast<uint4*>(sA + (buf * HMAX + q) * LDS + col) = v;
    }
  };

  // weight ring slot of step s <- the (tap, chunk) slab; commits a group
  // every call (empty past the end) so the wait counts stay uniform
  auto load_b = [&](int s) {
    if (s < s_end) {
      const int cc = s / 9, tap = s - cc * 9;
      bf16* dst = sB + ((s - s_begin) % kStagesB) * BN * LDS;
#pragma unroll
      for (int i = 0; i < B_CH; ++i) {
        const int c = tid + i * kThreads;
        const int row = c >> 2, col = (c & 3) * 8;
        cp_async16(dst + row * LDS + col,
                   p.wt + ((size_t)tap * p.cout + n0 + row) * p.cin + cc * BK + col);
      }
    }
    cp_async_commit();
  };

  // this lane's A row (tile pixel) for each m16 tile, as a halo index
  int a_pix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wm * 32 + mt * 16 + (lane & 15);
    a_pix[mt] = (r / tw) * hrow + r % tw;
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  if (s_begin < s_end) {
    load_halo(c_begin);
    store_halo(0);
    load_b(s_begin);
    load_b(s_begin + 1);
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int cc = s / 9, tap = s - cc * 9, buf = (cc - c_begin) & 1;
    cp_async_wait<1>();
    __syncthreads();  // slab s and halo cc visible; slot of s+2 and halo buf^1 free
    load_b(s + 2);
    const bool next_chunk = cc + 1 < c_end;
    if (tap == 0 && next_chunk) load_halo(cc + 1);
    const bf16* A = sA + buf * HMAX * LDS + ((tap / 3) * hrow + tap % 3) * LDS;
    const bf16* Bt = sB + ((s - s_begin) % kStagesB) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], A + a_pix[mt] * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Bt + (wn * WN + np * 16 + (mi >> 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                           (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
    if (tap == 8 && next_chunk) store_halo(buf ^ 1);
  }

  // the output pixel of accumulator row r of the tile, or -1 outside the image
  auto pixel = [&](int r) {
    const int y = y0 + r / tw, x = x0 + r % tw;
    return (y < p.h && x < p.wd) ? (img * p.h + y) * p.wd + x : -1;
  };

  // split K: publish this block's partial; the last block of the tile sums
  if (gridDim.z > 1) {
    float* part = p.partial + (size_t)blockIdx.z * M * p.cout;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = pixel(wm * 32 + mt * 16 + g + half * 8);
        if (m < 0) continue;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n = n0 + wn * WN + t * 8 + tig * 2;
          *reinterpret_cast<float2*>(part + (size_t)m * p.cout + n) =
              make_float2(acc[mt][t][2 * half], acc[mt][t][2 * half + 1]);
        }
      }
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) s_last = atomicAdd(p.counters + tile, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = pixel(wm * 32 + mt * 16 + g + half * 8);
        if (m < 0) continue;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n = n0 + wn * WN + t * 8 + tig * 2;
          float2 sum = make_float2(0.f, 0.f);
          for (int z = 0; z < (int)gridDim.z; ++z) {
            const float2 v = __ldcg(
                reinterpret_cast<const float2*>(p.partial + ((size_t)z * M + m) * p.cout + n));
            sum.x += v.x;
            sum.y += v.y;
          }
          acc[mt][t][2 * half] = sum.x;
          acc[mt][t][2 * half + 1] = sum.y;
        }
      }
    if (tid == 0) p.counters[tile] = 0;  // ready for the next launch
  }

  // epilogue: round, + bias, + emb, + res (each in bf16)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = pixel(wm * 32 + mt * 16 + g + half * 8);
      if (m < 0) continue;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = n0 + wn * WN + t * 8 + tig * 2;
        float o0 = bf16r(acc[mt][t][2 * half]), o1 = bf16r(acc[mt][t][2 * half + 1]);
        o0 = bf16r(o0 + bf16r(p.bias[n]));
        o1 = bf16r(o1 + bf16r(p.bias[n + 1]));
        if (p.emb != nullptr) {
          const __nv_bfloat162 e =
              *reinterpret_cast<const __nv_bfloat162*>(p.emb + (size_t)img * p.cout + n);
          o0 = bf16r(o0 + __low2float(e));
          o1 = bf16r(o1 + __high2float(e));
        }
        if (p.res != nullptr) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(p.res + (size_t)m * p.cout + n);
          o0 = bf16r(o0 + __low2float(r));
          o1 = bf16r(o1 + __high2float(r));
        }
        *reinterpret_cast<uint32_t*>(p.out + (size_t)m * p.cout + n) = pack_bf16(o0, o1);
      }
    }
}

template <int BM, int BN>
int launch(const Conv3x3Args& a, int splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN>();
  static std::atomic<unsigned> raised{0u};
  const cudaError_t err = raise_smem_once(conv3x3_kernel<BM, BN>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const int th = BM / a.tw;
  const int tiles = a.batch * ((a.h + th - 1) / th) * ((a.wd + a.tw - 1) / a.tw);
  dim3 grid(tiles, a.cout / BN, splits);
  conv3x3_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). The GN+SiLU prologue conv: mul,
// add (batch, cin) fp32; emb, res may be null. bm in {64, 128}, bn in {64,
// 128}, tw in {8, 16}; cin % 32 == 0, cout % bn == 0, all tensors
// contiguous and 16-byte aligned (the Python wrappers check). splits > 1
// needs `partial` ((splits, M, cout) fp32) and `counters` (zeroed, one per
// output tile: batch x ceil(h/th) x ceil(w/tw) x cout/bn), used by no other
// launch at the same time. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown tile.
extern "C" int edtr_conv3x3(int bm, int bn, int tw, const void* x, const void* mul,
                            const void* add, const void* w, const void* bias, const void* emb,
                            const void* res, void* out, void* partial, void* counters, int batch,
                            int h, int w_out, int cin, int cout, int splits,
                            int chunks_per_split, void* stream) {
  if (tw != 8 && tw != 16) return (int)cudaErrorInvalidValue;
  Conv3x3Args a;
  a.x = static_cast<const bf16*>(x);
  a.mul = static_cast<const float*>(mul);
  a.add = static_cast<const float*>(add);
  a.wt = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.emb = static_cast<const bf16*>(emb);
  a.res = static_cast<const bf16*>(res);
  a.out = static_cast<bf16*>(out);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.batch = batch;
  a.h = h;
  a.wd = w_out;
  a.cin = cin;
  a.cout = cout;
  a.tw = tw;
  a.chunks_per_split = chunks_per_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 64) return launch<64, 64>(a, splits, st);
  if (bm == 64 && bn == 128) return launch<64, 128>(a, splits, st);
  if (bm == 128 && bn == 64) return launch<128, 64>(a, splits, st);
  if (bm == 128 && bn == 128) return launch<128, 128>(a, splits, st);
  return (int)cudaErrorInvalidValue;
}

// The nearest-2x conv (conv_wgmma.cuh). x (batch, h, w, cin) NHWC bf16, the
// LOW-res input; w the folded weights (4 phases, 2, 2, cout, cin) bf16;
// bias (cout) fp32; out (batch, 2h, 2w, cout) NHWC bf16. tw 16 (8 x 16
// low-res tiles) or 8 (16 x 8); cin % 32 == 0, cout % 64 == 0, pointers
// 16-byte aligned. splits > 1 needs `partial` ((splits, batch*2h*2w, cout)
// fp32) and `counters` as above (batch x ceil(h/th) x ceil(w/tw) x cout/64
// tiles), each split chunks_per_split 64-channel chunks. lrelu 0 or 1.
// Returns cudaGetLastError(), cudaErrorInvalidValue for a shape the kernel
// does not take, or -(CUresult) if cuTensorMapEncodeTiled refuses a map.
extern "C" int edtr_upsample_conv(int tw, const void* x, const void* w, const void* bias,
                                  void* out, void* partial, void* counters, int batch, int h,
                                  int w_in, int cin, int cout, int splits,
                                  int chunks_per_split, int lrelu, void* stream) {
  edtr_upconv::UpArgs a = {};
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.batch = batch;
  a.h = h;
  a.w = w_in;
  a.cin = cin;
  a.cout = cout;
  a.tw = tw;
  a.chunks_per_split = chunks_per_split;
  a.lrelu = lrelu;
  return edtr_upconv::launch(x, w, a, splits, static_cast<cudaStream_t>(stream));
}
