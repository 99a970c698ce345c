// GEGLU projection for Hopper (sm_90a), both forms on the wgmma kernel of
// proj_wgmma.cuh (tokens by TMA, weights through a TMA ring):
//
//   lnproj_kernel<.., PRO_NONE, EPI_GEGLU>  <- edtr_tpu/ops/geglu.py:_kernel
//       (geglu_proj, pallas_call :159)
//   lnproj_kernel<.., PRO_LN, EPI_GEGLU>    <- _ln_kernel (ln_geglu_proj,
//       :218): the LayerNorm once per block
//
//       out = (x@wh + bh) * gelu_erf(x@wg + bg), x optionally LN(x)
//
// wh/wg are rows [0, inner) and [inner, 2*inner) of the FeedForward's packed
// (2*inner, C) ff.net.0.proj weight. Each block keeps both sums of its
// output tile in registers and writes only the (M, inner) product: the
// 2*inner intermediate never reaches device memory, as in the TPU kernel.
// K7a's tokens need no prologue, so its blocks take 128 token rows where
// they fit (ops/_proj.py:lnproj_plan).

#include "proj_wgmma.cuh"

using namespace edtr_lnproj;

// Plain C interface (loaded with ctypes). ln 0: geglu_proj, 1:
// ln_geglu_proj (ln_s/ln_b (C) fp32, eps). x (M, C) bf16; w (2*inner, C)
// bf16; bias (2*inner) fp32; out (M, inner) bf16. bm token rows a block
// (ln 0: 64 or 128; ln 1: 32 or 64), bn in {64, 128} weight rows a tile
// (bn / 2 output columns), groups column groups (1 to 2*inner / bn). M %
// bm == 0, inner % (bn / 2) == 0, C % 32 == 0, pointers 16-byte aligned
// (the Python wrapper checks). Launches on `stream`; returns
// cudaGetLastError(), cudaErrorInvalidValue for a tile or shape the kernel
// does not take, or -(CUresult) if cuTensorMapEncodeTiled refuses a map.
extern "C" int edtr_geglu(int ln, int bm, int bn, int groups, const void* x, const void* ln_s,
                          const void* ln_b, const void* w, const void* bias, void* out, int M,
                          int C, int inner, float eps, void* stream) {
  Args a = {};
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.bias = static_cast<const float*>(bias);
  a.out0 = static_cast<bf16*>(out);
  a.M = M;
  a.C = C;
  a.O = inner;
  a.groups = groups;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slab = 2 * inner;
  if (ln) {
    if (bm == 32 && bn == 64) return launch<32, 64, PRO_LN, EPI_GEGLU>(x, w, slab, a, st);
    if (bm == 32 && bn == 128) return launch<32, 128, PRO_LN, EPI_GEGLU>(x, w, slab, a, st);
    if (bm == 64 && bn == 64) return launch<64, 64, PRO_LN, EPI_GEGLU>(x, w, slab, a, st);
    if (bm == 64 && bn == 128) return launch<64, 128, PRO_LN, EPI_GEGLU>(x, w, slab, a, st);
    return (int)cudaErrorInvalidValue;
  }
  if (bm == 64 && bn == 64) return launch<64, 64, PRO_NONE, EPI_GEGLU>(x, w, slab, a, st);
  if (bm == 64 && bn == 128) return launch<64, 128, PRO_NONE, EPI_GEGLU>(x, w, slab, a, st);
  if (bm == 128 && bn == 64) return launch<128, 64, PRO_NONE, EPI_GEGLU>(x, w, slab, a, st);
  if (bm == 128 && bn == 128) return launch<128, 128, PRO_NONE, EPI_GEGLU>(x, w, slab, a, st);
  return (int)cudaErrorInvalidValue;
}
