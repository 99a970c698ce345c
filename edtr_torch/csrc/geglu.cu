// GEGLU projection for Hopper (sm_90a): the proj_gemm_kernel of
// proj_gemm.cuh (see its header for the design) with the GEGLU epilogue.
//
// Replaces the Pallas TPU kernels of edtr_tpu/ops/geglu.py:
//
//   proj_gemm_kernel<.., PRO_NONE, EPI_GEGLU>  <- _kernel (geglu_proj)
//   proj_gemm_kernel<.., PRO_LN, EPI_GEGLU>    <- _ln_kernel (ln_geglu_proj)
//
//       out = (x@wh + bh) * gelu_erf(x@wg + bg), x optionally LN(x)
//
// wh/wg are rows [0, inner) and [inner, 2*inner) of the FeedForward's packed
// (2*inner, C) ff.net.0.proj weight. Each block keeps both sums of its
// output tile in registers and writes only the (M, inner) product: the
// 2*inner intermediate never reaches device memory, as in the TPU kernel.

#include "proj_gemm.cuh"

using namespace edtr_proj;

// Plain C interface (loaded with ctypes). ln 0: geglu_proj, 1:
// ln_geglu_proj (ln_s/ln_b (C) fp32, eps). x (M, C) bf16; w (2*inner, C)
// bf16; bias (2*inner) fp32; out (M, inner) bf16. bm, bn in {64, 128} (bn
// slab rows: bn / 2 output columns per block); M % bm == 0, 2*inner % bn ==
// 0, inner % (bn / 2) == 0, C % 32 == 0, pointers 16-byte aligned (the
// Python wrapper checks). Launches on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a tile or shape the kernel does not take.
extern "C" int edtr_geglu(int ln, int bm, int bn, const void* x, const void* ln_s,
                          const void* ln_b, const void* w, const void* bias, void* out, int M,
                          int C, int inner, float eps, void* stream) {
  if (inner % (bn / 2)) return (int)cudaErrorInvalidValue;
  ProjArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.bias = static_cast<const float*>(bias);
  a.out0 = static_cast<bf16*>(out);
  a.M = M;
  a.C = C;
  a.O = inner;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln) return launch_tile<PRO_LN, EPI_GEGLU>(bm, bn, a, 2 * inner, st);
  return launch_tile<PRO_NONE, EPI_GEGLU>(bm, bn, a, 2 * inner, st);
}
