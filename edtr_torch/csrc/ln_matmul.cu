// LayerNorm + bias-free projections and folded-GroupNorm + projection for
// Hopper (sm_90a), both on the wgmma kernel of proj_wgmma.cuh (tokens by
// TMA, the prologue once per block, weights through a TMA ring).
//
// Replaces the Pallas TPU kernels of edtr_tpu/ops/ln_matmul.py:
//
//   lnproj_kernel<.., PRO_LN, EPI_STORE>  <- _kernel (ln_matmuls,
//       pallas_call :120): (LN(x) @ w_k for k < K), K = 3 (self-attention
//       q/k/v from one concatenated (3*O, C) weight, three (M, O) outputs)
//       or K = 1 (the cross-attention query); each output rounded to bf16
//       once
//   lnproj_kernel<.., PRO_AFF, EPI_BIAS>  <- _aff_kernel (affine_matmul,
//       :201): ((x * mul + add) @ w) + b, the SpatialTransformer's GroupNorm
//       folded to a per-(batch, C) affine in front of proj_in; bias added
//       in bf16

#include "proj_wgmma.cuh"

using namespace edtr_lnproj;

// Plain C interface (loaded with ctypes). x (M, C) bf16; w (K*O, C) bf16;
// ln_s/ln_b (C) fp32; out0..out{K-1} (M, O) bf16 (unused ones null). bm in
// {32, 64} token rows a block, bn in {64, 160} weight rows a tile, groups
// column groups (1 to K*O / bn); M % bm == 0, K*O % bn == 0, C % 32 == 0,
// O % 64 == 0, all pointers 16-byte aligned (the Python wrapper checks). Launches
// on `stream`;
// returns cudaGetLastError(), cudaErrorInvalidValue for a tile or shape the
// kernel does not take, or -(CUresult) if cuTensorMapEncodeTiled refuses w's map.
extern "C" int edtr_ln_matmul(int bm, int bn, int groups, const void* x, const void* ln_s,
                              const void* ln_b, const void* w, void* out0, void* out1,
                              void* out2, int k, int M, int C, int O, float eps, void* stream) {
  if (k < 1 || k > 3 || O % 2) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.out0 = static_cast<bf16*>(out0);
  a.out1 = static_cast<bf16*>(out1);
  a.out2 = static_cast<bf16*>(out2);
  a.M = M;
  a.C = C;
  a.O = O;
  a.groups = groups;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 32 && bn == 64) return launch<32, 64, PRO_LN, EPI_STORE>(x, w, k * O, a, st);
  if (bm == 32 && bn == 160) return launch<32, 160, PRO_LN, EPI_STORE>(x, w, k * O, a, st);
  if (bm == 64 && bn == 64) return launch<64, 64, PRO_LN, EPI_STORE>(x, w, k * O, a, st);
  if (bm == 64 && bn == 160) return launch<64, 160, PRO_LN, EPI_STORE>(x, w, k * O, a, st);
  return (int)cudaErrorInvalidValue;
}

// x (M, C) bf16, n_tok tokens per batch element; mul/add (M / n_tok, C)
// fp32; w (O, C) bf16; bias (O) fp32; out (M, O) bf16. bm in {32, 64}
// token rows a block, bn in {64, 128, 160} weight rows a tile, groups
// column groups (1 to O / bn); n_tok % bm == 0, M % n_tok == 0, O % bn ==
// 0, O % 64 == 0, C % 32 == 0, pointers 16-byte aligned. Returns as
// edtr_ln_matmul.
extern "C" int edtr_affine_matmul(int bm, int bn, int groups, const void* x, const void* mul,
                                  const void* add, const void* w, const void* bias, void* out,
                                  int M, int C, int O, int n_tok, void* stream) {
  Args a = {};
  a.mul = static_cast<const float*>(mul);
  a.add = static_cast<const float*>(add);
  a.bias = static_cast<const float*>(bias);
  a.out0 = static_cast<bf16*>(out);
  a.M = M;
  a.C = C;
  a.O = O;
  a.groups = groups;
  a.n_tok = n_tok;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 32 && bn == 64) return launch<32, 64, PRO_AFF, EPI_BIAS>(x, w, O, a, st);
  if (bm == 32 && bn == 128) return launch<32, 128, PRO_AFF, EPI_BIAS>(x, w, O, a, st);
  if (bm == 32 && bn == 160) return launch<32, 160, PRO_AFF, EPI_BIAS>(x, w, O, a, st);
  if (bm == 64 && bn == 64) return launch<64, 64, PRO_AFF, EPI_BIAS>(x, w, O, a, st);
  if (bm == 64 && bn == 128) return launch<64, 128, PRO_AFF, EPI_BIAS>(x, w, O, a, st);
  if (bm == 64 && bn == 160) return launch<64, 160, PRO_AFF, EPI_BIAS>(x, w, O, a, st);
  return (int)cudaErrorInvalidValue;
}
