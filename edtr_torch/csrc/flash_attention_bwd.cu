// Flash-attention backward for Hopper (sm_90a), head dim 64: dQ, dK, dV from
// Q, K, V, dO, the forward's per-row logsumexp (lse) and D = rowsum(dO * O),
// bf16 in and out, fp32 lse/D/logits/accumulators.
//
// Replaces three Pallas TPU kernels of edtr_tpu/ops/flash_attention.py:
//
//   flash_dq_wgmma_kernel   <- _dq_kernel (_flash_bwd_flat, N > 1024) and
//                              the dq half of _whole_bwd_kernel
//                              (_whole_bwd_flat, N <= 1024);
//   flash_dkv_wgmma_kernel  <- _dkv_kernel (_flash_bwd_flat) and the dk/dv
//                              half of _whole_bwd_kernel.
//
// Both are wgmma kernels fed by TMA (flash_bwd_wgmma.cuh has the design and
// what bounds them). This file builds each in one tile plan, (streamed tile
// rows BN, ring stages, blocks resident on an SM): dq <64, 3, 3>, dk/dv
// <64, 4, 1>.

#include "flash_bwd_wgmma.cuh"

// Plain C interface (loaded with ctypes). q/k/v/do/dq/dk/dv are contiguous
// (bh, n, 64) bf16, lse and dd (bh, n) fp32, all 16-byte aligned; n a
// multiple of 64 (the Python wrappers check it). Launch on `stream`; return
// cudaGetLastError(), cudaErrorInvalidValue for a shape the kernels do not
// take, or -(CUresult) if a tensor map is refused.
extern "C" int edtr_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dd,
                                       void* dq, int bh, int n, float scale, void* stream) {
  return edtr_flash_bwd::launch_dq<64, 3, 3>(q, k, v, dout, lse, dd, dq, bh, n, scale,
                                             static_cast<cudaStream_t>(stream));
}

extern "C" int edtr_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* dd,
                                        void* dk, void* dv, int bh, int n, float scale,
                                        void* stream) {
  return edtr_flash_bwd::launch_dkv<64, 4, 1>(q, k, v, dout, lse, dd, dk, dv, bh, n, scale,
                                              static_cast<cudaStream_t>(stream));
}
