// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * s) V and
// the per-row logsumexp, bf16 in and out, fp32 logits/softmax/accumulators.
//
// Replaces four Pallas TPU kernels of edtr_tpu/ops/flash_attention.py:
//
//   flash_wgmma_kernel (flash_wgmma.cuh)
//                     <- _qblock_wholekv_kernel (_qblock_wholekv_fwd_flat),
//                        _whole_fwd_kernel (_whole_fwd_flat) and
//                        _fwd_kernel (_flash_fwd_flat): head dim 64.
//   streamkv_kernel (flash_streamkv.cuh)
//                     <- _fwd_kernel_streamkv (_streamkv_fwd_flat): head
//                        dims 256, 384 and 512 (the VAE mid-block
//                        attention: 512).
//
// The TPU kernels keep a whole (256 x N) or (N x N) fp32 logit slab in
// megabytes of VMEM. A Hopper block has at most 227 KB of shared memory, so
// both kernels here stream K/V in tiles through shared memory, fed by TMA,
// with an online softmax (running max m, running sum l, rescale alpha =
// exp(m_old - m_new)) and wgmma for both products. The function is the TPU
// kernels': scale applied to the fp32 logits, P cast to bf16 before the PV
// product, l summed from the fp32 P, O = acc / l in bf16 and lse = m +
// log(l) in fp32. What bounds them on an H100: at the main-path shapes both
// do 4*N^2*D flops per head on N*D*8 bytes, far above the card's ~295
// flop/byte ridge, so the tensor cores bound them (the headers have the
// designs).

#include "common.cuh"
#include "flash_streamkv.cuh"
#include "flash_wgmma.cuh"

// Plain C interface (loaded with ctypes). q/k/v/o are contiguous (bh, n, d)
// bf16, lse is (bh, n) fp32, all 16-byte aligned; the Python wrappers check
// shapes and dtypes. Each entry launches on `stream` and returns
// cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take,
// or the error of the one-time raise of the kernel's shared-memory limit
// (or, negated, of encoding a tensor map).

// The streamed-KV kernel of flash_streamkv.cuh at head dim d (256, 384 or
// 512), its KV range split in `splits` (1 or 2; ops/flash_attention.py:
// streamkv_splits); n a multiple of 64 * splits, scale > 0. splits 2 takes
// fp32 scratch `part` (2, bh, n, d) and `ml` (2, bh, n, 2) and bh * n / 64
// zeroed int32 arrival counters, which it leaves zeroed.
extern "C" int edtr_flash_fwd_streamkv(const void* q, const void* k, const void* v, void* o,
                                       void* lse, void* part, void* ml, void* counters, int bh,
                                       int n, int d, int splits, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 256:
      return edtr_streamkv::launch<256>(q, k, v, o, lse, part, ml, counters, bh, n, splits,
                                        scale, st);
    case 384:
      return edtr_streamkv::launch<384>(q, k, v, o, lse, part, ml, counters, bh, n, splits,
                                        scale, st);
    case 512:
      return edtr_streamkv::launch<512>(q, k, v, o, lse, part, ml, counters, bh, n, splits,
                                        scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wgmma kernel of flash_wgmma.cuh at head dim 64, in tile plan `plan`
// (ops/flash_attention.py:FLASH_PLANS, (BN, STAGES, MINB)); n a multiple of
// 64 and of the plan's BN, scale > 0.
extern "C" int edtr_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int bh, int n, float scale, int plan,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plan) {
    case 0: return edtr_flash::launch<64, 3, 3>(q, k, v, o, lse, bh, n, scale, st);
    case 1: return edtr_flash::launch<128, 2, 2>(q, k, v, o, lse, bh, n, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
