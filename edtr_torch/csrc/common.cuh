// Device helpers shared by the port's Hopper kernels: shared-memory
// addresses and bf16 rounding and packing; and the host's one-time raise
// of a kernel's shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace edtr {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v rounded to bf16 and back
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (one bit of `raised` each), not on every launch; with `max_carveout`, also
// asks for the largest shared-memory share of the SM, so that several
// blocks fit beside each other.
template <typename Kernel>
cudaError_t raise_smem_once(Kernel kernel, size_t bytes, std::atomic<unsigned>& raised,
                            bool max_carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!((raised.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && max_carveout)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    raised.fetch_or(1u << dev);
  }
  return cudaSuccess;
}

}  // namespace edtr
