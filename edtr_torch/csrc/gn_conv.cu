// Fused conv3x3 kernels for Hopper (sm_90a): bf16 in and out, fp32
// accumulation, zero padding 1, stride 1, NHWC (channels-last) activations.
// This file holds the plain C entries (loaded with ctypes); the kernels are
// in the headers it includes:
//
//   gnconv_wgmma_kernel  <- _kernel_{plain,emb,res,emb_res} (_call, the
//   (gnconv_wgmma.cuh)      whole-image tier, K5a) and _band_{plain,emb,
//                           res,emb_res} (_band_call, the row-band tier,
//                           K5b) of edtr_tpu/ops/gn_conv.py:
//                           out = conv3x3(silu(x*mul + add)) + b
//                                 [+ emb] [+ res]
//                           as a wgmma implicit GEMM fed by TMA that
//                           activates each halo pixel once a channel chunk
//   upconv_wgmma_kernel  <- _ups_kernel (upsample_conv, K6):
//   (conv_wgmma.cuh)        out = act(conv3x3(nearest2x(x)) + b),
//                           act none or LeakyReLU(0.2), as a phase-folded
//                           wgmma implicit GEMM fed by TMA
//
// Each header's comment gives its design and what bounds it on an H100.
// Time one of them at the main path's shapes with `python3 proj_bench.py
// --conv` (device time from a trace, against the plain version and
// F.conv2d).

#include "conv_wgmma.cuh"
#include "gnconv_wgmma.cuh"

// The GN+SiLU prologue conv (gnconv_wgmma.cuh). x (batch, h, w, cin) NHWC
// bf16; mul, add (batch, cin) fp32; w the packed weights (3, 3, cout, cin)
// bf16; bias (cout) fp32; emb (batch, cout) bf16 and res (batch, h, w,
// cout) NHWC bf16, each may be null; out (batch, h, w, cout) NHWC bf16.
// Tiles of th x 8 pixels: th 8 (the whole-image tier; wn 32, BN = 64) or 16
// (BN = wn: 64, 128, 160 or 256). cin % 64 == 0, cout % BN == 0, pointers
// 16-byte aligned (the Python wrapper checks).
// splits > 1 needs `partial` ((splits, batch*h*w, cout) fp32) and
// `counters` (zeroed, one per output tile: batch x ceil(h/th) x ceil(w/8) x
// cout/BN), used by no other launch at the same time; each split
// chunks_per_split 64-channel chunks, none empty. At most `sms` blocks (the
// device's multiprocessors). Launches on `stream`; returns
// cudaGetLastError(), cudaErrorInvalidValue for a shape or tile the kernel
// does not take, or -(CUresult) if cuTensorMapEncodeTiled refuses a map.
extern "C" int edtr_gn_conv(int wn, int th, const void* x, const void* mul, const void* add,
                            const void* w, const void* bias, const void* emb, const void* res,
                            void* out, void* partial, void* counters, int batch, int h,
                            int w_out, int cin, int cout, int splits, int chunks_per_split,
                            int sms, void* stream) {
  edtr_gnconv::Args a = {};
  a.mul = static_cast<const float*>(mul);
  a.add = static_cast<const float*>(add);
  a.bias = static_cast<const float*>(bias);
  a.emb = static_cast<const edtr::bf16*>(emb);
  a.res = static_cast<const edtr::bf16*>(res);
  a.out = static_cast<edtr::bf16*>(out);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.batch = batch;
  a.h = h;
  a.w = w_out;
  a.cin = cin;
  a.cout = cout;
  a.splits = splits;
  a.chunks_per_split = chunks_per_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using edtr_gnconv::launch;
  if (th == 8 && wn == 32) return launch<32, true>(x, w, a, sms, st);
  if (th == 16 && wn == 64) return launch<64, false>(x, w, a, sms, st);
  if (th == 16 && wn == 128) return launch<128, false>(x, w, a, sms, st);
  if (th == 16 && wn == 160) return launch<160, false>(x, w, a, sms, st);
  if (th == 16 && wn == 256) return launch<256, false>(x, w, a, sms, st);
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
  a.out = static_cast<edtr::bf16*>(out);
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
