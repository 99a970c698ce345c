"""SwinIR's windowed attention: a Hopper kernel and its plain PyTorch version.

Counterpart of ``edtr_tpu/ops/window_attention.py``:

  ================  =============================================  ==================
  wrapper           replaces (edtr_tpu/ops/window_attention.py)    CUDA kernel
  ================  =============================================  ==================
  window_attention  ``_win_fwd`` (``_win_kernel``)                 window_attention_
                                                                   kernel
  ================  =============================================  ==================

The kernel lives in ``edtr_torch/csrc/window_attention.cu`` (see its header
for the design). :func:`plain_window_attention` is the math of JAX's
``_xla_reference`` (which ``_win_kernel`` matches): fp32 logits, the
relative-position bias, the shift mask of window ``w mod nW``, fp32 softmax,
P rounded to v's dtype after its normalisation, PV accumulated in fp32.

Layout (JAX's): q/k/v (BW, N, H, D), possibly the strided q/k/v slices of
the packed (BW, N, 3C) windows; bias (H, N, N) fp32; mask (nW, N, N) fp32 or
None. A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches its kernel or raises. The kernel takes bf16 q/k/v with
N = 64 (window 8), D even and at most 32, unit stride along D and even
strides elsewhere.

The wrapper is a ``torch.autograd.Function`` whose backward is JAX's
recompute (``window_attention.py:_bwd_rule``): ``torch.autograd.grad`` of
the plain version at the saved inputs (``ops/_grad.py``), for q, k, v and
the relative-position bias; the shift mask is a constant and gets none.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Optional

import torch

from edtr_torch.ops import _cuda
from edtr_torch.ops._grad import needs_grad, recompute_grads
from edtr_torch.ops._proj import check, on_device, raise_on_error

N_TOKENS = 64   # tokens per window the kernel takes (window 8)
MAX_D = 32      # head dim, padded to 32 in the kernel

# kernel launches; chip_smoke.py zeroes it around a run
launches: Dict[str, int] = {"window_attention": 0}
# launches per (wrapper, BW, N, H, D, nW) (nW 0: no mask)
shapes: Counter = Counter()


def plain_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: Optional[torch.Tensor],
                           scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias [+ mask]) v over (BW, N, H, D) windows;
    window ``w`` takes mask row ``w mod nW``. Returns (BW, N, H, D) in v's
    dtype."""
    s = torch.einsum("wnhd,wmhd->whnm", q.float(), k.float()) * scale + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, *s.shape[1:]) + mask[None, :, None]).reshape(s.shape)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("whnm,wmhd->wnhd", p.float(), v.float()).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _symbol():
    fn = _cuda.load("window_attention").edtr_window_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_takes(dtype: torch.dtype, n: int, d: int) -> bool:
    """Whether the kernel takes (BW, n, H, d) windows of ``dtype``: bf16,
    N = 64 (window 8), D even and at most 32. The launcher raises where this
    is false; the fused Swin block's route (``models/swinir.py``) sends such
    blocks to the plain versions."""
    return dtype == torch.bfloat16 and n == N_TOKENS and 0 < d <= MAX_D and d % 2 == 0


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"window_attention: q/k/v must be (BW, N, H, D) of one dtype, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if not q.shape == k.shape == v.shape or not q.stride() == k.stride() == v.stride():
        raise ValueError("window_attention: q, k and v must have one shape and one stride")
    bw, n, h, d = q.shape
    if not kernel_takes(q.dtype, n, d):
        raise ValueError(f"window_attention: the kernel takes bf16 with N = {N_TOKENS} and "
                         f"an even D <= {MAX_D}, got {q.dtype}, N {n}, D {d}")
    if q.stride(3) != 1 or any(s % 2 for s in q.stride()[:3]):
        raise ValueError(f"window_attention: q/k/v need unit stride along D and even "
                         f"strides, got {q.stride()}")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("window_attention: q/k/v data is not 4-byte aligned")


def _window_attention(q, k, v, bias, mask, scale) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain_window_attention(q, k, v, bias.float(), mask, scale)
    _check_qkv(q, k, v)
    bw, n, h, d = q.shape
    dev = q.device
    check(bias, "window_attention: bias", torch.float32, (h, n, n), dev)
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        check(mask, "window_attention: mask", torch.float32, (nw, n, n), dev)
        if bw % nw:
            raise ValueError(f"window_attention: {bw} windows is not a multiple of the "
                             f"mask's {nw}")
    out = torch.empty((bw, n, h, d), device=dev, dtype=torch.bfloat16)
    with on_device(dev):
        err = _symbol()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                        None if mask is None else mask.data_ptr(), out.data_ptr(), bw, h, d,
                        *q.stride()[:3], nw, float(scale),
                        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("window_attention", err)
    launches["window_attention"] += 1
    shapes[("window_attention", bw, n, h, d, nw)] += 1
    return out


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale = scale
        return _window_attention(q, k, v, bias, mask, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, bias, mask = ctx.saved_tensors

        def plain(q, k, v, bias):  # the mask is a constant, as in JAX
            return plain_window_attention(q, k, v, bias.float(), mask, ctx.scale)
        return recompute_grads(ctx.needs_input_grad, plain, grad, (q, k, v, bias)) + (None, None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias [+ mask]) v: the ``window_attention`` kernel
    on CUDA tensors (contiguous (BW, N, H, D) output), the plain version on
    CPU tensors. ``scale`` defaults to D**-0.5. Differentiable in q, k, v
    and the bias (the plain version's gradients); the mask gets none."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if needs_grad(q, k, v, bias):
        return _WindowAttention.apply(q, k, v, bias, mask, scale)
    return _window_attention(q, k, v, bias, mask, scale)
