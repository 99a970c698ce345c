"""SwinIR's windowed attention: a Hopper kernel and its plain PyTorch version.

Counterpart of ``edtr_tpu/ops/window_attention.py``:

  ================  =============================================  ==================
  wrapper           replaces (edtr_tpu/ops/window_attention.py)    CUDA kernel
  ================  =============================================  ==================
  window_attention  ``_win_fwd`` (``_win_kernel``)                 window_attention_
                                                                   kernel
  ================  =============================================  ==================

The kernel lives in ``edtr_torch/csrc/window_attention.cu`` (see its header
for the design: a window a block, or two blocks of half the heads each
where that fills more of the card (:func:`window_split`); wgmma for both
products; the window's packed q/k/v rows by one bulk copy). :func:`plain_window_attention` is the math of JAX's
``_xla_reference`` (which ``_win_kernel`` matches): fp32 logits, the
relative-position bias, the shift mask of window ``w mod nW``, fp32 softmax,
P rounded to v's dtype after its normalisation, PV accumulated in fp32.

Layout (JAX's): q/k/v (BW, N, H, D), possibly the strided q/k/v slices of
the packed (BW, N, 3C) windows; bias (H, N, N) fp32; mask (nW, N, N) fp32 or
None. A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches its kernel or raises. The kernel takes bf16 q/k/v with
N = 64 (window 8), D even and at most 32, C = H D at most :data:`MAX_C`
(:func:`kernel_takes`), and only as the slices of one packed tensor, as
swin_pre writes them (k = q + C, v = q + 2C, strides (N 3C, 3C, D, 1):
:func:`packed_layout`), which come in by one bulk copy a window.

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
from edtr_torch.ops._proj import SMEM_LIMIT, check, on_device, raise_on_error

N_TOKENS = 64   # tokens per window the kernel takes (window 8)
MAX_D = 32      # head dim, padded to 32 in the kernel


def smem_bytes(c: int) -> int:
    """The kernel's dynamic shared memory at C = H D (``smem_bytes`` of
    ``csrc/window_attention.cu``): the alignment slack, three warpgroups'
    64 x 128-byte K and V tiles, the window's (64, 3C) bf16 rows, its (64,
    C) output rows, the mask in 288-byte rows and the mbarrier."""
    return (1024 + 3 * 2 * N_TOKENS * 128 + N_TOKENS * 3 * c * 2 + N_TOKENS * c * 2
            + N_TOKENS * 72 * 4 + 16)


# H * D: the widest even C whose block fits the shared memory (318)
MAX_C = max(c for c in range(2, 1024, 2) if smem_bytes(c) <= SMEM_LIMIT)

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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_takes(dtype: torch.dtype, n: int, d: int, heads: int) -> bool:
    """Whether the kernel takes (BW, n, heads, d) windows of ``dtype``:
    bf16, N = 64 (window 8), D even and at most 32, heads * D at most
    :data:`MAX_C`. The launcher raises where this is false, and where q/k/v
    are not the slices of one packed tensor (:func:`packed_layout`); the
    fused Swin block's route (``models/swinir.py``) sends blocks this
    refuses to the plain versions, and always hands the kernel swin_pre's
    packed slices."""
    return (dtype == torch.bfloat16 and n == N_TOKENS and 0 < d <= MAX_D and d % 2 == 0
            and 0 < heads * d <= MAX_C)


def window_split(bw: int, heads: int) -> int:
    """Blocks a window: 2 (each half the heads) where the heads split and
    two blocks a window still fit the card one block an SM (bs 1 at 64 x 64
    tokens: 64 windows, 128 blocks), else 1 (bs 2: 128 windows already).
    Both blocks of a window copy its whole packed rows in."""
    return 2 if heads >= 2 and 2 * bw <= _cuda.SMS else 1


def packed_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether (BW, N, H, D) q/k/v are the three slices of one packed (BW,
    N, 3C) tensor (C = H D) that swin_pre writes: k = q + C, v = q + 2C,
    strides (N 3C, 3C, D, 1), q 16-byte aligned: the only layout the kernel
    takes, each window's rows brought in by one bulk copy."""
    _, n, h, d = q.shape
    c, es = h * d, q.element_size()
    base = q.data_ptr()
    return (q.stride() == (n * 3 * c, 3 * c, d, 1) and base % 16 == 0
            and k.data_ptr() == base + c * es and v.data_ptr() == base + 2 * c * es)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"window_attention: q/k/v must be (BW, N, H, D) of one dtype, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if not q.shape == k.shape == v.shape or not q.stride() == k.stride() == v.stride():
        raise ValueError("window_attention: q, k and v must have one shape and one stride")
    bw, n, h, d = q.shape
    if not kernel_takes(q.dtype, n, d, h):
        raise ValueError(f"window_attention: the kernel takes bf16 with N = {N_TOKENS}, "
                         f"an even D <= {MAX_D} and H D <= {MAX_C}, got {q.dtype}, N {n}, "
                         f"H {h}, D {d}")
    if not packed_layout(q, k, v):
        raise ValueError("window_attention: the kernel takes q/k/v only as the slices of "
                         "one 16-byte aligned packed (BW, N, 3C) tensor (k = q + C, "
                         f"v = q + 2C, strides (N 3C, 3C, D, 1)), got strides {q.stride()}")


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
        err = _symbol()(q.data_ptr(), bias.data_ptr(),
                        None if mask is None else mask.data_ptr(), out.data_ptr(), bw, h, d,
                        nw, float(scale), window_split(bw, h),
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
