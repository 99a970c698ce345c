"""GEGLU projection of the transformer FeedForward: Hopper kernels and their
plain PyTorch versions.

Counterpart of ``edtr_tpu/ops/geglu.py``. Each JAX Pallas kernel has one
wrapper here, with its own launch count:

  =============  =================================  =========================
  wrapper        replaces (edtr_tpu/ops/geglu.py)   CUDA kernel
  =============  =================================  =========================
  geglu_proj     ``geglu_proj`` (``_kernel``)       lnproj_kernel
                                                    <PRO_NONE, EPI_GEGLU>
  ln_geglu_proj  ``ln_geglu_proj`` (``_ln_kernel``)  lnproj_kernel
                                                    <PRO_LN, EPI_GEGLU>
  =============  =================================  =========================

Both compute ``(x@wh + bh) * gelu_erf(x@wg + bg)`` (``ln_geglu_proj`` on
LN(x)), where ``wh``/``wg`` and ``bh``/``bg`` are the two halves of the
FeedForward's packed ``ff.net.0.proj`` Linear: rows [0, inner) and [inner,
2*inner) of its (2*inner, C) weight. The wrappers take that packed weight
and bias as the module holds them. The kernels live in
``edtr_torch/csrc/geglu.cu``, both on the wgmma GEMM of
``csrc/proj_wgmma.cuh`` (tokens by TMA, weights through a TMA ring):
``ln_geglu_proj`` normalises its tokens once per block, ``geglu_proj``
multiplies them as they land.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches its kernel or raises. :func:`supported` is JAX's rule, so the
FeedForward takes the split-halves form exactly where JAX does;
:func:`geglu_takes` says where the kernels take a call, and the
FeedForward's route sends a call the form admits but the kernels do not
take (fp32 tokens, an ``inner`` not a multiple of 32) to the plain
versions on the card. Both
wrappers are ``torch.autograd.Function``s whose backward is JAX's recompute
(``geglu.py:_bwd``/``_ln_bwd``): ``torch.autograd.grad`` of the plain
version at the saved inputs (``ops/_grad.py``), for every tensor input but
``w_packed``.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from edtr_torch.ops import _cuda
from edtr_torch.ops._grad import needs_grad, recompute_grads
from edtr_torch.ops._norms import ln_f32
from edtr_torch.ops._proj import (C_MULT, check, check_tokens, dot32, lnproj_fits,
                                  lnproj_plan, on_device, raise_on_error)

# copies of edtr_tpu/ops/geglu.py's eligibility constants: the kernels take
# the shapes the TPU kernel takes, so the FeedForward picks the same form
SEQ_TILE = 256
COL_TILE = 1280
VMEM_BUDGET = 12 * 2 ** 20

# kernel launches per wrapper; chip_smoke.py zeroes these around a run
launches: Dict[str, int] = {"geglu_proj": 0, "ln_geglu_proj": 0}
# launches per (wrapper, B, N, C, inner)
shapes: Counter = Counter()


def _cell_bytes(c: int, cc: int) -> int:
    es = 2
    return (2 * es * (SEQ_TILE * c + 2 * c * cc + SEQ_TILE * cc)
            + 2 * 4 * SEQ_TILE * cc)


def _col_tile(c: int, inner: int) -> Optional[int]:
    """``geglu._col_tile``: the TPU kernel's column chunk, None where it has
    none (its shape rule, not a tile of these kernels)."""
    if inner <= COL_TILE:
        return inner if _cell_bytes(c, inner) <= VMEM_BUDGET else None
    cc = COL_TILE
    while cc >= 128:
        if inner % cc == 0 and _cell_bytes(c, cc) <= VMEM_BUDGET:
            return cc
        cc //= 2
    return None


def supported(n: int, c: int, inner: int) -> bool:
    """``geglu.supported``: the shapes the kernels take."""
    return n % SEQ_TILE == 0 and _col_tile(c, inner) is not None


def geglu_takes(dtype: torch.dtype, n: int, c: int, inner: int) -> bool:
    """Whether ``geglu_proj``'s and ``ln_geglu_proj``'s kernels take (B, n,
    c) tokens of ``dtype`` into ``inner`` columns: bf16, :func:`supported`
    (JAX's rule), C a multiple of 32 whose (64, C) tokens fit a block's
    shared memory beside a 2-stage weight ring, ``inner`` a multiple of 32.
    The launchers raise where this is false."""
    return (dtype == torch.bfloat16 and supported(n, c, inner) and c % C_MULT == 0
            and lnproj_fits(c) and inner > 0 and inner % 32 == 0)


def plain_geglu_proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(x@wh + bh) * gelu(x@wg + bg)`` with the casts of ``geglu._ref``:
    products accumulated in fp32, both biases added in fp32 before the
    exact GELU, the product rounded once to x's dtype. x (B, N, C); w
    (2*inner, C) and b (2*inner,), the packed halves."""
    inner = w.shape[0] // 2
    a = dot32(x, w[:inner]) + b[:inner].float()
    g = dot32(x, w[inner:]) + b[inner:].float()
    return (a * F.gelu(g)).to(x.dtype)


def plain_ln_geglu_proj(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                        w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """:func:`plain_geglu_proj` of LN(x) (fp32, rounded to x's dtype):
    ``geglu._ln_ref``."""
    return plain_geglu_proj(ln_f32(x, ln_s, ln_b, eps).to(x.dtype), w, b)


@functools.lru_cache(maxsize=None)
def _symbol():
    fn = _cuda.load("geglu").edtr_geglu
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            w_packed: Optional[torch.Tensor], ln=None, eps: float = 1e-5) -> torch.Tensor:
    bsz, n, c = x.shape
    inner = w.shape[0] // 2
    if tuple(w.shape) != (2 * inner, c) or inner % 32 or inner == 0:
        raise ValueError(f"{name}: w must be (2*inner, {c}) with inner % 32 == 0, "
                         f"got {tuple(w.shape)}")
    check_tokens(name, x, supported(n, c, inner))
    if not geglu_takes(x.dtype, n, c, inner):  # what is left: C past shared memory
        raise ValueError(f"{c} channels do not fit the GEGLU kernels' shared memory")
    dev = x.device
    with torch.no_grad():
        wp = w.detach().to(torch.bfloat16).contiguous() if w_packed is None else w_packed
    check(wp, f"{name}: w_packed", torch.bfloat16, (2 * inner, c), dev)
    bias = b.float().contiguous()
    check(bias, f"{name}: bias", torch.float32, (2 * inner,), dev)
    s = sh = None
    if ln is not None:
        s, sh = (t.float().contiguous() for t in ln)
        check(s, f"{name}: ln_s", torch.float32, (c,), dev)
        check(sh, f"{name}: ln_b", torch.float32, (c,), dev)
    out = torch.empty((bsz, n, inner), device=dev, dtype=torch.bfloat16)
    bm, bn, groups = lnproj_plan(bsz * n, c, 2 * inner, name)
    with on_device(dev):
        err = _symbol()(int(ln is not None), bm, bn, groups, x.data_ptr(),
                        None if s is None else s.data_ptr(),
                        None if sh is None else sh.data_ptr(), wp.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), bsz * n, c, inner, float(eps),
                        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)
    launches[name] += 1
    shapes[(name, bsz, n, c, inner)] += 1
    return out


def _geglu_proj(x, w, b, w_packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_geglu_proj(x, w, b)
    return _launch("geglu_proj", x, w, b, w_packed)


def _ln_geglu_proj(x, ln_s, ln_b, w, b, eps, w_packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_ln_geglu_proj(x, ln_s, ln_b, w, b, eps)
    return _launch("ln_geglu_proj", x, w, b, w_packed, (ln_s, ln_b), eps)


class _GegluProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, w_packed):
        ctx.save_for_backward(x, w, b)
        return _geglu_proj(x, w, b, w_packed)

    @staticmethod
    def backward(ctx, grad):
        return recompute_grads(ctx.needs_input_grad, plain_geglu_proj, grad,
                               ctx.saved_tensors) + (None,)


class _LnGegluProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, w, b, eps, w_packed):
        ctx.save_for_backward(x, ln_s, ln_b, w, b)
        ctx.eps = eps
        return _ln_geglu_proj(x, ln_s, ln_b, w, b, eps, w_packed)

    @staticmethod
    def backward(ctx, grad):
        return recompute_grads(
            ctx.needs_input_grad,
            lambda *a: plain_ln_geglu_proj(*a, ctx.eps), grad, ctx.saved_tensors) + (None, None)


def geglu_proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(x@wh + bh) * gelu_erf(x@wg + bg)`` (B, N, inner): the
    ``geglu_proj`` kernel on CUDA tensors, :func:`plain_geglu_proj` on CPU
    tensors; differentiable (the plain version's gradients). ``w_packed``:
    the bf16 copy of ``w`` (made here, per call, when not given)."""
    if needs_grad(x, w, b):
        return _GegluProj.apply(x, w, b, w_packed)
    return _geglu_proj(x, w, b, w_packed)


def ln_geglu_proj(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5, *,
                  w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`geglu_proj` of LN(x), ``x`` the pre-norm residual stream: the
    ``ln_geglu_proj`` kernel on CUDA tensors (the normalised tokens never
    reach device memory), :func:`plain_ln_geglu_proj` on CPU tensors;
    differentiable (the plain version's gradients)."""
    if needs_grad(x, ln_s, ln_b, w, b):
        return _LnGegluProj.apply(x, ln_s, ln_b, w, b, eps, w_packed)
    return _ln_geglu_proj(x, ln_s, ln_b, w, b, eps, w_packed)
