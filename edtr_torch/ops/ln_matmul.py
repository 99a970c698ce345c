"""LayerNorm + bias-free projections and folded-GroupNorm + projection:
Hopper kernels and their plain PyTorch versions.

Counterpart of ``edtr_tpu/ops/ln_matmul.py``. Each JAX Pallas kernel has one
wrapper here, with its own launch count:

  =============  ====================================  =====================
  wrapper        replaces (edtr_tpu/ops/ln_matmul.py)  CUDA kernel
  =============  ====================================  =====================
  ln_matmuls     ``ln_matmuls`` (``_kernel``)          lnproj_kernel
                                                       <PRO_LN, EPI_STORE>
  affine_matmul  ``affine_matmul`` (``_aff_kernel``)   lnproj_kernel
                                                       <PRO_AFF, EPI_BIAS>
  =============  ====================================  =====================

The kernels live in ``edtr_torch/csrc/ln_matmul.cu``, both on the wgmma
GEMM of ``csrc/proj_wgmma.cuh`` (the LayerNorm or the folded GroupNorm
affine once per block, weights through a TMA ring; see its header for the
design). Tokens are (B, N, C)
with C contiguous, weights in nn.Linear layout (out, in): the module's fp32
weights for the plain versions, and for the kernels ``w_packed``, a bf16
copy (for K = 3 the (3*O, C) concatenation of q/k/v) that the modules cache
until a weight changes (``models/layers.py``).

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches its kernel or raises. The kernels take bf16 tokens with N a
multiple of :data:`SEQ_TILE` (:func:`supported`, JAX's rule), C a multiple
of 32 within a block's shared memory and O a multiple of 64
(:func:`ln_matmuls_takes`, :func:`affine_matmul_takes`); the routes of
``models/attention.py`` send calls JAX's rule admits but the kernels do
not take (fp32 tokens, the tiny flagship's 32-wide heads) to the plain
versions on the card.

Both wrappers are differentiable, on both devices: each is a
``torch.autograd.Function`` (JAX's ``custom_vjp``s, ``ln_matmul.py:_fwd/_bwd``
and ``_aff_fwd/_aff_bwd``) whose backward is JAX's recompute,
``torch.autograd.grad`` of the plain version at the saved inputs
(``ops/_grad.py``). Gradients reach every tensor input but ``w_packed``, a
cached detached copy of the weights; an output given no gradient counts as
zero.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch

from edtr_torch.ops import _cuda
from edtr_torch.ops._grad import needs_grad, recompute_grads
from edtr_torch.ops._norms import ln_f32
from edtr_torch.ops._proj import (C_MULT, check, check_tokens, dot32, lnproj_fits,
                                  lnproj_plan, on_device, raise_on_error)

# the token counts the kernels take: a copy of edtr_tpu/ops/ln_matmul.py's
# ``_SEQ_TILE`` rule, so the port fuses exactly where JAX does
SEQ_TILE = 256

# kernel launches per wrapper; chip_smoke.py zeroes these around a run
launches: Dict[str, int] = {"ln_matmuls": 0, "affine_matmul": 0}
# launches per (wrapper, B, N, C, O, K)
shapes: Counter = Counter()
# token views the SpatialTransformer had to copy to make them contiguous
# before a fused projection (strided on NCHW activations, none on
# channels-last ones)
layout_copies: Dict[str, int] = {"count": 0}


def supported(n: int) -> bool:
    """``ln_matmul.supported``: N tokens the kernels take."""
    return n % SEQ_TILE == 0


def ln_matmuls_takes(dtype: torch.dtype, n: int, c: int, o: int) -> bool:
    """Whether ``ln_matmuls``' kernel takes (B, n, c) tokens of ``dtype``
    projected to ``o`` columns a weight: bf16, :func:`supported` (JAX's
    rule), C a multiple of 32 whose (64, C) tokens fit a block's shared
    memory beside a 2-stage weight ring, O a multiple of 64. The launcher
    raises where this is false."""
    return (dtype == torch.bfloat16 and supported(n) and c % C_MULT == 0 and lnproj_fits(c)
            and o > 0 and o % 64 == 0)


def affine_matmul_takes(dtype: torch.dtype, n: int, c: int, o: int) -> bool:
    """Whether ``affine_matmul``'s kernel takes (B, n, c) tokens of
    ``dtype`` projected to ``o`` columns: bf16, :func:`supported` (JAX's
    rule), C a multiple of 32 whose (64, C) tokens fit a block's shared
    memory beside a 2-stage ring of 64-row weight tiles (the narrowest tile
    its plan takes), O a multiple of 64. The launcher raises where this is
    false."""
    return (dtype == torch.bfloat16 and supported(n) and c % C_MULT == 0 and lnproj_fits(c)
            and o > 0 and o % 64 == 0)


def plain_ln_matmuls(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                     ws: Sequence[torch.Tensor], eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, ...]:
    """``tuple(LN(x) @ w.T for w in ws)`` with the casts of ``_ref``: LN in
    fp32, rounded to x's dtype, products accumulated in fp32, each output
    rounded once. x (B, N, C); ln_s/ln_b (C,); ws (O, C) each."""
    cdt = x.dtype
    xln = ln_f32(x, ln_s, ln_b, eps).to(cdt)
    return tuple(dot32(xln, w).to(cdt) for w in ws)


def plain_affine_matmul(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                        w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``((x*mul + add) @ w.T) + b`` with the casts of ``_aff_ref``: the
    affine in fp32, rounded to x's dtype, the product accumulated in fp32
    and rounded, then the bias added in x's dtype. x (B, N, C); mul/add
    (B, C) fp32; w (O, C); b (O,)."""
    cdt = x.dtype
    xa = (x.float() * mul[:, None] + add[:, None]).to(cdt)
    return dot32(xa, w).to(cdt) + b.to(cdt)


@functools.lru_cache(maxsize=None)
def _symbol(name: str):
    lib = _cuda.load("ln_matmul")
    if name == "ln_matmuls":
        fn = lib.edtr_ln_matmul
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        fn = lib.edtr_affine_matmul
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ln_matmuls(x, ln_s, ln_b, ws, eps, w_packed) -> Tuple[torch.Tensor, ...]:
    if x.device.type == "cpu":
        return plain_ln_matmuls(x, ln_s, ln_b, ws, eps)
    b, n, c = x.shape
    k, o = len(ws), ws[0].shape[0]
    if not 1 <= k <= 3 or any(tuple(w.shape) != (o, c) for w in ws) or o % 64:
        raise ValueError(f"ln_matmuls: 1-3 weights of one (O, C), O % 64 == 0, C = {c}; "
                         f"got {[tuple(w.shape) for w in ws]}")
    check_tokens("ln_matmuls", x, supported(n))
    if not ln_matmuls_takes(x.dtype, n, c, o):  # what is left: C past shared memory
        raise ValueError(f"{c} channels do not fit the LayerNorm kernels' shared memory")
    dev = x.device
    with torch.no_grad():
        wp = (torch.cat([w.detach().to(torch.bfloat16) for w in ws])
              if w_packed is None else w_packed)
    check(wp, "ln_matmuls: w_packed", torch.bfloat16, (k * o, c), dev)
    s, sh = ln_s.float().contiguous(), ln_b.float().contiguous()
    check(s, "ln_matmuls: ln_s", torch.float32, (c,), dev)
    check(sh, "ln_matmuls: ln_b", torch.float32, (c,), dev)
    outs = tuple(torch.empty((b, n, o), device=dev, dtype=torch.bfloat16) for _ in range(k))
    bm, bn, groups = lnproj_plan(b * n, c, k * o, "ln_matmuls")
    ptrs = [t.data_ptr() for t in outs] + [None] * (3 - k)
    with on_device(dev):
        err = _symbol("ln_matmuls")(bm, bn, groups, x.data_ptr(), s.data_ptr(), sh.data_ptr(),
                                    wp.data_ptr(), *ptrs, k, b * n, c, o, float(eps),
                                    torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("ln_matmuls", err)
    launches["ln_matmuls"] += 1
    shapes[("ln_matmuls", b, n, c, o, k)] += 1
    return outs


def _affine_matmul(x, mul, add, w, b, w_packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_affine_matmul(x, mul, add, w, b)
    bsz, n, c = x.shape
    o = w.shape[0]
    if tuple(w.shape) != (o, c) or o % 64:
        raise ValueError(f"affine_matmul: w must be (O, {c}) with O % 64 == 0, "
                         f"got {tuple(w.shape)}")
    check_tokens("affine_matmul", x, supported(n))
    if not affine_matmul_takes(x.dtype, n, c, o):  # what is left: C past shared memory
        raise ValueError(f"{c} channels do not fit the affine kernel's shared memory")
    dev = x.device
    with torch.no_grad():
        wp = w.detach().to(torch.bfloat16).contiguous() if w_packed is None else w_packed
    check(wp, "affine_matmul: w_packed", torch.bfloat16, (o, c), dev)
    m, a = mul.float().contiguous(), add.float().contiguous()
    bias = b.float().contiguous()
    check(m, "affine_matmul: mul", torch.float32, (bsz, c), dev)
    check(a, "affine_matmul: add", torch.float32, (bsz, c), dev)
    check(bias, "affine_matmul: bias", torch.float32, (o,), dev)
    out = torch.empty((bsz, n, o), device=dev, dtype=torch.bfloat16)
    bm, bn, groups = lnproj_plan(bsz * n, c, o, "affine_matmul")
    with on_device(dev):
        err = _symbol("affine_matmul")(bm, bn, groups, x.data_ptr(), m.data_ptr(),
                                       a.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                                       out.data_ptr(), bsz * n, c, o, n,
                                       torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("affine_matmul", err)
    launches["affine_matmul"] += 1
    shapes[("affine_matmul", bsz, n, c, o, 1)] += 1
    return out


class _LnMatmuls(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, eps, w_packed, *ws):
        ctx.save_for_backward(x, ln_s, ln_b, *ws)
        ctx.eps = eps
        return _ln_matmuls(x, ln_s, ln_b, ws, eps, w_packed)

    @staticmethod
    def backward(ctx, *grads):
        x, ln_s, ln_b, *ws = ctx.saved_tensors
        needs = ctx.needs_input_grad
        got = recompute_grads(needs[:3] + needs[5:],
                              lambda x, s, b, *ws: plain_ln_matmuls(x, s, b, ws, ctx.eps),
                              grads, (x, ln_s, ln_b, *ws))
        return got[:3] + (None, None) + got[3:]


class _AffineMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mul, add, w, b, w_packed):
        ctx.save_for_backward(x, mul, add, w, b)
        return _affine_matmul(x, mul, add, w, b, w_packed)

    @staticmethod
    def backward(ctx, grad):
        return recompute_grads(ctx.needs_input_grad, plain_affine_matmul, grad,
                               ctx.saved_tensors) + (None,)


def ln_matmuls(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
               ws: Sequence[torch.Tensor], eps: float = 1e-5, *,
               w_packed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """``tuple(LN(x) @ w.T for w in ws)``, K = len(ws) in 1..3 weights of
    the same (O, C): the ``ln_matmuls`` kernel on CUDA tensors (K contiguous
    (B, N, O) outputs), :func:`plain_ln_matmuls` on CPU tensors;
    differentiable (the plain version's gradients). ``w_packed``: the
    (K*O, C) bf16 concatenation of ``ws`` (made here, per call, when not
    given)."""
    if needs_grad(x, ln_s, ln_b, *ws):
        return tuple(_LnMatmuls.apply(x, ln_s, ln_b, eps, w_packed, *ws))
    return _ln_matmuls(x, ln_s, ln_b, ws, eps, w_packed)


def affine_matmul(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor, *,
                  w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``((x*mul + add) @ w.T) + b``: the ``affine_matmul`` kernel on CUDA
    tensors, :func:`plain_affine_matmul` on CPU tensors; differentiable (the
    plain version's gradients). ``w_packed``: the bf16 copy of ``w`` (made
    here, per call, when not given)."""
    if needs_grad(x, mul, add, w, b):
        return _AffineMatmul.apply(x, mul, add, w, b, w_packed)
    return _affine_matmul(x, mul, add, w, b, w_packed)
