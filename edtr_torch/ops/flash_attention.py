"""Flash attention, forward and backward: Hopper kernels and their plain
PyTorch versions.

Counterpart of ``edtr_tpu/ops/flash_attention.py``. The dispatch
(:func:`shapes_supported`, :func:`kernel_for`, :func:`bwd_kernel_for`)
mirrors the JAX one exactly, so each JAX Pallas kernel has one wrapper here,
with its own launch count:

  ==============  =====================================  ====================
  wrapper         replaces (edtr_tpu/ops/...)             CUDA symbol
  ==============  =====================================  ====================
  wholekv_fwd     flash_attention.py:_qblock_wholekv_    edtr_flash_fwd_wgmma
                  fwd_flat (2048 <= N <= 4096, D <= 128)
  whole_fwd       flash_attention.py:_whole_fwd_flat     edtr_flash_fwd_wgmma
                  (N <= 1024, D <= 128)
  flash_fwd       flash_attention.py:_flash_fwd_flat     edtr_flash_fwd_wgmma
                  (N > 4096, D <= 128)
  streamkv_fwd    flash_attention.py:_streamkv_fwd_flat  edtr_flash_fwd_streamkv
                  (128 < D <= 512)
  whole_bwd       flash_attention.py:_whole_bwd_flat     edtr_flash_bwd_dq_wgmma
                  (N <= 1024, D <= 128)                  + edtr_flash_bwd_dkv_wgmma
  flash_bwd_dq    flash_attention.py:_flash_bwd_flat     edtr_flash_bwd_dq_wgmma
                  (``_dq_kernel``; N > 1024, D <= 128)
  flash_bwd_dkv   flash_attention.py:_flash_bwd_flat     edtr_flash_bwd_dkv_wgmma
                  (``_dkv_kernel``)
  ==============  =====================================  ====================

The forward kernels live in ``edtr_torch/csrc/flash_attention.cu`` (D =
64: the wgmma kernel of ``csrc/flash_wgmma.cuh``, one walk for all three
wrappers, in the tile plan :func:`flash_plan` picks; D = 256, 384, 512: the
wgmma kernel of ``csrc/flash_streamkv.cuh``, its KV range split as
:func:`streamkv_splits` says), the backward ones in
``edtr_torch/csrc/flash_attention_bwd.cu`` (D = 64: the wgmma pair of
``csrc/flash_bwd_wgmma.cuh``, dq and dk/dv, one tile plan each; see the
headers for the designs). A forward wrapper given CPU tensors computes
:func:`plain_fwd`, a backward one :func:`plain_bwd`; given CUDA tensors
each launches its kernel or raises. :func:`kernel_takes` says which
(dtype, BH, N, D) each wrapper's kernel takes: bf16, D 64 and N a multiple
of 128 (the forward) or of 64 (the backward); bf16, D 256, 384 or 512 and
N a multiple of 128 (``streamkv_fwd``). The launchers raise exactly where
it is false (and on tensors that are not contiguous, 16-byte aligned CUDA
tensors of one shape, or a scale that is not positive), and
``ops/attention.py:kernel_route`` sends such calls to the plain math. The
D > 128 backward is :func:`plain_bwd` on every device, as JAX leaves it to
XLA (``_xla_bwd_flat``).

:func:`flash_attention` is differentiable: a ``torch.autograd.Function``
whose forward saves q, k, v, the output and the logsumexp, and whose
backward is JAX's ``_bwd``: D = rowsum(dO * O) from the saved output, then
the backward wrapper :func:`bwd_kernel_for` names.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Tuple

import torch

from edtr_torch.ops import _cuda

Q_BLOCK = 512
KV_BLOCK = 1024
WHOLE_SEQ_MAX = 1024
MIN_SEQ = 512
Q_BLOCK_WHOLEKV = 256

# kernel launches per wrapper; chip_smoke.py zeroes these around a run
launches: Dict[str, int] = {
    "wholekv_fwd": 0, "whole_fwd": 0, "flash_fwd": 0, "streamkv_fwd": 0,
    "whole_bwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# launches per (wrapper, BH, N, D)
shapes: Counter = Counter()

# (symbol, head dims, row tile n must divide) of each forward wrapper's
# kernel
_KERNEL = {
    "wholekv_fwd": ("edtr_flash_fwd_wgmma", (64,), 128),
    "whole_fwd": ("edtr_flash_fwd_wgmma", (64,), 128),
    "flash_fwd": ("edtr_flash_fwd_wgmma", (64,), 128),
    "streamkv_fwd": ("edtr_flash_fwd_streamkv", (256, 384, 512), 128),
}
# the tile plans of edtr_flash_fwd_wgmma (csrc/flash_wgmma.cuh), by index:
# (K/V tile rows, ring stages, blocks resident on an SM), each block 64
# query rows; the row tile 128 is a multiple of 64 and of every K/V tile
FLASH_PLANS = ((64, 3, 3), (128, 2, 2))
# grids of up to two 64-row blocks for each of an H100's 132 SMs take the
# 128-row plan
_SMALL_GRID = 2 * _cuda.SMS


def flash_plan(bh: int, n: int) -> int:
    """The index into :data:`FLASH_PLANS` the wgmma kernel runs at (BH, N):
    64-row K/V tiles, three blocks an SM, where the grid fills the card
    (the restore's 4096-token attention, the step's both); 128-row tiles
    where it has at most two blocks an SM (the restore's 1024 tokens), the
    faster plan at each on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, PR
    9)."""
    return 1 if bh * (n // 64) <= _SMALL_GRID else 0


# the backward kernels' row block and streamed tile (rows); N must be a
# multiple of it
BWD_ROW_TILE = 64
BWD_NAMES = ("whole_bwd", "flash_bwd_dq", "flash_bwd_dkv")
# the largest grid index and flat row count the kernels address
_MAX_BH = 65535
_MAX_ROWS = 2 ** 31 - 1


def kernel_takes(name: str, dtype: torch.dtype, bh: int, n: int, d: int) -> bool:
    """Whether wrapper ``name``'s kernel takes (BH, N, D) tensors of
    ``dtype``: bf16 only; the forward wrappers at the head dims and row tile
    of :data:`_KERNEL`, the backward ones at D 64 and N a multiple of
    :data:`BWD_ROW_TILE`. The launchers raise exactly where this is false;
    JAX's Pallas kernels also take other dtypes and D <= 128, which the
    route leaves to the plain math here."""
    if dtype != torch.bfloat16 or not 0 < bh <= _MAX_BH or n <= 0 or bh * n > _MAX_ROWS:
        return False
    if name in BWD_NAMES:
        return d == 64 and n % BWD_ROW_TILE == 0
    _, dims, row_tile = _KERNEL[name]
    return d in dims and n % row_tile == 0


# streamkv_fwd's query blocks (64 rows) a launch may have and still split
# its KV range in two (one arrival counter each, of _cuda.arrival_counters):
# up to half an H100's 132 SMs, one block an SM
_STREAMKV_SPLIT_MAX = _cuda.SMS // 2


def streamkv_splits(bh: int, n: int) -> int:
    """The KV splits of a ``streamkv_fwd`` launch: 2 where its 64-row query
    blocks alone would leave more than half the SMs idle (the restore's
    (1, 4096, 512): 64 blocks), combined in a fixed order; else 1."""
    return 2 if bh * (n // 64) <= _STREAMKV_SPLIT_MAX else 1


def shapes_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """(B, N, H, D) self-attention shapes the kernels take; the same
    predicate as ``edtr_tpu.ops.flash_attention.shapes_supported``."""
    if q.ndim != 4 or k.shape != v.shape:
        return False
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if nq != nk:
        return False
    if d > 128:
        if d > 512 or d % 128 != 0:
            return False
        return nq >= 2048 and nq % Q_BLOCK == 0 and nk % KV_BLOCK == 0
    if nq >= 2048:
        return nq % Q_BLOCK == 0 and nk % KV_BLOCK == 0
    return nq >= MIN_SEQ and nq % 128 == 0


def kernel_for(n: int, d: int) -> str:
    """The wrapper ``edtr_tpu``'s ``_fwd_flat_dispatch`` picks for a
    supported (N, D), with its default ``EDTR_FLASH_BIGSEQ=wholekv``."""
    if d > 128:
        return "streamkv_fwd"
    if n <= WHOLE_SEQ_MAX:
        return "whole_fwd"
    if n <= 4096 and n % Q_BLOCK_WHOLEKV == 0:
        return "wholekv_fwd"
    return "flash_fwd"


def bwd_kernel_for(n: int, d: int) -> str:
    """The backward ``edtr_tpu``'s ``_bwd`` takes at (N, D): the XLA
    recompute (here :func:`plain_bwd`) for D > 128, else the whole-sequence
    kernel for N <= 1024, else the dq/dkv pair."""
    if d > 128:
        return "plain_bwd"
    return "whole_bwd" if n <= WHOLE_SEQ_MAX else "flash_bwd"


def plain_fwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D)^3 -> (out (BH, N, D) in v's dtype, lse (BH, N) fp32).

    ``edtr_tpu.ops.attention._xla_attention`` plus the logsumexp: exact
    fp32 logits (bf16 x bf16 products are exact in fp32), scale on the
    fp32 logits, fp32 softmax, probabilities cast to v's dtype for PV.
    """
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(vf.dtype)
    out = torch.matmul(p.float(), vf.float()).to(vf.dtype)
    return out, lse


@functools.lru_cache(maxsize=None)
def _symbol(symbol: str):
    """The C entry point, with its signature declared (q, k, v, o, lse
    pointers; the wgmma kernel: bh, n, scale, plan; the streamed-KV one:
    the split scratch and counters, bh, n, d, splits, scale; stream)."""
    fn = getattr(_cuda.load("flash_attention"), symbol)
    if symbol == "edtr_flash_fwd_streamkv":
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, qf, kf, vf, scale: float):
    symbol, dims, row_tile = _KERNEL[name]
    for t in (qf, kf, vf):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous CUDA tensors, got {t.device} "
                             f"contiguous={t.is_contiguous()}")
        if t.shape != qf.shape or t.device != qf.device or t.dtype != qf.dtype:
            raise ValueError(f"{name}: q/k/v shapes, dtypes or devices differ")
        if t.data_ptr() % 16:  # TMA copies 16-byte aligned rows
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")
    bh, n, d = qf.shape
    if not kernel_takes(name, qf.dtype, bh, n, d):
        raise ValueError(f"{name}: kernel takes bf16 with D in {dims} and N a multiple of "
                         f"{row_tile}, got {qf.dtype} {tuple(qf.shape)}")
    if not scale > 0:  # the kernels take the row max over the raw logits
        raise ValueError(f"{name}: the kernel takes a positive scale, got {scale}")
    fn = _symbol(symbol)
    out = torch.empty_like(qf)
    lse = torch.empty((bh, n), device=qf.device, dtype=torch.float32)
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream().cuda_stream
        if symbol == "edtr_flash_fwd_streamkv":
            splits = streamkv_splits(bh, n)
            part = ml = cnt = None
            if splits > 1:
                part = torch.empty((splits, bh, n, d), device=qf.device, dtype=torch.float32)
                ml = torch.empty((splits, bh, n, 2), device=qf.device, dtype=torch.float32)
                cnt = _cuda.arrival_counters(qf.device, stream)
            err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), *(None if t is None else t.data_ptr()
                                       for t in (part, ml, cnt)),
                     bh, n, d, splits, float(scale), stream)
        else:
            err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), bh, n, float(scale), flash_plan(bh, n), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launches[name] += 1
    shapes[(name, *qf.shape)] += 1
    return out, lse


def _wrapper(name: str):
    def fwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
        if qf.device.type == "cpu":
            return plain_fwd(qf, kf, vf, scale)
        return _launch(name, qf, kf, vf, scale)

    fwd.__name__ = fwd.__qualname__ = name
    fwd.__doc__ = (f"(BH, N, D)^3 -> (out, lse): the ``{name}`` kernel on "
                   "CUDA tensors, :func:`plain_fwd` on CPU tensors.")
    return fwd


wholekv_fwd = _wrapper("wholekv_fwd")
whole_fwd = _wrapper("whole_fwd")
flash_fwd = _wrapper("flash_fwd")
streamkv_fwd = _wrapper("streamkv_fwd")
FWD = {"wholekv_fwd": wholekv_fwd, "whole_fwd": whole_fwd,
       "flash_fwd": flash_fwd, "streamkv_fwd": streamkv_fwd}


def plain_bwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, dof: torch.Tensor,
              lse: torch.Tensor, dd: torch.Tensor, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(BH, N, D) q, k, v, dO; (BH, N) fp32 lse and D -> (dq, dk, dv).

    ``edtr_tpu.ops.flash_attention._xla_bwd_flat`` cast for cast: fp32
    logits times scale, p = exp(s - lse) in fp32; dv from p cast to dO's
    dtype, dp = dO v^T and ds = p (dp - D) cast to q's dtype, each product
    accumulated in fp32; each gradient cast once to its input's dtype.
    """
    f32 = torch.float32
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(dof.dtype).to(f32).transpose(1, 2), dof.float()).to(vf.dtype)
    dp = torch.matmul(dof.float(), vf.float().transpose(1, 2))
    ds = (p * (dp - dd[..., None])).to(qf.dtype).to(f32)
    dq = (torch.matmul(ds, kf.float()) * scale).to(qf.dtype)
    dk = (torch.matmul(ds.transpose(1, 2), qf.float()) * scale).to(kf.dtype)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _bwd_symbol(symbol: str):
    """A backward C entry point, with its signature declared (q, k, v, do,
    lse, dd, then dq or dk + dv pointers; bh, n; scale; stream)."""
    fn = getattr(_cuda.load("flash_attention_bwd"), symbol)
    outs = 1 if symbol == "edtr_flash_bwd_dq_wgmma" else 2
    fn.argtypes = [ctypes.c_void_p] * (6 + outs) + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(name: str, kernel: str, ins, outs, scale: float) -> None:
    """One launch of the backward ``kernel`` ("dq" or "dkv")."""
    qf, kf, vf, dof, lse, dd = ins
    for t in (qf, kf, vf, dof):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous CUDA q/k/v/dO, got {t.device} "
                             f"contiguous={t.is_contiguous()}")
        if t.shape != qf.shape or t.device != qf.device or t.dtype != qf.dtype:
            raise ValueError(f"{name}: q/k/v/dO shapes, dtypes or devices differ")
        if t.data_ptr() % 16:  # TMA copies 16-byte aligned rows
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")
    bh, n, d = qf.shape
    if not kernel_takes(name, qf.dtype, bh, n, d):
        raise ValueError(f"{name}: kernel takes bf16 with D=64 and N a multiple of "
                         f"{BWD_ROW_TILE}, got {qf.dtype} {tuple(qf.shape)}")
    for t in (lse, dd):
        if (t.dtype != torch.float32 or tuple(t.shape) != (bh, n) or t.device != qf.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: lse and D must be contiguous fp32 ({bh}, {n}) on "
                             f"{qf.device}, 16-byte aligned")
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_symbol(f"edtr_flash_bwd_{kernel}_wgmma")(
            *(t.data_ptr() for t in (*ins, *outs)), bh, n, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def flash_bwd_dq(qf, kf, vf, dof, lse, dd, scale: float) -> torch.Tensor:
    """dq of the backward: the ``flash_bwd_dq`` kernel on CUDA tensors
    (``_dq_kernel``), :func:`plain_bwd`'s dq on CPU tensors."""
    if qf.device.type == "cpu":
        return plain_bwd(qf, kf, vf, dof, lse, dd, scale)[0]
    dq = torch.empty_like(qf)
    _launch_bwd("flash_bwd_dq", "dq", (qf, kf, vf, dof, lse, dd), (dq,), scale)
    launches["flash_bwd_dq"] += 1
    shapes[("flash_bwd_dq", *qf.shape)] += 1
    return dq


def flash_bwd_dkv(qf, kf, vf, dof, lse, dd, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the backward: the ``flash_bwd_dkv`` kernel on CUDA
    tensors (``_dkv_kernel``), :func:`plain_bwd`'s on CPU tensors."""
    if qf.device.type == "cpu":
        return plain_bwd(qf, kf, vf, dof, lse, dd, scale)[1:]
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    _launch_bwd("flash_bwd_dkv", "dkv", (qf, kf, vf, dof, lse, dd), (dk, dv), scale)
    launches["flash_bwd_dkv"] += 1
    shapes[("flash_bwd_dkv", *qf.shape)] += 1
    return dk, dv


def whole_bwd(qf, kf, vf, dof, lse, dd, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) at N <= 1024 (``_whole_bwd_flat``): on CUDA tensors the
    dq and dkv kernels, counted as one call; :func:`plain_bwd` on CPU
    tensors."""
    if qf.device.type == "cpu":
        return plain_bwd(qf, kf, vf, dof, lse, dd, scale)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    ins = (qf, kf, vf, dof, lse, dd)
    _launch_bwd("whole_bwd", "dq", ins, (dq,), scale)
    _launch_bwd("whole_bwd", "dkv", ins, (dk, dv), scale)
    launches["whole_bwd"] += 1
    shapes[("whole_bwd", *qf.shape)] += 1
    return dq, dk, dv


def flash_bwd(qf, kf, vf, dof, lse, dd, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_flash_bwd_flat``: :func:`flash_bwd_dq` then :func:`flash_bwd_dkv`."""
    return (flash_bwd_dq(qf, kf, vf, dof, lse, dd, scale),
            *flash_bwd_dkv(qf, kf, vf, dof, lse, dd, scale))


BWD = {"plain_bwd": plain_bwd, "whole_bwd": whole_bwd, "flash_bwd": flash_bwd}


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of ``edtr_tpu``'s ``flash_attention`` on flat
    (BH, N, D) tensors: ``_fwd`` saves q, k, v, the output and lse; ``_bwd``
    computes D from the saved output and dispatches by (N, D)."""

    @staticmethod
    def forward(ctx, qf, kf, vf, scale):
        out, lse = FWD[kernel_for(qf.shape[1], qf.shape[2])](qf, kf, vf, scale)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        dof = dout.to(out.dtype).contiguous()
        # D_i = sum_d dO_i O_i, the softmax-jacobian row correction
        dd = (dof.float() * out.float()).sum(-1)
        grads = BWD[bwd_kernel_for(qf.shape[1], qf.shape[2])](
            qf, kf, vf, dof, lse, dd, ctx.scale)
        return (*grads, None)


def _to_flat(x: torch.Tensor) -> torch.Tensor:
    b, n, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, n, d).contiguous()


def _from_flat(xf: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, n, d = xf.shape
    return xf.reshape(b, h, n, d).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, N, H, D) -> (B, N, H, D): ``edtr_tpu.ops.flash_attention.
    flash_attention``, differentiable in q, k and v."""
    b, n, h, d = q.shape
    out = _FlashAttention.apply(_to_flat(q), _to_flat(k), _to_flat(v), scale)
    return _from_flat(out, b, h)
