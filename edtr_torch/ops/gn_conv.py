"""Fused GroupNorm+SiLU+conv3x3 and nearest-2x+conv3x3: Hopper kernels and
their plain PyTorch versions.

Counterpart of ``edtr_tpu/ops/gn_conv.py``. Each JAX Pallas kernel has one
wrapper here, with its own launch count:

  ==============  ==========================================  ================
  wrapper         replaces (edtr_tpu/ops/gn_conv.py)          CUDA kernel
  ==============  ==========================================  ================
  gn_conv_whole   ``_call`` (``_kernel_{plain,emb,res,         conv3x3_kernel
                  emb_res}``), the whole-image tier: H < 16    <MODE_GN>
  gn_conv_band    ``_band_call`` (``_band_*``), the row-band   conv3x3_kernel
                  tier: H >= 16                                <MODE_GN>
  upsample_conv   ``upsample_conv`` (``_ups_kernel``)          conv3x3_kernel
                                                               <MODE_UP2>
  ==============  ==========================================  ================

:func:`gn_silu_conv` picks the tier by JAX's rule in ``_call`` (``h >= 16``
-> band). The kernels live in ``edtr_torch/csrc/gn_conv.cu`` (see its header
for the design); one implicit-GEMM kernel serves both tiers, with 64-pixel
output tiles (one 8² image) for the whole-image tier and 128-pixel tiles
(8 x 16 or 16 x 8 pixels) otherwise.

Tensors are NCHW at this interface, as in the port's modules. The kernels
read and write channels-last memory (``torch.channels_last``: physically
NHWC), which the fused modules keep from their first layer on; a CUDA input
in another layout is copied once and counted in :data:`layout_copies`.
Weights are the module's fp32 OIHW ``w`` for the plain version; the kernel
reads ``w_packed``, a bf16 (3, 3, Cout, Cin) copy (:func:`pack_weight`) that
``models/layers.py:Conv2d.packed_weight`` caches until the weight changes.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches its kernel or raises. The kernels take bf16 activations, fp32
``mul``/``add``/bias, Cin a multiple of 32 and Cout a multiple of 64.

:func:`gn_silu_conv` and :func:`upsample_conv` are differentiable, on both
devices: each is a ``torch.autograd.Function`` (JAX's ``custom_vjp``s,
``gn_conv.py:_fwd/_bwd`` and ``_ups_fwd/_ups_bwd``) whose forward is the
wrapper and whose backward is JAX's recompute: ``torch.autograd.grad`` of
the plain version at the saved inputs. Gradients reach every tensor input
but ``w_packed``, a cached detached copy of ``w``.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from edtr_torch.ops import _cuda
from edtr_torch.ops._grad import recompute_grads

BAND_MIN_H = 16   # ``_call``: h >= 16 takes the row-band tier
BK = 32           # input channels per chunk of the kernel's K walk
SMS = 132         # streaming multiprocessors of an H100 SXM

# kernel launches per wrapper; chip_smoke.py zeroes these around a run
launches: Dict[str, int] = {"gn_conv_whole": 0, "gn_conv_band": 0, "upsample_conv": 0}
# launches per (wrapper, B, Cin, H, W, Cout, emb, res, act) (H, W: output)
shapes: Counter = Counter()
# CUDA inputs that were not channels-last and were copied before a launch
layout_copies: Dict[str, int] = {"count": 0}


def pack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> (kh, kw, out, in) in ``dtype``, contiguous: the
    layout the kernels stream (one (Cout, Cin) matrix per tap)."""
    with torch.no_grad():
        return w.detach().to(dtype).permute(2, 3, 0, 1).contiguous()


def plain_gn_silu_conv(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor,
                       emb: Optional[torch.Tensor] = None,
                       res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3(silu(x*mul + add)) + b [+ emb] [+ res]``, pad 1, with the
    casts of ``gn_conv._ref``: affine in fp32, rounded to x's dtype, SiLU
    and conv in that dtype (fp32 accumulation), bias, emb, res added in it.

    x (B, Cin, H, W); mul/add (B, Cin) fp32; w (Cout, Cin, 3, 3); b (Cout,);
    emb (B, Cout); res (B, Cout, H, W). Returns (B, Cout, H, W) in x.dtype.
    """
    cdt = x.dtype
    a = x.float() * mul[:, :, None, None] + add[:, :, None, None]
    h = F.silu(a.to(cdt))
    o = F.conv2d(h, w.to(cdt), None, 1, 1)
    o = o + b.to(cdt)[:, None, None]
    if emb is not None:
        o = o + emb[:, :, None, None].to(cdt)
    if res is not None:
        o = o + res
    return o


def plain_upsample_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        act: Optional[str] = None) -> torch.Tensor:
    """``act(conv3x3(nearest2x(x)) + b)``, pad 1, in x's dtype: the math of
    ``gn_conv._ups_ref``. act None or "lrelu" (LeakyReLU 0.2).
    x (B, Cin, H, W) -> (B, Cout, 2H, 2W)."""
    cdt = x.dtype
    up = F.interpolate(x, scale_factor=2.0, mode="nearest")
    o = F.conv2d(up, w.to(cdt), None, 1, 1) + b.to(cdt)[:, None, None]
    if act == "lrelu":
        o = F.leaky_relu(o, 0.2)
    elif act is not None:
        raise ValueError(f"upsample_conv: act must be None or 'lrelu', got {act!r}")
    return o


def tier(h: int) -> str:
    """The wrapper ``_call`` picks for an H-row image."""
    return "gn_conv_band" if h >= BAND_MIN_H else "gn_conv_whole"


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, cin: int, cout: int, bm: int) -> Tuple[int, int, int, int]:
    """``(bn, tw, splits, chunks_per_split)`` of a launch over a (b, h, w)
    output with ``bm``-pixel tiles: 128-wide Cout tiles where Cout allows,
    tiles ``tw`` pixels wide, and the Cin chunks split across blocks when
    the output tiles alone would leave SMs idle."""
    bn = 128 if cout % 128 == 0 else 64
    tw = 8 if w <= 8 else 16
    th = bm // tw
    tiles = b * -(-h // th) * -(-w // tw) * (cout // bn)
    chunks = cin // BK
    splits = 1
    if tiles < SMS:
        splits = max(1, min(SMS // tiles, chunks))
    per = -(-chunks // splits)
    return bn, tw, -(-chunks // per), per


@functools.lru_cache(maxsize=None)
def _symbol():
    fn = _cuda.load("gn_conv").edtr_conv3x3
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tile_counters(device: torch.device, stream: int) -> torch.Tensor:
    """Zeroed split-K arrival counters of one stream: launches on a stream
    run one after another, so no two use them at once, and each leaves them
    zeroed."""
    key = (device, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(4 * SMS, dtype=torch.int32, device=device)
    return _counters[key]


def _nhwc(t: torch.Tensor, what: str) -> torch.Tensor:
    """(B, C, H, W) on the card -> its channels-last memory as contiguous
    NHWC (a view; a counted copy if ``t`` is in another layout)."""
    if t.dtype != torch.bfloat16 or t.ndim != 4:
        raise ValueError(f"gn_conv: {what} must be 4-D bf16, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        t = t.contiguous(memory_format=torch.channels_last)
        layout_copies["count"] += 1
    return t.permute(0, 2, 3, 1)


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"gn_conv: {what} must be {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"gn_conv: {what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"gn_conv: {what} data is not 16-byte aligned")


def _launch(name: str, mode: int, bm: int, xh: torch.Tensor, wp: torch.Tensor,
            b: torch.Tensor, out_hw: Tuple[int, int], mul=None, add=None, emb=None,
            res=None, lrelu: bool = False) -> torch.Tensor:
    """One kernel launch. ``xh``: NHWC view of the input; returns the
    (B, Cout, H, W) channels-last output."""
    batch, _, _, cin = xh.shape
    h, wd = out_hw
    cout = wp.shape[2]
    dev = xh.device
    if dev.index != torch.cuda.current_device():  # the launch goes to the current device
        with torch.cuda.device(dev):
            return _launch(name, mode, bm, xh, wp, b, out_hw, mul, add, emb, res, lrelu)
    if cin % BK or cout % 64 or cin == 0 or cout == 0:
        raise ValueError(f"{name}: kernel takes Cin % {BK} == 0 and Cout % 64 == 0, "
                         f"got Cin {cin}, Cout {cout}")
    if xh.data_ptr() % 16:
        raise ValueError(f"{name}: input data is not 16-byte aligned")
    _check(wp, "w_packed", torch.bfloat16, (3, 3, cout, cin), dev)
    _check(b, "bias", torch.float32, (cout,), dev)
    if mul is not None:
        _check(mul, "mul", torch.float32, (batch, cin), dev)
        _check(add, "add", torch.float32, (batch, cin), dev)
    if emb is not None:
        _check(emb, "emb", torch.bfloat16, (batch, cout), dev)
    if res is not None:
        if tuple(res.shape) != (batch, h, wd, cout) or res.device != dev or res.data_ptr() % 16:
            raise ValueError(f"{name}: res must be (B, Cout, H, W) = "
                             f"{(batch, cout, h, wd)} on {dev}, 16-byte aligned")
    bn, tw, splits, per = plan(batch, h, wd, cin, cout, bm)
    out = torch.empty((batch, cout, h, wd), device=dev, dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    partial = (torch.empty((splits, batch * h * wd, cout), device=dev, dtype=torch.float32)
               if splits > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _symbol()(mode, bm, bn, tw, xh.data_ptr(), ptr(mul), ptr(add), wp.data_ptr(),
                    b.data_ptr(), ptr(emb), ptr(res), out.data_ptr(), ptr(partial),
                    _tile_counters(dev, stream).data_ptr(), batch, h, wd, cin, cout, splits,
                    per, int(lrelu), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launches[name] += 1
    return out


def _gn_silu_conv(x, mul, add, w, b, emb, res, w_packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_gn_silu_conv(x, mul, add, w, b, emb, res)
    batch, cin, h, wd = x.shape
    name = tier(h)
    wp = pack_weight(w, torch.bfloat16) if w_packed is None else w_packed
    cout = wp.shape[2]
    out = _launch(name, 0, 64 if name == "gn_conv_whole" else 128, _nhwc(x, "x"), wp,
                  b.float().contiguous(), (h, wd), mul=mul.float().contiguous(),
                  add=add.float().contiguous(),
                  emb=None if emb is None else emb.to(torch.bfloat16).contiguous(),
                  res=None if res is None else _nhwc(res, "res"))
    shapes[(name, batch, cin, h, wd, cout, emb is not None, res is not None, None)] += 1
    return out


def _upsample_conv(x, w, b, act, w_packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_upsample_conv(x, w, b, act)
    if act not in (None, "lrelu"):
        raise ValueError(f"upsample_conv: act must be None or 'lrelu', got {act!r}")
    batch, cin, h, wd = x.shape
    wp = pack_weight(w, torch.bfloat16) if w_packed is None else w_packed
    out = _launch("upsample_conv", 1, 128, _nhwc(x, "x"), wp, b.float().contiguous(),
                  (2 * h, 2 * wd), lrelu=act == "lrelu")
    shapes[("upsample_conv", batch, cin, 2 * h, 2 * wd, wp.shape[2], False, False, act)] += 1
    return out


class _GnSiluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mul, add, w, b, emb, res, w_packed):
        ctx.save_for_backward(x, mul, add, w, b, emb, res)
        return _gn_silu_conv(x, mul, add, w, b, emb, res, w_packed)

    @staticmethod
    def backward(ctx, grad):
        return recompute_grads(ctx.needs_input_grad, plain_gn_silu_conv, grad,
                               ctx.saved_tensors) + (None,)


class _UpsampleConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, act, w_packed):
        ctx.save_for_backward(x, w, b)
        ctx.act = act
        return _upsample_conv(x, w, b, act, w_packed)

    @staticmethod
    def backward(ctx, grad):
        x, w, b = ctx.saved_tensors
        return recompute_grads(ctx.needs_input_grad, plain_upsample_conv, grad,
                               (x, w, b, ctx.act)) + (None,)


def gn_silu_conv(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, emb: Optional[torch.Tensor] = None,
                 res: Optional[torch.Tensor] = None, *,
                 w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3(silu(x*mul + add)) + b [+ emb] [+ res]`` (pad 1): the
    ``gn_conv_whole``/``gn_conv_band`` kernel on CUDA tensors,
    :func:`plain_gn_silu_conv` on CPU tensors; differentiable (the plain
    version's gradients). ``w_packed``: the bf16 :func:`pack_weight` of
    ``w`` (made here, per call, when not given)."""
    return _GnSiluConv.apply(x, mul, add, w, b, emb, res, w_packed)


def upsample_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  act: Optional[str] = None, *,
                  w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(conv3x3(nearest2x(x)) + b)`` (pad 1), (B, Cin, H, W) ->
    (B, Cout, 2H, 2W): the ``upsample_conv`` kernel on CUDA tensors,
    :func:`plain_upsample_conv` on CPU tensors; differentiable (the plain
    version's gradients)."""
    return _UpsampleConv.apply(x, w, b, act, w_packed)
