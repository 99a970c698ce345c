"""Fused GroupNorm+SiLU+conv3x3 and nearest-2x+conv3x3: Hopper kernels and
their plain PyTorch versions.

Counterpart of ``edtr_tpu/ops/gn_conv.py``. Each JAX Pallas kernel has one
wrapper here, with its own launch count:

  ==============  ==========================================  ===================
  wrapper         replaces (edtr_tpu/ops/gn_conv.py)          CUDA kernel
  ==============  ==========================================  ===================
  gn_conv_whole   ``_call`` (``_kernel_{plain,emb,res,         gnconv_wgmma_kernel
                  emb_res}``), the whole-image tier: H < 16
  gn_conv_band    ``_band_call`` (``_band_*``), the row-band   gnconv_wgmma_kernel
                  tier: H >= 16
  upsample_conv   ``upsample_conv`` (``_ups_kernel``)          upconv_wgmma_kernel
  ==============  ==========================================  ===================

:func:`gn_silu_conv` picks the tier by JAX's rule in ``_call`` (``h >= 16``
-> band). The kernels are built from ``edtr_torch/csrc/gn_conv.cu`` (see
the headers of ``csrc/gnconv_wgmma.cuh`` and ``csrc/conv_wgmma.cuh`` for
the designs). One wgmma implicit-GEMM kernel fed by TMA serves both
GroupNorm tiers: a block loads each 64-channel chunk's halo once,
activates its pixels inside the image once, in place (TMA's zero fill is
the conv's padding), reads it at a shifted offset for every tap, and
streams the weights through an mbarrier ring; 8 x 8 output tiles (one 8²
image) for the whole-image tier, 16 x 8 otherwise (:func:`gn_plan`). The
nearest-2x conv is a phase-folded wgmma implicit GEMM at low resolution:
each output phase (2i+a, 2j+b) is a 2x2 conv of the input with folded taps
(:func:`fold_subpixel_weights`, JAX's ``_fold_subpixel_weights``), 4 of
the 9 taps' work. ``python3 proj_bench.py --conv`` times both at the fused
restore's shapes.

Tensors are NCHW at this interface, as in the port's modules. The kernels
read and write channels-last memory (``torch.channels_last``: physically
NHWC), which the fused modules keep from their first layer on; a CUDA input
in another layout is copied once and counted in :data:`layout_copies`.
Weights are the module's fp32 OIHW ``w`` for the plain version; the kernels
read ``w_packed``, a bf16 copy that ``models/layers.py:Conv2d`` caches until
the weight changes: (3, 3, Cout, Cin) for the GroupNorm conv
(:func:`pack_weight`, ``Conv2d.packed_weight``), the folded (4, 2, 2, Cout,
Cin) for the nearest-2x conv (:func:`fold_subpixel_weights`,
``Conv2d.folded_weight``).

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches its kernel or raises. The kernels take bf16 activations, fp32
``mul``/``add``/bias and Cout a multiple of 64; Cin a multiple of 64 (the
GroupNorm conv) or of 32 (the nearest-2x conv): :func:`gn_conv_takes` and
:func:`upsample_conv_takes`, which the launchers raise on and the routes
of ``models/layers.py`` read, sending what the kernels do not take to the
plain versions (JAX's ``gn_silu_conv`` and ``upsample_conv`` take ``_ref``
where no plan exists).

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
SMS = _cuda.SMS
# gnconv_wgmma.cuh: input channels a chunk; the stages of its halo ring and
# of its weight ring
GN_KC = 64
GN_RING = 3
GN_STAGES = 4
# conv_wgmma.cuh: input channels a chunk, output channels a block (each
# phase), and the block's dynamic shared memory (4 ring stages of two 8 KB
# windows and four 8 KB weight boxes, the output staging, the barriers)
UPS_KC = 64
UPS_BN = 64
UPS_SMEM = 1024 + 4 * (2 + 4) * 8192 + 8 * 512 + 2 * 4 * 8 + 16
SMEM_LIMIT = 232448

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


def fold_subpixel_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> (4 phases, 2, 2, out, in) phase-folded taps in
    ``dtype``, contiguous: ``conv3x3(nearest2x(x))`` at phase p = 2a+b,
    output pixel (2i+a, 2j+b), is the 2x2 conv of x at rows i+a-1, i+a and
    columns j+b-1, j+b with tap (dr, dc) = ``out[p, dr, dc]``. Nearest
    duplication sends two hi-res taps of an axis to one low-res pixel, so a
    tap is a sum of 1, 2 or 4 of w's:

      rows a=0: (w[0], w[1]+w[2])     a=1: (w[0]+w[1], w[2])
      cols b=0: (k[0], k[1]+k[2])     b=1: (k[0]+k[1], k[2])

    summed in fp32 rows first, then columns, as JAX's
    ``_fold_subpixel_weights`` sums them (the same fp32 values), and rounded
    once to ``dtype``."""
    with torch.no_grad():
        w = w.detach().float()
        rows = {0: (w[:, :, 0], w[:, :, 1] + w[:, :, 2]),
                1: (w[:, :, 0] + w[:, :, 1], w[:, :, 2])}   # each (O, I, kw)
        phases = []
        for a in (0, 1):
            r = torch.stack(rows[a])                        # (dr, O, I, kw)
            for b in (0, 1):
                cols = ((r[..., 0], r[..., 1] + r[..., 2]) if b == 0
                        else (r[..., 0] + r[..., 1], r[..., 2]))
                phases.append(torch.stack(cols, 1))         # (dr, dc, O, I)
        return torch.stack(phases).to(dtype).contiguous()


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


def gn_conv_takes(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether ``gn_conv_whole``/``gn_conv_band``'s kernel takes an input of
    ``dtype`` with ``cin`` -> ``cout`` channels: bf16, both multiples of
    64."""
    return (dtype == torch.bfloat16 and cin > 0 and cout > 0 and cin % GN_KC == 0
            and cout % 64 == 0)


def upsample_conv_takes(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether ``upsample_conv``'s kernel takes an input of ``dtype`` with
    ``cin`` -> ``cout`` channels: bf16, Cin a multiple of 32 (TMA zero-fills
    a half chunk), Cout of :data:`UPS_BN`."""
    return (dtype == torch.bfloat16 and cin > 0 and cout > 0 and cin % 32 == 0
            and cout % UPS_BN == 0)


def tier(h: int) -> str:
    """The wrapper ``_call`` picks for an H-row image."""
    return "gn_conv_band" if h >= BAND_MIN_H else "gn_conv_whole"


# gnconv_wgmma.cuh's instances: (wn, th) -> the tile's output channels
GN_TILES = {(32, 8): 64, (64, 16): 64, (128, 16): 128, (160, 16): 160, (256, 16): 256}


def gn_split(b: int, h: int, w: int, cin: int, cout: int, wn: int,
             th: int) -> Tuple[int, int, int, int]:
    """``(wn, th, splits, chunks_per_split)`` with ``th`` x 8-pixel tiles of
    ``GN_TILES[wn, th]`` channels: the 64-channel chunks split across
    blocks when the tiles alone would leave SMs idle, with no empty split."""
    tiles = b * -(-h // th) * -(-w // 8) * (cout // GN_TILES[wn, th])
    chunks = cin // GN_KC
    splits = max(1, min(SMS // tiles, chunks)) if tiles < SMS else 1
    per = -(-chunks // splits)
    return wn, th, -(-chunks // per), per


@functools.lru_cache(maxsize=None)
def gn_plan(b: int, h: int, w: int, cin: int, cout: int,
            name: str) -> Tuple[int, int, int, int]:
    """``(wn, th, splits, chunks_per_split)`` of a ``gn_conv_whole`` /
    ``gn_conv_band`` (``name``) launch over a (b, h, w) output, from
    ``gnconv_wgmma_kernel``'s instances (:data:`GN_TILES`). The whole-image
    tier takes 8 x 8 tiles whose two warpgroups split 64 channels (wn 32:
    the most tiles for the fewest splits of its weight-bound 8² sites). The
    row band takes 16 x 8 tiles, a warpgroup each 8 x 8 pixels and all wn
    channels: 256 where that still gives a tile to every SM (the halo's
    activation and the weights' trips from L2 are shared by twice the
    products), else 128, 160 or 64, the first that divides Cout. Then
    :func:`gn_split`. (Measured on the card at every main-path shape by
    ``proj_bench.py --conv --plans``; PERF.md.)"""
    if name == "gn_conv_whole":
        return gn_split(b, h, w, cin, cout, 32, 8)
    tiles = b * -(-h // 16) * -(-w // 8)
    wn = (256 if cout % 256 == 0 and tiles * (cout // 256) >= SMS
          else next(n for n in (128, 160, 64) if cout % n == 0))
    return gn_split(b, h, w, cin, cout, wn, 16)


def gn_smem(wn: int, th: int) -> int:
    """Dynamic shared-memory bytes of a ``gnconv_wgmma_kernel`` block
    (``Tile<WN, SPLITN>::SMEM`` there): the alignment slack, the
    :data:`GN_STAGES` weight stages (the tile's channels x 64), the
    three-stage halo ring (8 channel groups of (th + 2) x 10 pixels, each
    padded to 128 bytes), the output staging and the barriers."""
    halo = 8 * (-(-((th + 2) * 10 * 16) // 128) * 128)
    return (1024 + GN_STAGES * GN_TILES[wn, th] * GN_KC * 2 + GN_RING * halo + 8 * 16 * 16 * 2
            + (3 * GN_RING + 2 * GN_STAGES) * 8 + 16)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """Multiprocessors of device ``index``: the most blocks a
    ``gnconv_wgmma_kernel`` launch takes (one an SM, walking its items)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def ups_plan(b: int, h: int, w: int, cin: int, cout: int) -> Tuple[int, int, int]:
    """``(tw, splits, chunks_per_split)`` of an ``upsample_conv`` launch over
    a (b, h, w) LOW-res input: 8 x 16 low-res tiles (two 8 x 8 halves side
    by side), 16 x 8 for inputs at most 8 wide; :data:`UPS_BN` output
    channels a block; the 64-channel chunks split across blocks when the
    tiles alone would leave SMs idle, with no empty split."""
    tw = 16 if w > 8 else 8
    th = 128 // tw
    tiles = b * -(-h // th) * -(-w // tw) * (cout // UPS_BN)
    chunks = -(-cin // UPS_KC)
    splits = max(1, min(SMS // tiles, chunks)) if tiles < SMS else 1
    per = -(-chunks // splits)
    return tw, -(-chunks // per), per


@functools.lru_cache(maxsize=None)
def _symbol(name: str):
    lib = _cuda.load("gn_conv")
    if name == "gn_conv":
        fn = lib.edtr_gn_conv
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    else:
        fn = lib.edtr_upsample_conv
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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


def _launch(name: str, xh: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
            mul: torch.Tensor, add: torch.Tensor, emb=None, res=None) -> torch.Tensor:
    """One GroupNorm-conv launch. ``xh``: NHWC view of the input; returns
    the (B, Cout, H, W) channels-last output."""
    batch, h, wd, cin = xh.shape
    cout = wp.shape[2]
    dev = xh.device
    if dev.index != torch.cuda.current_device():  # the launch goes to the current device
        with torch.cuda.device(dev):
            return _launch(name, xh, wp, b, mul, add, emb, res)
    if not gn_conv_takes(xh.dtype, cin, cout):
        raise ValueError(f"{name}: kernel takes bf16 with Cin % {GN_KC} == 0 and Cout % 64 "
                         f"== 0, got {xh.dtype}, Cin {cin}, Cout {cout}")
    if xh.data_ptr() % 16:
        raise ValueError(f"{name}: input data is not 16-byte aligned")
    _check(wp, "w_packed", torch.bfloat16, (3, 3, cout, cin), dev)
    _check(b, "bias", torch.float32, (cout,), dev)
    _check(mul, "mul", torch.float32, (batch, cin), dev)
    _check(add, "add", torch.float32, (batch, cin), dev)
    if emb is not None:
        _check(emb, "emb", torch.bfloat16, (batch, cout), dev)
    if res is not None:
        if tuple(res.shape) != (batch, h, wd, cout) or res.device != dev or res.data_ptr() % 16:
            raise ValueError(f"{name}: res must be (B, Cout, H, W) = "
                             f"{(batch, cout, h, wd)} on {dev}, 16-byte aligned")
    wn, th, splits, per = gn_plan(batch, h, wd, cin, cout, name)
    out = torch.empty((batch, cout, h, wd), device=dev, dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    partial = (torch.empty((splits, batch * h * wd, cout), device=dev, dtype=torch.float32)
               if splits > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    counters = _cuda.arrival_counters(dev, stream)
    err = _symbol("gn_conv")(wn, th, xh.data_ptr(), mul.data_ptr(), add.data_ptr(),
                             wp.data_ptr(), b.data_ptr(), ptr(emb), ptr(res), out.data_ptr(),
                             ptr(partial), counters.data_ptr(), batch, h, wd, cin, cout, splits,
                             per, _sms(dev.index), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (error {err})")
    launches[name] += 1
    return out


def _launch_ups(xh: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
                lrelu: bool) -> torch.Tensor:
    """One ``upsample_conv`` launch. ``xh``: NHWC view of the low-res input;
    ``wp``: the folded weights; returns the (B, Cout, 2H, 2W) channels-last
    output."""
    batch, h, wd, cin = xh.shape
    cout = wp.shape[3]
    dev = xh.device
    if dev.index != torch.cuda.current_device():  # the launch goes to the current device
        with torch.cuda.device(dev):
            return _launch_ups(xh, wp, b, lrelu)
    if not upsample_conv_takes(xh.dtype, cin, cout):
        raise ValueError(f"upsample_conv: kernel takes bf16 with Cin % 32 == 0 and Cout % "
                         f"{UPS_BN} == 0, got {xh.dtype}, Cin {cin}, Cout {cout}")
    if xh.data_ptr() % 16:
        raise ValueError("upsample_conv: input data is not 16-byte aligned")
    _check(wp, "w_packed (fold_subpixel_weights)", torch.bfloat16, (4, 2, 2, cout, cin), dev)
    _check(b, "bias", torch.float32, (cout,), dev)
    tw, splits, per = ups_plan(batch, h, wd, cin, cout)
    out = torch.empty((batch, cout, 2 * h, 2 * wd), device=dev, dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    partial = (torch.empty((splits, batch * 4 * h * wd, cout), device=dev,
                           dtype=torch.float32) if splits > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _cuda.arrival_counters(dev, stream)
    err = _symbol("upsample_conv")(
        tw, xh.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), counters.data_ptr(),
        batch, h, wd, cin, cout, splits, per, int(lrelu), stream)
    if err != 0:
        raise RuntimeError(f"upsample_conv: CUDA launch failed (cudaError {err})")
    launches["upsample_conv"] += 1
    return out


def _gn_silu_conv(x, mul, add, w, b, emb, res, w_packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_gn_silu_conv(x, mul, add, w, b, emb, res)
    batch, cin, h, wd = x.shape
    name = tier(h)
    wp = pack_weight(w, torch.bfloat16) if w_packed is None else w_packed
    cout = wp.shape[2]
    out = _launch(name, _nhwc(x, "x"), wp,
                  b.float().contiguous(), mul.float().contiguous(), add.float().contiguous(),
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
    wp = fold_subpixel_weights(w, torch.bfloat16) if w_packed is None else w_packed
    out = _launch_ups(_nhwc(x, "x"), wp, b.float().contiguous(), act == "lrelu")
    shapes[("upsample_conv", batch, cin, 2 * h, 2 * wd, out.shape[1], False, False, act)] += 1
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
    version's gradients). ``w_packed``: the bf16
    :func:`fold_subpixel_weights` of ``w`` (made here, per call, when not
    given)."""
    return _UpsampleConv.apply(x, w, b, act, w_packed)
