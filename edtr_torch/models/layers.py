"""Shared building blocks of the port (NCHW, fp32 params, compute dtype).

Counterpart of ``edtr_tpu/models/layers.py``:

* ``timestep_embedding``: sinusoidal, ``[cos | sin]`` order;
* ``GroupNorm32``: two-pass fp32 statistics folded into a per-(B, C)
  ``(mul, add)`` and applied in fp32, cast back to the input dtype;
* ``LayerNorm``: fp32 torch semantics, cast back;
* ``Linear``/``Conv2d``: fp32 params, computed like flax ``Dense``/``Conv``
  with a ``dtype``: input and weight cast to the compute dtype, product
  accumulated in fp32 and rounded, then the bias added in the compute dtype;
* ``norm_silu_conv`` / ``upsample_conv3x3``: the ResBlock half and the
  nearest-2x conv of ``edtr_tpu/ops/gn_conv.py``, as stock PyTorch ops (the
  plain versions) or, inside a :func:`fused_conv` block, through the port's
  conv kernels (``edtr_torch/ops/gn_conv.py``), which read channels-last
  activations (:func:`to_conv_layout`) and the bf16 weight copies
  ``Conv2d.packed_weight`` (ResBlock halves) and ``Conv2d.folded_weight``
  (nearest-2x convs, phase-folded) cache;
* :func:`fused_proj`: the projection configuration, read by
  ``models/attention.py``: inside the block the transformer blocks' LN+q/k/v,
  LN+GEGLU and GroupNorm-affine+``proj_in`` run through the port's
  projection kernels (``edtr_torch/ops/{ln_matmul,geglu}.py``) on the bf16
  weight copies ``Linear.packed_weight`` caches;
* :func:`fused_swin`: the Swin configuration, read by ``models/swinir.py``:
  inside the block every SwinIR transformer block runs as the port's three
  Swin kernels (``edtr_torch/ops/{swin_block,window_attention}.py``) in
  rolled token space;
* :func:`remat`: JAX's ``remat`` ("full" policy) on
  ``torch.utils.checkpoint``, its recompute run in the configuration of
  its forward.

Parameter names follow the reference torch state dicts (``weight``/
``bias``, OIHW conv kernels, (out, in) linear kernels).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from edtr_torch.ops import attention as attention_ops
from edtr_torch.ops import gn_conv, swin_block
from edtr_torch.ops._norms import fold_from_moments, gn_stats, ln_f32
from edtr_torch.parallel.mesh import DTensor, is_sharded

_fused_conv = False
_fused_proj = False
_fused_swin = False


@contextlib.contextmanager
def fused_conv(on: bool = True) -> Iterator[None]:
    """The conv configuration of every call inside the block (JAX's
    ``ResBlock.fused`` with the gn_conv families forced on, for all blocks at
    once): on, :func:`norm_silu_conv` and :func:`upsample_conv3x3` run
    through the port's conv kernels and the networks keep their activations
    channels-last (:func:`to_conv_layout`); off, and outside any block, they
    are stock PyTorch ops. ``EDTRPipeline`` sets it around each stage."""
    global _fused_conv
    prev, _fused_conv = _fused_conv, bool(on)
    try:
        yield
    finally:
        _fused_conv = prev


@contextlib.contextmanager
def fused_proj(on: bool = True) -> Iterator[None]:
    """The projection configuration of every call inside the block (JAX's
    transformer blocks with the geglu and ln_matmul families forced on): on,
    each transformer block at a token count the kernels take runs its
    LN+q/k/v, LN+query, LN+GEGLU and GroupNorm-affine+``proj_in`` through
    the port's projection kernels; off, and outside any block, they are
    stock PyTorch ops. ``EDTRPipeline`` sets it around each stage."""
    global _fused_proj
    prev, _fused_proj = _fused_proj, bool(on)
    try:
        yield
    finally:
        _fused_proj = prev


def fused_proj_on() -> bool:
    """Whether the call runs inside a :func:`fused_proj` block."""
    return _fused_proj


@contextlib.contextmanager
def fused_swin(on: bool = True) -> Iterator[None]:
    """The Swin configuration of every call inside the block (JAX's SwinIR
    with ``swin_block._FORCE_KERNEL`` and ``EDTR_WINDOW_ATTN=pallas``): on,
    each SwinIR transformer block on a token grid the kernels take runs as
    ``swin_pre`` + ``window_attention`` + ``swin_post`` in rolled token
    space; off, and outside any block, as stock PyTorch ops.
    ``EDTRPipeline`` sets it around each stage."""
    global _fused_swin
    prev, _fused_swin = _fused_swin, bool(on)
    try:
        yield
    finally:
        _fused_swin = prev


def fused_swin_on() -> bool:
    """Whether the call runs inside a :func:`fused_swin` block."""
    return _fused_swin


def remat(fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``fn(*args)`` with its activations recomputed in the backward
    instead of kept: ``edtr_tpu/models/layers.py:remat`` with the "full"
    policy, as ``torch.utils.checkpoint`` (non-reentrant). The switches are
    module globals and ``loss.backward()`` may run outside the blocks that
    set them, so the recompute re-enters the switches of the forward
    (conv, projection, Swin, attention's ``force_plain``): the same kernels,
    the same numerics, the same saved tensors. Without grad mode it is
    ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    conv, proj, swin = _fused_conv, _fused_proj, _fused_swin
    plain = attention_ops.force_plain_on()

    def run(*a):
        with fused_conv(conv), fused_proj(proj), fused_swin(swin), \
                attention_ops.force_plain(plain):
            return fn(*a)
    return checkpoint(run, *args, use_reentrant=False)


class DerivedWeight:
    """A tensor made from some parameters (a cast, a packing, a
    concatenation), made once and made again when one of them is changed
    in place (its version) or replaced (its storage or its dtype, as a
    cast of the stored weights replaces them)."""

    def __init__(self):
        self.key: Optional[tuple] = None
        self.value: Optional[torch.Tensor] = None

    def get(self, params: Sequence[torch.Tensor], dtype: torch.dtype,
            make: Callable[[Sequence[torch.Tensor], torch.dtype], torch.Tensor]
            ) -> Optional[torch.Tensor]:
        """``make(params, dtype)``, from the cache while no param changed;
        None where tensor parallelism shards one of them (a DTensor): the
        kernel's wrapper then makes it from the gathered weight
        (:func:`whole`) per call."""
        if any(is_sharded(p) for p in params):
            return None
        key = tuple((p.data_ptr(), p._version, p.device, p.dtype) for p in params) + (dtype,)
        if self.key != key:
            with torch.no_grad():
                self.value = make([p.detach() for p in params], dtype)
            self.key = key
        return self.value


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """(B,) -> (B, dim) fp32 sinusoidal embedding, ``[cos | sin]``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor,
                   w: torch.Tensor) -> torch.dtype:
    # flax: an explicit dtype wins, else the promotion of input and params
    return dtype or torch.promote_types(x.dtype, w.dtype)


def concat_weights(ws: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """Linear weights of one input width stacked, (sum of outs, in), in
    ``dtype``: the operand of the projection kernels."""
    return torch.cat([w.to(dtype) for w in ws])


def _pack_conv(ws: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return gn_conv.pack_weight(ws[0], dtype)


def _fold_conv(ws: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return gn_conv.fold_subpixel_weights(ws[0], dtype)


def _pad_linear(ws: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return swin_block.pad_weight(ws[0], dtype)


def whole(w: torch.Tensor) -> torch.Tensor:
    """A weight as one local tensor: gathered (differentiably) where tensor
    parallelism stores it sharded, as a DTensor
    (``edtr_torch/parallel/tp.py``), else ``w`` itself. Activations stay
    local tensors throughout."""
    return w.full_tensor() if type(w) is DTensor else w


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        nn.init.normal_(self.weight, std=in_features ** -0.5)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self._packed = DerivedWeight()
        self._padded = DerivedWeight()

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight in ``dtype`` as the projection kernels read it ((out,
        in), contiguous), kept until the weight changes."""
        return self._packed.get((self.weight,), dtype, concat_weights)

    def padded_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """:meth:`packed_weight` zero-padded along ``in`` to a multiple of 64
        (``swin_block.pad_weight``), as the ``swin_pre`` kernel reads the
        qkv weight; kept as :meth:`packed_weight` is."""
        return self._padded.get((self.weight,), dtype, _pad_linear)

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x @ W.T + b``, W the stored weight (gathered where it is
        sharded). ``weight``: a local tensor in place of W and no bias
        (this rank's rows or columns under tensor parallelism: the caller
        adds the bias once the ranks' outputs are summed)."""
        w = whole(self.weight) if weight is None else weight
        dt = _compute_dtype(self.dtype, x, w)
        y = F.linear(x.to(dt), w.to(dt))
        if self.bias is not None and weight is None:
            y = y + self.bias.to(dt)
        return y


class Conv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, groups: int = 1, dilation: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding = stride, padding
        self.groups, self.dilation = groups, dilation
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        nn.init.normal_(self.weight, std=(in_channels // groups * kernel_size ** 2) ** -0.5)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self._packed = DerivedWeight()
        self._folded = DerivedWeight()

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight as the GroupNorm-conv kernels read it
        (``gn_conv.pack_weight``: (kh, kw, out, in) in ``dtype``), made once
        and kept until the weight is changed in place (its version) or
        replaced (its storage)."""
        return self._packed.get((self.weight,), dtype, _pack_conv)

    def folded_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The 3x3 weight as the nearest-2x conv kernel reads it
        (``gn_conv.fold_subpixel_weights``: (4 phases, 2, 2, out, in) in
        ``dtype``), kept as :meth:`packed_weight` is."""
        return self._folded.get((self.weight,), dtype, _fold_conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        y = F.conv2d(x.to(dt), whole(self.weight).to(dt), None, self.stride, self.padding,
                     self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 two-pass statistics; eps 1e-5 (UNet) or 1e-6
    (VAE, SpatialTransformer).

    The tiled VAE's GroupNorm sync (JAX's ``gn_stats`` / ``gn_moments``
    collections; :func:`edtr_torch.utils.tiling.gn_sync` sets these): with
    ``record`` set, each call keeps its input's own per-(B, G) ``(count,
    sum, sumsq)`` in ``recorded``, the last call's (JAX's ``reduce_fn=
    lambda a, b: b``), also while moments are injected; with ``moments``
    set, ``(mean_g, var_g)`` normalise in place of the call's own
    statistics. Either way the fold (:meth:`fold`) feeds the same affine
    path, the conv kernels' included."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.record = False
        self.recorded: Optional[Tuple[float, torch.Tensor, torch.Tensor]] = None
        self.moments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def fold(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C) fp32 ``(mul, add)`` with ``x_f32 * mul + add`` = GN(x)."""
        mean_g, var_g = gn_stats(x, self.num_groups)
        if self.record:
            count = float(x[0].numel() // self.num_groups)
            self.recorded = (count, mean_g * count, (var_g + mean_g.square()) * count)
        if self.moments is not None:
            mean_g, var_g = self.moments
        return fold_from_moments(mean_g, var_g, self.weight, self.bias, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul, add = self.fold(x)
        shape = mul.shape + (1,) * (x.ndim - 2)
        return (x.float() * mul.view(shape) + add.view(shape)).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_f32(x, self.weight, self.bias, self.eps).to(x.dtype)


def conv_route(x: torch.Tensor, conv: Conv2d, upsample: bool = False) -> bool:
    """Whether a fused-configuration conv of ``x`` goes to its wrapper (a
    GroupNorm conv's, or with ``upsample`` the nearest-2x conv's): always on
    the CPU, where the wrapper is the plain version; elsewhere only where
    the kernel takes the call (``gn_conv.gn_conv_takes`` /
    ``upsample_conv_takes``), else the plain version, as JAX takes ``_ref``
    where no kernel plan exists. A weight that tensor parallelism shards
    goes to the wrapper gathered (:func:`whole`)."""
    if x.device.type == "cpu":
        return True
    takes = gn_conv.upsample_conv_takes if upsample else gn_conv.gn_conv_takes
    return takes(x.dtype, x.shape[1], conv.weight.shape[0])


def norm_silu_conv(x: torch.Tensor, norm: GroupNorm32, conv: Conv2d,
                   emb: Optional[torch.Tensor] = None,
                   res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3(silu(GN(x))) + b [+ emb] [+ res]`` with the casts of
    ``gn_conv._ref``: affine in fp32, cast to x's dtype, SiLU and conv in
    that dtype, bias/emb/res added in that dtype. GroupNorm statistics are
    stock ops either way; under :func:`fused_conv` the rest is one kernel
    where it takes the call (:func:`conv_route`)."""
    mul, add = norm.fold(x)
    if _fused_conv and conv_route(x, conv):
        return gn_conv.gn_silu_conv(x, mul, add, whole(conv.weight), conv.bias, emb, res,
                                    w_packed=conv.packed_weight(x.dtype))
    return gn_conv.plain_gn_silu_conv(x, mul, add, whole(conv.weight), conv.bias, emb, res)


def upsample_conv3x3(x: torch.Tensor, conv: Conv2d,
                     act: Optional[str] = None) -> torch.Tensor:
    """``act(conv3x3(nearest2x(x)) + b)`` in x's dtype (act None or
    "lrelu"); under :func:`fused_conv`, one kernel where it takes the call
    (:func:`conv_route`)."""
    if _fused_conv and conv_route(x, conv, upsample=True):
        return gn_conv.upsample_conv(x, whole(conv.weight), conv.bias, act,
                                     w_packed=conv.folded_weight(x.dtype))
    return gn_conv.plain_upsample_conv(x, whole(conv.weight), conv.bias, act)


def to_conv_layout(x: torch.Tensor) -> torch.Tensor:
    """Channels-last memory under :func:`fused_conv`, kept from a network's
    first layer on (convs, adds and the token views preserve it); the stock
    path's tensors are left as they are."""
    return x.contiguous(memory_format=torch.channels_last) if _fused_conv else x


@torch.no_grad()
def randomize_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for runs without a checkpoint: every matrix
    and kernel (zero-initialised ones included, so the ControlNet and the
    UNet do real work) ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.05^2),
    biases and position tables ~ N(0, 0.05^2)."""
    for name, p in module.named_parameters():
        r = torch.randn(p.shape, generator=generator, device=p.device, dtype=p.dtype)
        if p.ndim >= 2 and not name.endswith("relative_position_bias_table"):
            p.copy_(r * (p[0].numel() ** -0.5))
        elif name.endswith("weight"):
            p.copy_(1.0 + 0.05 * r)
        else:
            p.copy_(0.05 * r)
    return module


@torch.no_grad()
def calibrate_unit_rms_(layers: Sequence[nn.Module], run: Callable[[], object]) -> None:
    """For seeded random weights: during ``run()``, each of ``layers``
    (:class:`Conv2d`, :class:`Linear`), at its first call, divides its
    weight and bias by the root mean square of its output, which then goes
    on at unit RMS, so the layers that follow see O(1) signals, as trained
    weights give them. ``randomize_``'s N(0, 1/fan_in) kernels halve a
    signal's power at each ReLU, so a deep random net's output comes to
    depend on its biases more than on its input."""
    done = set()

    def unit_rms(layer, args, out):
        if layer in done:
            return None
        done.add(layer)
        r = out.float().square().mean().sqrt()
        layer.weight.div_(r)
        if layer.bias is not None:
            layer.bias.div_(r)
        return out / r

    hooks = [m.register_forward_hook(unit_rms) for m in layers]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
