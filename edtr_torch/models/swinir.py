"""SwinIR, the pre-restoration network of the EDTR flagship (NCHW in and out).

Counterpart of ``edtr_tpu/models/swinir.py``. EDTR's form: reflect pad
to the window multiple, pixel-unshuffle x``sf`` before ``conv_first``, RSTB
groups of shifted-window blocks over (B, N, C) tokens, then the
``nearest+conv`` tail (three nearest-2x + conv3x3 + LeakyReLU 0.2; inside a
``layers.fused_conv`` block, each one launch of the port's upsample-conv
kernel on channels-last activations). JAX's other forms are here too
(:class:`SwinIR`): the classical ``pixelshuffle`` tail, the residual
denoise form, no unshuffle, other ``in_chans`` and ``img_range``. Stock, a block is the module path of
JAX's ``SwinTransformerBlock`` with the plain window attention of
``edtr_torch/ops/window_attention.py`` (JAX's ``_xla_reference``, its
default). Inside a ``layers.fused_swin`` block it is JAX's fused branch:
``swin_pre`` (LN1 + roll + qkv + partition), ``window_attention`` on the
q/k/v slices of the packed windows and ``swin_post`` (reverse + proj + LN2
+ MLP, both residuals), tokens kept rolled from block to block and
un-rolled once before each RSTB's conv (``edtr_torch/ops/swin_block.py``);
on the card, a block the port's kernels do not take (:func:`swin_kernel_route`:
fp32 tokens, or the tiny flagship's window 4) runs the same three steps as
their plain versions, as JAX's Pallas kernels would run it. The
relative-position bias and the shift masks are made on the device once
(the bias again when its table changes), so a forward copies nothing from
the host.

The port is unpadded (C = 180, head dim 30): the JAX flagship's
``lane_pad`` is a TPU lane artefact; a lane-padded JAX tree loads through
``edtr_torch.utils.convert.strip_swinir_lanes``.

Parameter names are the reference state-dict keys (``conv_first.1`` or
``conv_first``, ``patch_embed.norm``,
``layers.{i}.residual_group.blocks.{j}.attn.qkv``,
``conv_before_upsample.0``, ``conv_up1``, ``upsample.{0,2,4}``), read by
``edtr_tpu/utils/convert.py:convert_swinir``. The reference's
``relative_position_index`` and ``attn_mask`` buffers are computed, not
stored.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.models.layers import (Conv2d, DerivedWeight, LayerNorm, Linear,
                                      fused_swin_on, to_conv_layout, upsample_conv3x3)
from edtr_torch.ops import swin_block
from edtr_torch.ops.swin_block import roll2d, window_partition, window_reverse
from edtr_torch.ops import window_attention as window_attention_ops
from edtr_torch.ops.window_attention import plain_window_attention, window_attention

RGB_MEAN = (0.4488, 0.4371, 0.4040)


@lru_cache(maxsize=8)
def relative_position_index(win: int) -> np.ndarray:
    """Swin relative-position index, (win², win²)."""
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return rel.sum(-1)


@lru_cache(maxsize=16)
def shift_attention_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """Additive (-100 / 0) mask of the shifted windows, (nW, win², win²)."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // win, win, w // win, win, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, win * win)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=16)
def shift_mask(h: int, w: int, win: int, shift: int, device: torch.device) -> torch.Tensor:
    """:func:`shift_attention_mask` on ``device``, made once per shape."""
    return torch.as_tensor(shift_attention_mask(h, w, win, shift), device=device)


@lru_cache(maxsize=16)
def _rel_index(win: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(relative_position_index(win).reshape(-1), device=device)


def rel_pos_bias(table: torch.Tensor, win: int) -> torch.Tensor:
    """(H, win², win²) fp32 additive logit bias from the ((2 win - 1)², H)
    table."""
    n = win * win
    return table[_rel_index(win, table.device)].reshape(n, n, -1).permute(2, 0, 1).float()


class WindowAttention(nn.Module):
    def __init__(self, dim: int, win: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.win, self.num_heads = win, num_heads
        self.qkv = Linear(dim, dim * 3, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * win - 1) ** 2, num_heads) * 0.02)
        self.proj = Linear(dim, dim, dtype=dtype)
        self._bias = DerivedWeight()

    def bias(self) -> torch.Tensor:
        """:func:`rel_pos_bias` of the table, contiguous, kept until the
        table changes (made anew on every call that differentiates it)."""
        table = self.relative_position_bias_table
        if torch.is_grad_enabled() and table.requires_grad:
            return rel_pos_bias(table, self.win).contiguous()
        return self._bias.get((table,), torch.float32,
                              lambda ps, _: rel_pos_bias(ps[0], self.win).contiguous())

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        bw, n, c = x.shape
        d = c // self.num_heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, self.num_heads, d).unbind(2)
        out = plain_window_attention(q, k, v, self.bias(), mask, d ** -0.5)
        return self.proj(out.reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, win: int, shift: int,
                 mlp_ratio: float = 2.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.win, self.shift = win, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, win, num_heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def out_offset(self, h: int, w: int) -> int:
        """The roll of this block's output tokens in the fused path: its
        shift, which applies only where the grid is larger than a window."""
        return self.shift if min(h, w) > self.win else 0

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int],
                in_offset: int = 0) -> torch.Tensor:
        """(B, h*w, C) tokens, rolled by ``in_offset`` (fused path only), to
        the block's output: un-rolled on the stock path, rolled by
        :meth:`out_offset` on the fused one."""
        h, w = x_size
        shift = self.out_offset(h, w)
        if fused_swin_on() and swin_block.supported(h, w, self.win):
            return self._fused(x, h, w, shift, in_offset)
        if in_offset:
            raise ValueError("the stock Swin block takes un-rolled tokens")
        b, n, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(h, w, self.win, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, self.win), mask), self.win, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(b, n, c)
        return x + self.mlp(self.norm2(x))

    def _fused(self, x: torch.Tensor, h: int, w: int, shift: int,
               in_offset: int) -> torch.Tensor:
        """JAX's fused branch (``edtr_tpu/models/swinir.py``
        ``SwinTransformerBlock``): three kernels on CUDA tensors where they
        take the block (:func:`swin_kernel_route`), their plain versions
        otherwise and on CPU tensors."""
        attn, mlp, dt = self.attn, self.mlp, x.dtype
        b, _, c = x.shape
        n, heads = self.win * self.win, attn.num_heads
        mask = shift_mask(h, w, self.win, shift, x.device) if shift else None
        pre_args = (x, self.norm1.weight, self.norm1.bias, attn.qkv.weight, attn.qkv.bias, h, w,
                    self.win, shift - in_offset, self.norm1.eps)
        post_args = (attn.proj.weight, attn.proj.bias, self.norm2.weight, self.norm2.bias,
                     mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias, h, w, self.win,
                     self.norm2.eps)
        if not swin_kernel_route(x, h, w, self.win, mlp.fc1.weight.shape[0], heads):
            qkv, xr = swin_block.plain_swin_pre(*pre_args)
            q, k, v = qkv.view(-1, n, 3, heads, c // heads).unbind(2)
            out = plain_window_attention(q, k, v, attn.bias(), mask, (c // heads) ** -0.5)
            return swin_block.plain_swin_post(out.reshape(b, -1, n, c), xr, *post_args)
        qkv, xr = swin_block.swin_pre(*pre_args, w_packed=attn.qkv.padded_weight(dt))
        q, k, v = qkv.view(-1, n, 3, heads, c // heads).unbind(2)
        out = window_attention(q, k, v, attn.bias(), mask, (c // heads) ** -0.5)
        lins = (attn.proj, mlp.fc1, mlp.fc2)
        return swin_block.swin_post(out.reshape(b, -1, n, c), xr, *post_args,
                                    packed=[lin.padded_weight(dt) for lin in lins])


def swin_kernel_route(x: torch.Tensor, h: int, w: int, win: int, hidden: int,
                      heads: int) -> bool:
    """Whether a fused Swin block over (B, h*w, C) tokens ``x`` goes to the
    three kernel wrappers: always on the CPU, where the wrappers are the
    plain versions; elsewhere only where ``swin_pre``, ``window_attention``
    and ``swin_post`` all take it (``swin_block.swin_pre_takes`` /
    ``swin_post_takes``, ``window_attention.kernel_takes``), else their
    plain versions in the same rolled token space."""
    if x.device.type == "cpu":
        return True
    c = x.shape[2]
    return (c % heads == 0 and swin_block.swin_post_takes(x.dtype, h, w, win, c, hidden)
            and window_attention_ops.kernel_takes(x.dtype, win * win, c // heads, heads))


class _ResidualGroup(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin group + trailing conv3x3."""

    def __init__(self, dim: int, depth: int, num_heads: int, win: int,
                 mlp_ratio: float = 2.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.residual_group = _ResidualGroup(
            SwinTransformerBlock(dim, num_heads, win, 0 if j % 2 == 0 else win // 2,
                                 mlp_ratio, dtype) for j in range(depth))
        self.conv = Conv2d(dim, dim, 3, padding=1, dtype=dtype)
        self.win = win

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        """The blocks, all on the stock or all on the fused path (the same
        rule for each), then the conv; on the fused path each block takes its
        predecessor's rolled tokens and the last roll is undone here."""
        h, w = x_size
        fused = fused_swin_on() and swin_block.supported(h, w, self.win)
        res, off = x, 0
        if fused:  # the kernels read contiguous tokens; a strided view is copied once
            x = x.contiguous()
        for blk in self.residual_group.blocks:
            x = blk(x, x_size, off)
            off = blk.out_offset(h, w) if fused else 0
        x = roll2d(x, -off, h, w)
        b, n, c = x.shape
        y = self.conv(x.transpose(1, 2).reshape(b, c, *x_size))
        return res + y.flatten(2).transpose(1, 2)  # in res's memory layout


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


class SwinIR(nn.Module):
    """SwinIR under the reference constructor's arguments (JAX's
    ``SwinIR`` fields; ``img_size``, ``patch_size``, ``qkv_bias``,
    ``qk_scale``, the dropouts, ``ape``, ``use_checkpoint``, the keys and
    the optimiser settings are accepted and inert, as in JAX). The
    defaults are EDTR's variant (``unshuffle`` by ``sf``,
    ``upsampler="nearest+conv"``), where JAX's ``unshuffle`` defaults to
    False. ``upsampler``: ``"nearest+conv"``, ``"pixelshuffle"`` (``sf``
    2, 4 or 8: conv + pixel shuffle x2 stages, the reference's
    ``upsample.{0,2,4}``) or anything else for the residual denoise form
    (the output added to the input, no upsampling). Without ``unshuffle``
    the input pads to the window only and ``conv_first`` reads it as it
    is. ``in_chans`` other than 3 takes no RGB mean; ``img_range`` scales
    the input's deviation from it. ``resi_connection`` must be "1conv", as
    JAX asserts."""

    def __init__(self, embed_dim: int = 180, depths: Sequence[int] = (6,) * 8,
                 num_heads: Sequence[int] = (6,) * 8, window_size: int = 8,
                 mlp_ratio: float = 2.0, sf: int = 8, dtype: Optional[torch.dtype] = None,
                 in_chans: int = 3, img_range: float = 1.0, upsampler: str = "nearest+conv",
                 resi_connection: str = "1conv", unshuffle: bool = True,
                 unshuffle_scale: Optional[int] = None, patch_norm: bool = True,
                 img_size: int = 64, patch_size: int = 1, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1, ape: bool = False,
                 use_checkpoint: bool = False, hq_key: str = "jpg", lq_key: str = "hint",
                 learning_rate: Optional[float] = None, weight_decay: Optional[float] = None):
        super().__init__()
        if resi_connection != "1conv":
            raise NotImplementedError(f"SwinIR resi_connection={resi_connection!r}: only "
                                      "'1conv' (JAX asserts the same)")
        self.dtype, self.window_size, self.sf = dtype, window_size, sf
        self.img_range, self.upsampler, self.unshuffle = img_range, upsampler, unshuffle
        self.unshuffle_scale = unshuffle_scale or sf
        num_feat = 64
        if unshuffle:  # JAX unshuffles by sf (and pads by unshuffle_scale)
            self.conv_first = nn.Sequential(
                nn.PixelUnshuffle(sf),
                Conv2d(in_chans * sf * sf, embed_dim, 3, padding=1, dtype=dtype))
        else:
            self.conv_first = Conv2d(in_chans, embed_dim, 3, padding=1, dtype=dtype)
        self.patch_embed = _PatchEmbed(embed_dim) if patch_norm else None
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, h, window_size, mlp_ratio, dtype)
            for d, h in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, padding=1, dtype=dtype)
        if upsampler in ("nearest+conv", "pixelshuffle"):
            self.conv_before_upsample = nn.Sequential(
                Conv2d(embed_dim, num_feat, 3, padding=1, dtype=dtype))
        if upsampler == "nearest+conv":
            self.conv_up1 = Conv2d(num_feat, num_feat, 3, padding=1, dtype=dtype)
            if sf >= 4:
                self.conv_up2 = Conv2d(num_feat, num_feat, 3, padding=1, dtype=dtype)
            if sf == 8:
                self.conv_up3 = Conv2d(num_feat, num_feat, 3, padding=1, dtype=dtype)
            self.conv_hr = Conv2d(num_feat, num_feat, 3, padding=1, dtype=dtype)
        elif upsampler == "pixelshuffle":
            stages = []
            for _ in range({2: 1, 4: 2, 8: 3}[sf]):
                stages += [Conv2d(num_feat, 4 * num_feat, 3, padding=1, dtype=dtype),
                           nn.PixelShuffle(2)]
            self.upsample = nn.Sequential(*stages)
        self.conv_last = Conv2d(num_feat if upsampler in ("nearest+conv", "pixelshuffle")
                                else embed_dim, in_chans, 3, padding=1, dtype=dtype)
        mean = RGB_MEAN if in_chans == 3 else (0.0,)
        self.register_buffer("mean", torch.tensor(mean).reshape(1, -1, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, in_chans, H, W) -> (B, in_chans, H * sf, W * sf) fp32 (the
        unshuffling form: (B, in_chans, H, W), padded to its multiple)."""
        H, W = x.shape[-2:]
        mult = self.window_size * (self.unshuffle_scale if self.unshuffle else 1)
        ph, pw = (mult - H % mult) % mult, (mult - W % mult) % mult
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = x - self.mean
        if self.img_range != 1:
            x = x * self.img_range
        x = x.to(self.dtype or x.dtype)

        feat = self.conv_first(x)
        b, c, h, w = feat.shape
        t = feat.flatten(2).transpose(1, 2)
        if self.patch_embed is not None:
            t = self.patch_embed.norm(t)
        for layer in self.layers:
            t = layer(t, (h, w))
        t = self.norm(t)
        feat = feat + self.conv_after_body(t.transpose(1, 2).reshape(b, c, h, w))

        if self.upsampler == "nearest+conv":
            feat = F.leaky_relu(self.conv_before_upsample[0](feat), 0.01)
            feat = to_conv_layout(feat)
            for name in ("conv_up1", "conv_up2", "conv_up3"):
                if hasattr(self, name):
                    feat = upsample_conv3x3(feat, getattr(self, name), "lrelu")
            out = self.conv_last(F.leaky_relu(self.conv_hr(feat), 0.2))
        elif self.upsampler == "pixelshuffle":
            feat = F.leaky_relu(self.conv_before_upsample[0](feat), 0.01)
            out = self.conv_last(self.upsample(feat))
        else:
            out = x + self.conv_last(feat)
        out = out.float()
        if self.img_range != 1:
            out = out / self.img_range
        out = out + self.mean
        return out[:, :, :H * self.sf, :W * self.sf]
