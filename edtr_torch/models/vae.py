"""SD KL-VAE (AutoencoderKL), NCHW.

Counterpart of ``edtr_tpu/models/vae.py``. GroupNorms use eps 1e-6 with fp32
statistics; the ResnetBlock halves follow ``gn_conv._ref`` (the skip add in
the second half's epilogue); Upsample is nearest-2x then conv3x3; Downsample
pads (0, 1, 0, 1) then convolves with stride 2. Inside a
``layers.fused_conv`` block the ResnetBlock halves and the Upsample convs
run through the port's conv kernels (``edtr_torch/ops/gn_conv.py``) on
channels-last activations. The
mid-block ``AttnBlock`` is single-head attention over the H*W tokens at
D = channels, which at 512² input (64² x 512) is the shape of the
streamed-KV flash kernel. The Decoder's ``use_checkpoint`` (JAX's decoder
remat, a training aid with no reference counterpart) puts each of its
ResnetBlocks under ``layers.remat``; ``train_decoder`` is the flag the
training step reads to train the decoder.

Parameter names are the reference state-dict keys (``encoder.down.0.block.1
.norm1``, ``encoder.mid.attn_1.q``, ``decoder.up.3.upsample.conv``,
``quant_conv``), read by ``edtr_tpu/utils/convert.py:convert_autoencoder_kl``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.device import resolve_device
from edtr_torch.models.distributions import DiagonalGaussianDistribution
from edtr_torch.models.layers import (Conv2d, GroupNorm32, norm_silu_conv, remat,
                                      to_conv_layout, upsample_conv3x3)
from edtr_torch.ops.attention import dot_product_attention


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                             if in_channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = norm_silu_conv(x.to(self.dtype or x.dtype), self.norm1, self.conv1)
        skip = self.nin_shortcut(x)
        return norm_silu_conv(h, self.norm2, self.conv2, res=skip.to(h.dtype))


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the H*W tokens."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = Conv2d(channels, channels, 1, dtype=dtype)
        self.k = Conv2d(channels, channels, 1, dtype=dtype)
        self.v = Conv2d(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)

        def tokens(t):  # (B, C, H, W) -> (B, HW, 1, C)
            return t.flatten(2).transpose(1, 2).unsqueeze(2)

        out = dot_product_attention(tokens(self.q(y)), tokens(self.k(y)),
                                    tokens(self.v(y)), scale=c ** -0.5)
        out = out.reshape(b, h * w, c).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_conv3x3(x.to(self.dtype or x.dtype), self.conv)


def _resnet(blk: ResnetBlock, h: torch.Tensor, use_checkpoint: bool) -> torch.Tensor:
    return remat(blk, h) if use_checkpoint else blk(h)


class _Mid(nn.Module):
    def __init__(self, ch: int, dtype: Optional[torch.dtype], use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.block_1 = ResnetBlock(ch, ch, dtype)
        self.attn_1 = AttnBlock(ch, dtype)
        self.block_2 = ResnetBlock(ch, ch, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.attn_1(_resnet(self.block_1, h, self.use_checkpoint))
        return _resnet(self.block_2, h, self.use_checkpoint)


class _Level(nn.Module):
    """One resolution: ``block`` resnets, then ``downsample``/``upsample``."""

    def __init__(self, blocks: Sequence[nn.Module], resample: Optional[nn.Module],
                 resample_name: str, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, resample_name, resample)
        self.resample_name = resample_name if resample is not None else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            h = _resnet(blk, h, self.use_checkpoint)
        if self.resample_name:
            h = getattr(self, self.resample_name)(h)
        return h


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3, z_channels: int = 4,
                 double_z: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, dtype=dtype)
        self.down = nn.ModuleList()
        block_in = ch
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, ch * mult, dtype))
                block_in = ch * mult
            last = i == len(ch_mult) - 1
            self.down.append(_Level(blocks, None if last else Downsample(block_in, dtype),
                                    "downsample"))
        self.mid = _Mid(block_in, dtype)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3,
                               padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(to_conv_layout(x.to(self.dtype or x.dtype)))
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, use_checkpoint: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1, dtype=dtype)
        self.mid = _Mid(block_in, dtype, use_checkpoint)
        levels = {}
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, ch * ch_mult[i], dtype))
                block_in = ch * ch_mult[i]
            levels[i] = _Level(blocks, Upsample(block_in, dtype) if i else None, "upsample",
                               use_checkpoint)
        self.up = nn.ModuleList(levels[i] for i in range(len(ch_mult)))
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(to_conv_layout(z.to(self.dtype or z.dtype))))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(h))).float()


class AutoencoderKL(nn.Module):
    def __init__(self, ddconfig: Optional[Dict[str, Any]] = None, embed_dim: int = 4,
                 train_decoder: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.train_decoder = bool(train_decoder)
        dd = dict(ddconfig or {})
        arch = dict(ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
                    num_res_blocks=dd.get("num_res_blocks", 2),
                    z_channels=dd.get("z_channels", 4), dtype=dtype)
        double_z = dd.get("double_z", True)
        self.encoder = Encoder(in_channels=dd.get("in_channels", 3), double_z=double_z,
                               **arch)
        self.decoder = Decoder(out_ch=dd.get("out_ch", 3),
                               use_checkpoint=dd.get("use_checkpoint", False), **arch)
        self.quant_conv = Conv2d(2 * arch["z_channels"] if double_z else arch["z_channels"],
                                 2 * embed_dim if double_z else embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, arch["z_channels"], 1, dtype=dtype)

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution(self.quant_conv(self.encoder(x)).float())

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


# the fields of JAX's ``Encoder`` that ``create_encoder`` keeps
ENCODER_FIELDS = ("ch", "ch_mult", "num_res_blocks", "z_channels", "double_z", "dtype")


def create_encoder(device: Optional[torch.device | str] = None, **kwargs: Any) -> Encoder:
    """JAX's ``create_encoder``, the factory of ``target: model.vae.Encoder``
    (the ``nsampler`` node of the cls test configs, which nothing runs):
    an :class:`Encoder` of the entries of :data:`ENCODER_FIELDS` (the
    reference's other ddconfig keys dropped; ``in_channels`` 3, as JAX's
    module reads RGB), on ``device`` (the card unless named)."""
    kw = {k: tuple(v) if k == "ch_mult" else v for k, v in kwargs.items()
          if k in ENCODER_FIELDS}
    with torch.device(resolve_device(device)):
        return Encoder(**kw)
