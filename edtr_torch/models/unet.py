"""SD2.1 LDM UNet (NCHW) with ControlNet residual injection.

Counterpart of ``edtr_tpu/models/unet.py``. The ResBlock halves follow
``edtr_tpu/ops/gn_conv.py:_ref``: GroupNorm affine in fp32, cast to the
compute dtype, SiLU and conv3x3 in the compute dtype, bias/emb/residual
added in the compute dtype. The Upsample is nearest-2x then conv3x3, the
function both of JAX's formulations (``_ups_ref`` and the phase-folded
``_ups_subpixel``) compute. Inside a ``layers.fused_conv`` block (JAX's
``ResBlock.fused`` with the gn_conv families forced on) both run through the
port's conv kernels on channels-last activations; otherwise they are stock
PyTorch ops, as the JAX package leaves them to XLA by default. With
``use_checkpoint`` (JAX's ``nn.remat`` over ResBlock and SpatialTransformer,
the reference's gradient checkpointing) each of those recomputes its
activations in the backward (``layers.remat``).

Parameter names are the reference LDM state-dict keys (``time_embed.0``,
``input_blocks.1.0.in_layers.0``, ``middle_block.1.proj_in``, ``out.2``, ...),
so ``edtr_tpu/utils/convert.py:convert_ldm_unet`` reads the port's
``state_dict`` as it reads an SD2.1 checkpoint.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.models.attention import SpatialTransformer
from edtr_torch.models.layers import (Conv2d, GroupNorm32, Linear, norm_silu_conv, remat,
                                      timestep_embedding, to_conv_layout,
                                      upsample_conv3x3)


class ResBlock(nn.Module):
    """LDM ResBlock without scale-shift norm (``in_layers`` / ``emb_layers``
    / ``out_layers`` / ``skip_connection``)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            Conv2d(channels, out_channels, 3, padding=1, dtype=dtype))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, out_channels, dtype=dtype))
        # out_layers.2 is the reference's Dropout(0)
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Identity(),
            Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype))
        self.skip_connection = (
            Conv2d(channels, out_channels, 1, dtype=dtype)
            if channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        xc = x.to(self.dtype or x.dtype)
        h = norm_silu_conv(xc, self.in_layers[0], self.in_layers[2],
                           emb=self.emb_layers(emb))
        skip = self.skip_connection(x)
        return norm_silu_conv(h, self.out_layers[0], self.out_layers[3],
                              res=skip.to(h.dtype))


class Downsample(nn.Module):
    """Stride-2 conv3x3."""

    def __init__(self, channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.op = Conv2d(channels, out_channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x then conv3x3."""

    def __init__(self, channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_conv3x3(x.to(self.dtype or x.dtype), self.conv)


def heads_for(ch: int, num_head_channels: int, num_heads: int) -> Tuple[int, int]:
    if num_head_channels == -1:
        return num_heads, ch // num_heads
    return ch // num_head_channels, num_head_channels


def run_block(block: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
              context: Optional[torch.Tensor], use_checkpoint: bool = False) -> torch.Tensor:
    """The reference's ``TimestepEmbedSequential``: ResBlocks take the
    timestep embedding, transformers the context, the rest only ``h``;
    ``use_checkpoint``: ResBlocks and transformers under ``remat``."""
    for layer in block:
        if isinstance(layer, (ResBlock, SpatialTransformer)):
            arg = emb if isinstance(layer, ResBlock) else context
            h = remat(layer, h, arg) if use_checkpoint else layer(h, arg)
        else:
            h = layer(h)
    return h


class _Encoder(nn.Module):
    """Time embedding, input blocks and middle block: the half the UNet
    and the ControlNet share."""

    def __init__(self, in_channels: int, model_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], channel_mult: Sequence[int],
                 num_heads: int, num_head_channels: int, transformer_depth: int,
                 context_dim: Optional[int], use_linear_in_transformer: bool,
                 use_checkpoint: bool, dtype: Optional[torch.dtype]):
        super().__init__()
        if not use_linear_in_transformer:
            raise NotImplementedError("only use_linear_in_transformer=True is ported")
        mc = model_channels
        self.model_channels, self.dtype = mc, dtype
        self.use_checkpoint = bool(use_checkpoint)
        self._st = dict(depth=transformer_depth, context_dim=context_dim, dtype=dtype)
        self._heads = (num_head_channels, num_heads)
        self.time_embed = nn.Sequential(
            Linear(mc, mc * 4, dtype=dtype), nn.SiLU(),
            Linear(mc * 4, mc * 4, dtype=dtype))
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([Conv2d(in_channels, mc, 3, padding=1, dtype=dtype)])])
        self.block_chans: List[int] = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mc * 4, mult * mc, dtype)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(self._transformer(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                self.block_chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch, ch, dtype)]))
                self.block_chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([
            ResBlock(ch, mc * 4, ch, dtype), self._transformer(ch),
            ResBlock(ch, mc * 4, ch, dtype)])
        self.out_ch = ch

    def _transformer(self, ch: int) -> SpatialTransformer:
        n_heads, d_head = heads_for(ch, *self._heads)
        return SpatialTransformer(ch, n_heads, d_head, **self._st)

    def embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(timestep_embedding(timesteps, self.model_channels))


class UNetModel(_Encoder):
    """SD2.1 UNet; ``control`` (13 residuals) makes it the ControlledUnetModel:
    [0..11] are added to the stored encoder skips, [12] to the middle block."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads: int = -1,
                 num_head_channels: int = 64, transformer_depth: int = 1,
                 context_dim: Optional[int] = 1024,
                 use_linear_in_transformer: bool = True, use_checkpoint: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, model_channels, num_res_blocks,
                         attention_resolutions, channel_mult, num_heads,
                         num_head_channels, transformer_depth, context_dim,
                         use_linear_in_transformer, use_checkpoint, dtype)
        mc = model_channels
        chans = list(self.block_chans)
        ch = self.out_ch
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mc * 4, mult * mc, dtype)]
                ch = mult * mc
                if 2 ** level in attention_resolutions:
                    layers.append(self._transformer(ch))
                if level != 0 and i == num_res_blocks:
                    layers.append(Upsample(ch, ch, dtype))
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 Conv2d(ch, out_channels, 3, padding=1, dtype=dtype))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                control: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        emb = self.embed(timesteps)
        cdt = self.dtype or x.dtype
        h = to_conv_layout(x.to(cdt))
        if context is not None:
            context = context.to(cdt)
        hs = []
        ckpt = self.use_checkpoint
        for block in self.input_blocks:
            h = run_block(block, h, emb, context, ckpt)
            hs.append(h)
        h = run_block(self.middle_block, h, emb, context, ckpt)
        control = list(control) if control is not None else None
        if control is not None:
            h = h + control.pop().to(h.dtype)
        for block in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control.pop().to(h.dtype)
            h = run_block(block, torch.cat([h, skip], dim=1), emb, context, ckpt)
        h = F.silu(self.out[0](h))
        return self.out[2](h).float()
