"""ControlNet: the SD UNet encoder taking ``concat(x, hint)``, tapped by
zero-initialised 1x1 convs into 13 control residuals.

Counterpart of ``edtr_tpu/models/controlnet.py``. Parameter names are the
reference state-dict keys (``zero_convs.{i}.0``, ``middle_block_out.0``),
read by ``edtr_tpu/utils/convert.py:convert_controlnet``. ``use_checkpoint``
puts its ResBlocks and transformers under ``layers.remat``, as the UNet's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from edtr_torch.models.layers import Conv2d, to_conv_layout
from edtr_torch.models.unet import _Encoder, run_block


class ControlNet(_Encoder):
    def __init__(self, in_channels: int = 4, hint_channels: int = 4,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads: int = -1,
                 num_head_channels: int = 64, transformer_depth: int = 1,
                 context_dim: Optional[int] = 1024,
                 use_linear_in_transformer: bool = True, use_checkpoint: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels + hint_channels, model_channels, num_res_blocks,
                         attention_resolutions, channel_mult, num_heads,
                         num_head_channels, transformer_depth, context_dim,
                         use_linear_in_transformer, use_checkpoint, dtype)
        self.zero_convs = nn.ModuleList(
            nn.Sequential(Conv2d(ch, ch, 1, dtype=dtype)) for ch in self.block_chans)
        self.middle_block_out = nn.Sequential(
            Conv2d(self.out_ch, self.out_ch, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, hint: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        emb = self.embed(timesteps)
        h = to_conv_layout(torch.cat([x, hint], dim=1).to(self.dtype or x.dtype))
        if context is not None:
            context = context.to(self.dtype or context.dtype)
        outs = []
        for block, zero_conv in zip(self.input_blocks, self.zero_convs):
            h = run_block(block, h, emb, context, self.use_checkpoint)
            outs.append(zero_conv(h))
        h = run_block(self.middle_block, h, emb, context, self.use_checkpoint)
        outs.append(self.middle_block_out(h))
        return outs
