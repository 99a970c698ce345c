"""EDSR super-resolution net, NCHW.

Counterpart of ``edtr_tpu/models/edsr.py``, which no config uses: the
DIV2K RGB mean (times ``rgb_range``) taken off the input and put back on
the output, a head conv (after a pixel-unshuffle by ``unshuffle_scale``
with ``unshuffle``), ``n_resblocks`` conv-ReLU-conv blocks scaled by
``res_scale`` and a body conv around one skip, then pixel-shuffle
upsampling (x2 stages while ``scale`` is even, then x3 where 3 is left)
and the tail conv. Stock PyTorch ops, as JAX leaves the net to XLA.

Parameter names are the reference state-dict keys (``head.0`` or, with
``unshuffle``, ``head.1``; ``body.{i}.body.{0,2}``, ``body.{n}``,
``tail.0.{2j}``, ``tail.1``), read by
``edtr_tpu/utils/convert.py:convert_edsr``. The reference's fixed
``sub_mean``/``add_mean`` convs are the constant mean here, as in JAX: a
reference checkpoint loads with those four keys dropped.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from edtr_torch.models.layers import Conv2d

DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)


class ResBlock(nn.Module):
    def __init__(self, n_feats: int, res_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.res_scale = res_scale
        self.body = nn.Sequential(Conv2d(n_feats, n_feats, 3, padding=1, dtype=dtype), nn.ReLU(),
                                  Conv2d(n_feats, n_feats, 3, padding=1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x) * self.res_scale


def _upsampler(scale: int, n_feats: int, dtype: Optional[torch.dtype]) -> nn.Sequential:
    layers: List[nn.Module] = []
    while scale % 2 == 0 and scale > 1:
        layers += [Conv2d(n_feats, 4 * n_feats, 3, padding=1, dtype=dtype), nn.PixelShuffle(2)]
        scale //= 2
    if scale == 3:
        layers += [Conv2d(n_feats, 9 * n_feats, 3, padding=1, dtype=dtype), nn.PixelShuffle(3)]
    return nn.Sequential(*layers)


class EDSR(nn.Module):
    """(B, in_nc, H, W) in [0, ``rgb_range``] -> (B, out_nc, H * s, W * s),
    ``s`` = ``scale`` divided by ``unshuffle_scale`` with ``unshuffle``."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, n_resblocks: int = 32,
                 n_feats: int = 256, scale: int = 4, rgb_range: float = 1.0,
                 res_scale: float = 1.0, unshuffle: bool = False,
                 unshuffle_scale: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        s = unshuffle_scale if unshuffle else 1
        conv = Conv2d(in_nc * s * s, n_feats, 3, padding=1, dtype=dtype)
        self.head = nn.Sequential(nn.PixelUnshuffle(s), conv) if unshuffle else nn.Sequential(conv)
        self.body = nn.Sequential(
            *(ResBlock(n_feats, res_scale, dtype) for _ in range(n_resblocks)),
            Conv2d(n_feats, n_feats, 3, padding=1, dtype=dtype))
        self.tail = nn.Sequential(_upsampler(scale, n_feats, dtype),
                                  Conv2d(n_feats, out_nc, 3, padding=1, dtype=dtype))
        self.register_buffer("mean", torch.tensor(DIV2K_RGB_MEAN).reshape(1, 3, 1, 1) * rgb_range,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = self.mean.to(x.dtype)
        x = self.head(x - mean)
        return self.tail(x + self.body(x)) + mean
