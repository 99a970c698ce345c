"""SKUNet, the selective-kernel UNet restorer, NCHW.

Counterpart of ``edtr_tpu/models/skunet.py``, which no config uses: the
input ImageNet-normalised (``normalize``), a 9x9 conv, two 2x2 max-pool +
:class:`SelectiveConv` downs, two bilinear (align-corners) 2x upsample +
concat + :class:`SelectiveConv` ups, a 3x3 conv, and the normalised input
added back. A selective conv mixes a BatchNorm path and an InstanceNorm
path (LeakyReLU 0.01 after each) by a spatial softmax attention over a
4x4 pooled map (:class:`Selector`). Stock PyTorch ops, as JAX leaves the
net to XLA; the BatchNorms as the port's task nets' (fp32, their mode per
call: ``forward(x, train=True)`` uses and updates batch statistics).

Parameter names are the reference state-dict keys (``down1``,
``down{2,3}.maxpool_conv.1.{conv1,conv2,BN,selector.fc.0,
selector.att_conv{1,2}}``, ``up{1,2}.conv.*``, ``up3``), read by
``edtr_tpu/utils/convert.py:convert_skunet``; the selector flattens its
pooled map channel-major, as the reference's ``view(b, -1)`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.models.layers import Conv2d, Linear
from edtr_torch.models.mobilenetv3 import BatchNorm2d
from edtr_torch.models.resnet import normalize_imagenet

SPATIAL_ATTENTION = 4


class Selector(nn.Module):
    def __init__(self, channel: int, reduction: int = 16, dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = channel * SPATIAL_ATTENTION ** 2
        self.fc = nn.Sequential(Linear(n, n // reduction, bias=False, dtype=dtype))
        self.att_conv1 = Linear(n // reduction, n, dtype=dtype)
        self.att_conv2 = Linear(n // reduction, n, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, c, h, w = x.shape
        sa = SPATIAL_ATTENTION
        y = torch.relu(self.fc(F.adaptive_avg_pool2d(x, sa).reshape(b, -1)))
        att = torch.softmax(torch.stack([self.att_conv1(y), self.att_conv2(y)]), dim=0)
        att = att.reshape(2 * b, c, sa, sa)
        att = F.interpolate(att, size=(h, w), mode="nearest").reshape(2, b, c, h, w)
        return att[0], att[1]


class SelectiveConv(nn.Module):
    """Two bias-free convs, one on the BatchNorm path and one on the
    InstanceNorm path (``first``: both on the raw input), mixed by the
    :class:`Selector` of their sum."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 reduction: int = 16, first: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.first = first
        pad = kernel_size // 2
        self.conv1 = Conv2d(in_channels, out_channels, kernel_size, padding=pad, bias=False,
                            dtype=dtype)
        self.conv2 = Conv2d(in_channels, out_channels, kernel_size, padding=pad, bias=False,
                            dtype=dtype)
        self.selector = Selector(out_channels, reduction, dtype)
        self.BN = BatchNorm2d(in_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.first:
            f_in = s_in = x
        else:
            f_in = F.leaky_relu(self.BN(x, train), 0.01)
            s_in = F.leaky_relu(F.instance_norm(x, eps=1e-5), 0.01)
        out1, out2 = self.conv1(f_in), self.conv2(s_in)
        att1, att2 = self.selector(out1 + out2)
        return out1 * att1 + out2 * att2


class SKDown(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          SelectiveConv(in_channels, out_channels, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.maxpool_conv[1](self.maxpool_conv[0](x), train)


class SKUp(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = SelectiveConv(in_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self.conv(torch.cat([skip, x], 1), train)


class SKUNet(nn.Module):
    """(B, 3, H, W) in [0, 1] (H, W multiples of 16) -> (B, 3, H, W) in the
    normalised space with ``normalize``."""

    def __init__(self, bilinear: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.down1 = Conv2d(3, 32, 9, padding=4, dtype=dtype)
        self.down2 = SKDown(32, 64, dtype)
        self.down3 = SKDown(64, 64, dtype)
        self.up1 = SKUp(128, 32, dtype)
        self.up2 = SKUp(64, 16, dtype)
        self.up3 = Conv2d(16, 3, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, normalize: bool = True, train: bool = False) -> torch.Tensor:
        if normalize:
            x = normalize_imagenet(x)
        x1 = self.down1(x)
        x2 = self.down2(x1, train)
        x3 = self.down3(x2, train)
        y = self.up2(self.up1(x3, x2, train), x1, train)
        return self.up3(y) + x
