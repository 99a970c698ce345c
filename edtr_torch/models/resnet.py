"""ResNet (NCHW), the classification task net and DeepLabV3's backbone.

Counterpart of ``edtr_tpu/models/resnet.py`` (torchvision's ResNet v1.5,
the stride on the 3x3 of a bottleneck): types 18/34/50/101/152 of
:data:`ARCHS`, ``forward(x, upsample=, normalize=, return_feat=,
features=, train=)`` with JAX's arguments and outputs:

* ``resize``: the input resized to 224² first (bilinear with JAX's
  antialiasing, :func:`resize_bilinear`); ``upsample`` > 1 scales it up;
* ``normalize``: ImageNet's mean and std (:func:`normalize_imagenet`);
* ``features=True``: the four stage outputs (C2..C5); ``return_feat``:
  ``(logits, layer4 map)``; else the fp32 logits;
* ``replace_stride_with_dilation``: torchvision's rule, a dilated stage's
  first block keeps the previous dilation and drops its stride.

Parameter names are torchvision's (``conv1``, ``bn1``,
``layer{i}.{j}.conv1``, ``.downsample.0``/``.1``, ``fc``); a net built with
``num_classes=None`` has no ``fc`` (a backbone). Numerics as JAX's: convs
in ``dtype``, every BatchNorm in fp32 (eps 1e-5, torch momentum 0.1, its
mode per call as :class:`~edtr_torch.models.mobilenetv3.BatchNorm2d`'s)
returning fp32, so ReLUs and residual adds are fp32.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.device import resolve_device
from edtr_torch.models.layers import Conv2d, Linear
from edtr_torch.models.mobilenetv3 import BatchNorm2d

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

ARCHS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    # made once per device and dtype: a tensor made from host numbers is a
    # host-to-device copy on every call
    return tuple(torch.tensor(v, dtype=dtype, device=device)[:, None, None]
                 for v in (IMAGENET_MEAN, IMAGENET_STD))


def normalize_imagenet(x: torch.Tensor, inv: bool = False) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> ImageNet-normalised (or back, ``inv``)."""
    mean, std = _imagenet_stats(x.device, x.dtype)
    return x * std + mean if inv else (x - mean) / std


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` on NCHW: half-pixel centres,
    antialiased when shrinking (a triangle kernel widened by the scale),
    which ``F.interpolate`` gives with ``antialias=True``; enlarging, the
    plain bilinear of ``align_corners=False``."""
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrink)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
          dtype: Optional[torch.dtype] = None) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=dilation * (k - 1) // 2, bias=False,
                  dtype=dtype, dilation=dilation)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, dtype)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation, dtype)
        self.bn2 = _bn(planes)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1, stride, dtype=dtype),
                                         _bn(planes)) if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x), train)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, dtype)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = _bn(planes * 4)
        self.downsample = (nn.Sequential(_conv(inplanes, planes * 4, 1, stride, dtype=dtype),
                                         _bn(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x), train)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, type: int = 18, num_classes: Optional[int] = 1000, inp_chans: int = 3,
                 strides: Sequence[int] = (2, 2, 2),
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 resize: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kind, blocks = ARCHS[type]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.resize, self.dtype = resize, dtype
        self.conv1 = _conv(inp_chans, 64, 7, 2, dtype=dtype)
        self.bn1 = _bn(64)
        inplanes, dilation = 64, 1
        for li, n_blocks in enumerate(blocks):
            planes = 64 * 2 ** li
            stride = 1 if li == 0 else strides[li - 1]
            prev_dilation = dilation
            if li and replace_stride_with_dilation[li - 1]:
                dilation *= stride
                stride = 1
            layer = []
            for bi in range(n_blocks):
                layer.append(block(
                    inplanes, planes, stride if bi == 0 else 1,
                    prev_dilation if bi == 0 else dilation,
                    bi == 0 and (stride != 1 or inplanes != planes * block.expansion), dtype))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.out_channels = inplanes
        self.fc = None if num_classes is None else Linear(inplanes, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, upsample: int = 1, normalize: bool = True,
                return_feat: bool = False, features: bool = False, train: bool = False):
        """x (B, 3, H, W) in [0, 1] (module docstring for the arguments)."""
        if self.resize:
            x = resize_bilinear(x, (224, 224))
        if upsample > 1:
            x = resize_bilinear(x, (x.shape[2] * upsample, x.shape[3] * upsample))
        if normalize:
            x = normalize_imagenet(x)
        x = x.to(self.dtype or x.dtype)
        x = torch.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        stages: List[torch.Tensor] = []
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x, train)
            stages.append(x)
        if features:
            return stages
        logits = self.fc(x.mean(dim=(2, 3))).float()
        return (logits, x) if return_feat else logits


def resnet(type: int = 18, num_classes: int = 1000, dtype: Optional[torch.dtype] = None,
           device: Optional[torch.device | str] = None, **kwargs) -> ResNet:
    """:class:`ResNet` with random weights, on ``device`` (the card unless
    the caller names another); the factory of the configs'
    ``model.resnet.ResNet``. Other keyword arguments are :class:`ResNet`'s;
    trained weights load through ``from_jax(variables, "resnet")``."""
    model = ResNet(type=type, num_classes=num_classes, dtype=dtype, **kwargs)
    return model.to(resolve_device(device)).eval()
