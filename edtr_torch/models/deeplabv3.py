"""DeepLabV3 semantic segmentation (NCHW), the segmentation task net.

Counterpart of ``edtr_tpu/models/deeplabv3.py``: :class:`ASPP` (1x1, three
dilated 3x3 and a pooling branch, then a 1x1 projection),
:class:`DeepLabHead`, :class:`FCNHead`, and the two networks on a dilated
backbone, ImageNet-normalised input and bilinear logits at the input size:

* :class:`DeepLabV3MobileNet`: MobileNetV3-Large with ``dilated=True``,
  the head on the ``C5`` tap (the last stage) and the auxiliary head on
  ``C2`` (stride 8);
* :class:`DeepLabV3ResNet`: ResNet with layers 3 and 4 dilated (output
  stride 8), the head on layer4 (``C5``), the auxiliary head on layer3.

``forward(x, normalize=, return_feat=, train=)`` returns ``{"out"[,
"aux"]}``: (B, classes, H, W) fp32 logits, NCHW (JAX's are NHWC), and with
``return_feat`` also the taps ``{"C0".."C5"}`` (MobileNet) or ``{"C5",
"C2"}`` (ResNet). The heads' norms are JAX's ``ConvBNAct`` ones, eps 1e-3
and momentum 0.01 on either backbone. The pooling branch's norm sees one
value a channel an image; :class:`~edtr_torch.models.mobilenetv3.BatchNorm2d`
computes its own statistics, so a train-mode call takes any batch. Names
are torchvision's (``backbone.N`` / ``backbone.layerK``,
``classifier.0.convs.i``, ``classifier.0.project``, ``classifier.1``/``2``/``4``,
``aux_classifier.0``/``1``/``4``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from edtr_torch.device import resolve_device
from edtr_torch.models.layers import Conv2d
from edtr_torch.models.mobilenetv3 import BatchNorm2d, ConvBNAct, MobileNetV3, run_stages
from edtr_torch.models.resnet import ResNet, normalize_imagenet, resize_bilinear


class _PoolBranch(nn.Sequential):
    """ASPP's pooling branch: global mean -> 1x1 conv -> norm -> ReLU,
    broadcast back over the map; child 0 holds torchvision's pooling
    place, so the conv and norm are ``1`` and ``2``."""

    def __init__(self, in_ch: int, out_ch: int, dtype: Optional[torch.dtype]):
        super().__init__(nn.Identity(), Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype),
                         BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        p = torch.relu(self[2](self[1](x.mean(dim=(2, 3), keepdim=True)), train))
        return p.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    def __init__(self, in_ch: int, atrous_rates: Sequence[int] = (12, 24, 36),
                 out_channels: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNAct(in_ch, out_channels, 1, dtype=dtype)]
            + [ConvBNAct(in_ch, out_channels, 3, dtype=dtype, dilation=r) for r in atrous_rates]
            + [_PoolBranch(in_ch, out_channels, dtype)])
        self.project = ConvBNAct(out_channels * (len(atrous_rates) + 2), out_channels, 1,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.project(torch.cat([conv(x, train) for conv in self.convs], 1), train)


class DeepLabHead(nn.Sequential):
    """ASPP (0), 3x3 conv (1), norm (2), ReLU, 1x1 conv with bias (4)."""

    def __init__(self, in_ch: int, num_classes: int, dtype: Optional[torch.dtype] = None):
        super().__init__(ASPP(in_ch, dtype=dtype), Conv2d(256, 256, 3, padding=1, bias=False,
                                                          dtype=dtype),
                         BatchNorm2d(256), nn.Identity(), Conv2d(256, num_classes, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self[2](self[1](self[0](x, train)), train))
        return self[4](x)


class FCNHead(nn.Sequential):
    """3x3 conv to in/4 channels (0), norm (1), ReLU, 1x1 conv with bias (4)."""

    def __init__(self, in_ch: int, num_classes: int, dtype: Optional[torch.dtype] = None):
        inter = in_ch // 4
        super().__init__(Conv2d(in_ch, inter, 3, padding=1, bias=False, dtype=dtype),
                         BatchNorm2d(inter), nn.Identity(), nn.Identity(),
                         Conv2d(inter, num_classes, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self[4](torch.relu(self[1](self[0](x), train)))


def _logits(head: nn.Module, feat: torch.Tensor, size, train: bool) -> torch.Tensor:
    return resize_bilinear(head(feat, train).float(), size)


class _DeepLabV3(nn.Module):
    """The heads and the output contract shared by both backbones;
    :meth:`taps` gives the backbone's ``{"C5", "C2", ...}`` maps."""

    def __init__(self, c5: int, c2: int, num_classes: int, aux_loss: bool,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.classifier = DeepLabHead(c5, num_classes, dtype)
        self.aux_classifier = FCNHead(c2, num_classes, dtype) if aux_loss else None

    def taps(self, x: torch.Tensor, train: bool) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, normalize: bool = True, return_feat: bool = False,
                train: bool = False):
        """x (B, 3, H, W) in [0, 1] -> ``{"out"[, "aux"]}`` (module
        docstring)."""
        if normalize:
            x = normalize_imagenet(x)
        size = tuple(x.shape[2:])
        feats = self.taps(x, train)
        result = {"out": _logits(self.classifier, feats["C5"], size, train)}
        if self.aux_classifier is not None:
            result["aux"] = _logits(self.aux_classifier, feats["C2"], size, train)
        return (result, feats) if return_feat else result


class DeepLabV3MobileNet(_DeepLabV3):
    def __init__(self, num_classes: int = 21, aux_loss: bool = True,
                 dtype: Optional[torch.dtype] = None):
        body = MobileNetV3(dilated=True, dtype=dtype)
        si, chans = body.stage_indices(), body.stage_channels()
        super().__init__(chans[si[5]], chans[si[2]], num_classes, aux_loss, dtype)
        self.backbone, self.stage_idx, self.dtype = body.features, si, dtype

    def taps(self, x: torch.Tensor, train: bool) -> Dict[str, torch.Tensor]:
        feats = run_stages(self.backbone, x, train, self.dtype)
        return {f"C{i}": feats[j] for i, j in enumerate(self.stage_idx)}


class DeepLabV3ResNet(_DeepLabV3):
    def __init__(self, num_classes: int = 21, resnet_type: int = 50, aux_loss: bool = True,
                 dtype: Optional[torch.dtype] = None):
        body = ResNet(type=resnet_type, num_classes=None,
                      replace_stride_with_dilation=(False, True, True), dtype=dtype)
        super().__init__(body.out_channels, body.out_channels // 2, num_classes, aux_loss,
                         dtype)
        self.backbone = body

    def taps(self, x: torch.Tensor, train: bool) -> Dict[str, torch.Tensor]:
        stages = self.backbone(x, normalize=False, features=True, train=train)
        return {"C5": stages[-1], "C2": stages[-2]}


def deeplabv3_mobilenet_v3_large(weights_backbone=None, num_classes: int = 21,
                                 aux_loss: bool = True, dtype: Optional[torch.dtype] = None,
                                 device: Optional[torch.device | str] = None,
                                 **kwargs) -> DeepLabV3MobileNet:
    """:class:`DeepLabV3MobileNet` with random weights, on ``device`` (the
    card unless the caller names another). ``weights_backbone`` is ignored,
    as JAX's factory ignores it: trained weights load through
    ``from_jax(variables, "deeplabv3")``."""
    model = DeepLabV3MobileNet(num_classes=num_classes, aux_loss=aux_loss, dtype=dtype)
    return model.to(resolve_device(device)).eval()


def deeplabv3_resnet50(weights_backbone=None, num_classes: int = 21, aux_loss: bool = False,
                       dtype: Optional[torch.dtype] = None,
                       device: Optional[torch.device | str] = None,
                       **kwargs) -> DeepLabV3ResNet:
    """:class:`DeepLabV3ResNet` on ResNet-50, as
    :func:`deeplabv3_mobilenet_v3_large` builds its net."""
    model = DeepLabV3ResNet(num_classes=num_classes, resnet_type=50, aux_loss=aux_loss,
                            dtype=dtype)
    return model.to(resolve_device(device)).eval()
