"""MobileNetV3-Large (NCHW): the detector's backbone, DeepLabV3's dilated
backbone and the classification network.

Counterpart of ``edtr_tpu/models/mobilenetv3.py``. ``forward(x,
features=True)`` returns all 17 stage outputs (first conv, 15 inverted
residual blocks, last conv), which the detector's FPN and DeepLabV3's
C-taps index by :meth:`MobileNetV3.stage_indices`; ``features=False``
(a net built with ``num_classes``) pools the last stage and returns the
classifier's fp32 logits. The knobs are JAX's: ``width_mult`` scales
every width (rounded to multiples of 8), ``reduced_tail`` halves the last
stage, ``dilated`` runs the last stage's blocks at stride 1 with dilation
2 (the depthwise convs dilated, ``groups`` = channels). Parameter names
are torchvision's (``features.N.0`` conv / ``features.N.1`` norm,
``features.N.block.j...``, ``classifier.0`` / ``classifier.3``).

Numerics as in JAX: convs compute in ``dtype`` (fp32 params, input and
kernel cast, bias added in ``dtype``); every BatchNorm normalises in fp32
and returns fp32 whatever ``dtype`` is, so activations, residual adds and
the squeeze-excitation gate's product are fp32 and the next conv casts its
input back.

BatchNorm mode is chosen per call, ``forward(x, train=...)``, as JAX's
``train`` argument, not by ``nn.Module.train()``: ``train=False``
normalises with the running statistics; ``train=True`` with the batch's
and updates the running ones (JAX's ``TorchBatchNorm``, torch's momentum
convention: MobileNet's norms eps 1e-3, m = 0.01).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from edtr_torch.device import resolve_device
from edtr_torch.models.layers import Conv2d, Linear
from edtr_torch.parallel.distributed import batch_moments


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class IRConf(NamedTuple):
    in_ch: int
    kernel: int
    exp_ch: int
    out_ch: int
    use_se: bool
    use_hs: bool
    stride: int
    dilation: int

    @property
    def is_cn(self) -> bool:
        return self.stride > 1


def mobilenet_v3_large_conf(width_mult: float = 1.0, reduced_tail: bool = False,
                            dilated: bool = False) -> Tuple[List[IRConf], int]:
    """The MobileNetV3-Large table and the classifier's hidden width, as
    JAX's ``mobilenet_v3_large_conf``."""
    rd = 2 if reduced_tail else 1
    dil = 2 if dilated else 1

    def a(ch):
        return _make_divisible(ch * width_mult)

    def c(i, k, e, o, se, act, s, d):
        return IRConf(a(i), k, a(e), a(o), se, act == "HS", s, d)

    setting = [
        c(16, 3, 16, 16, False, "RE", 1, 1),
        c(16, 3, 64, 24, False, "RE", 2, 1),      # C1
        c(24, 3, 72, 24, False, "RE", 1, 1),
        c(24, 5, 72, 40, True, "RE", 2, 1),       # C2
        c(40, 5, 120, 40, True, "RE", 1, 1),
        c(40, 5, 120, 40, True, "RE", 1, 1),
        c(40, 3, 240, 80, False, "HS", 2, 1),     # C3
        c(80, 3, 200, 80, False, "HS", 1, 1),
        c(80, 3, 184, 80, False, "HS", 1, 1),
        c(80, 3, 184, 80, False, "HS", 1, 1),
        c(80, 3, 480, 112, True, "HS", 1, 1),
        c(112, 3, 672, 112, True, "HS", 1, 1),
        c(112, 5, 672, 160 // rd, True, "HS", 2, dil),   # C4
        c(160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil),
        c(160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil),
    ]
    return setting, a(1280 // rd)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``relu6(x + 3) / 6``, as ``jax.nn.hard_sigmoid``."""
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``x * hard_sigmoid(x)``, as ``jax.nn.hard_swish``."""
    return x * hard_sigmoid(x)


class BatchNorm2d(nn.Module):
    """BatchNorm with the arithmetic of JAX's ``TorchBatchNorm``, in fp32
    whatever the input's and the buffers' dtypes, returned in fp32:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.

    ``train=False``: the running statistics (torchvision's
    FrozenBatchNorm2d, and eval mode). ``train=True``: the batch's mean
    and biased variance over (B, H, W), and the running statistics updated
    in place, ``new = (1 - m) old + m batch`` with the unbiased variance
    (Bessel's n / (n - 1)), as ``nn.BatchNorm2d`` writes them; in a
    process group of several ranks the batch is every rank's
    (``parallel.distributed.batch_moments``), as GSPMD reduces JAX's over
    ``data``."""

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, var, n = batch_moments(xf)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean.float() + m * mean)
                self.running_var.copy_((1 - m) * self.running_var.float()
                                       + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        return (xf - mean[:, None, None]) * inv[:, None, None] + self.bias.float()[:, None, None]


_ACTS = {None: lambda x: x, "relu": torch.relu, "hardswish": hard_swish}


class ConvBNAct(nn.Sequential):
    """Conv (no bias) + BatchNorm + activation (``Conv2dNormActivation``):
    children ``0`` (conv) and ``1`` (norm), as torchvision names them."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: Optional[str] = "relu",
                 dtype: Optional[torch.dtype] = None, dilation: int = 1):
        super().__init__(
            Conv2d(in_ch, out_ch, kernel, stride=stride, padding=(kernel - 1) // 2 * dilation,
                   bias=False, dtype=dtype, groups=groups, dilation=dilation),
            BatchNorm2d(out_ch))
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.act(self[1](self[0](x), train))


class SqueezeExcitation(nn.Module):
    """Mean over the map -> fc1 -> relu -> fc2 -> hard sigmoid, times x."""

    def __init__(self, ch: int, squeeze_ch: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Conv2d(ch, squeeze_ch, 1, dtype=dtype)
        self.fc2 = Conv2d(squeeze_ch, ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * hard_sigmoid(self.fc2(torch.relu(self.fc1(s))))


class InvertedResidual(nn.Module):
    def __init__(self, cnf: IRConf, dtype: Optional[torch.dtype] = None):
        super().__init__()
        act = "hardswish" if cnf.use_hs else "relu"
        layers: List[nn.Module] = []
        if cnf.exp_ch != cnf.in_ch:
            layers.append(ConvBNAct(cnf.in_ch, cnf.exp_ch, 1, act=act, dtype=dtype))
        # dilated blocks drop their stride (torchvision's rule)
        layers.append(ConvBNAct(cnf.exp_ch, cnf.exp_ch, cnf.kernel,
                                stride=1 if cnf.dilation > 1 else cnf.stride,
                                groups=cnf.exp_ch, act=act, dtype=dtype, dilation=cnf.dilation))
        if cnf.use_se:
            layers.append(SqueezeExcitation(cnf.exp_ch, _make_divisible(cnf.exp_ch // 4),
                                            dtype=dtype))
        layers.append(ConvBNAct(cnf.exp_ch, cnf.out_ch, 1, act=None, dtype=dtype))
        self.block = nn.Sequential(*layers)
        self.use_res = cnf.stride == 1 and cnf.in_ch == cnf.out_ch

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x
        for layer in self.block:
            y = layer(y, train) if isinstance(layer, ConvBNAct) else layer(y)
        return y + x if self.use_res else y


def run_stages(stages: nn.Sequential, x: torch.Tensor, train: bool,
               dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
    """Every stage's output of ``stages`` (a :class:`MobileNetV3`'s
    ``features``) on ``x`` cast to ``dtype``, the norms in ``train`` mode."""
    x = x.to(dtype or x.dtype)
    feats = []
    for layer in stages:
        x = layer(x, train)
        feats.append(x)
    return feats


class MobileNetV3(nn.Module):
    """MobileNetV3-Large: ``features`` and, with ``num_classes``, the
    classifier (Linear, hard swish, Linear; torchvision's dropout between
    them is not applied, as JAX's ``__call__`` applies none)."""

    def __init__(self, num_classes: Optional[int] = None, width_mult: float = 1.0,
                 reduced_tail: bool = False, dilated: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.setting, last_channel = mobilenet_v3_large_conf(width_mult, reduced_tail, dilated)
        first, last = self.setting[0].in_ch, 6 * self.setting[-1].out_ch
        self.features = nn.Sequential(
            ConvBNAct(3, first, 3, stride=2, act="hardswish", dtype=dtype),
            *(InvertedResidual(cnf, dtype=dtype) for cnf in self.setting),
            ConvBNAct(self.setting[-1].out_ch, last, 1, act="hardswish", dtype=dtype))
        if num_classes is not None:
            # 1 and 2 hold the places of torchvision's Hardswish and Dropout,
            # so the Linear layers keep their checkpoint names
            self.classifier = nn.Sequential(
                Linear(last, last_channel, dtype=dtype), nn.Identity(), nn.Identity(),
                Linear(last_channel, num_classes, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                features: bool = True) -> List[torch.Tensor] | torch.Tensor:
        """x (B, 3, H, W) -> the 17 stage outputs, fp32 (the norms'), or
        with ``features=False`` the (B, num_classes) fp32 logits;
        ``train``: the norms' mode (:class:`BatchNorm2d`)."""
        feats = run_stages(self.features, x, train, self.dtype)
        if features:
            return feats
        y = feats[-1].mean(dim=(2, 3))
        y = hard_swish(self.classifier[0](y))
        return self.classifier[3](y).float()

    def stage_indices(self) -> List[int]:
        """[0] + the strided blocks + [last], indexing :meth:`forward`'s list."""
        return ([0] + [i + 1 for i, c in enumerate(self.setting) if c.is_cn]
                + [len(self.setting) + 1])

    def stage_channels(self) -> List[int]:
        return ([self.setting[0].in_ch] + [c.out_ch for c in self.setting]
                + [6 * self.setting[-1].out_ch])


def mobilenet_v3_large(weights_backbone=None, num_classes: int = 1000, dilated: bool = False,
                       reduced_tail: bool = False, dtype: Optional[torch.dtype] = None,
                       device: Optional[torch.device | str] = None, **kwargs) -> MobileNetV3:
    """The classification network with random weights, on ``device`` (the
    card unless the caller names another). ``weights_backbone`` is ignored,
    as JAX's factory ignores it: trained weights load through
    ``from_jax(variables, "mobilenetv3")``."""
    model = MobileNetV3(num_classes=num_classes, dilated=dilated, reduced_tail=reduced_tail,
                        dtype=dtype)
    return model.to(resolve_device(device)).eval()
