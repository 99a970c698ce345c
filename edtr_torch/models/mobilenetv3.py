"""MobileNetV3-Large feature extractor (NCHW), the detector's backbone.

Counterpart of ``edtr_tpu/models/mobilenetv3.py`` with ``features=True``:
the forward returns all 17 stage outputs (first conv, 15 inverted residual
blocks, last conv), which the detector's FPN indexes by
:meth:`MobileNetV3.stage_indices`. Parameter names are torchvision's
(``features.N.0`` conv / ``features.N.1`` norm, ``features.N.block.j...``).
The classification head (JAX's ``features=False``) is not ported yet.

Numerics as in JAX: convs compute in ``dtype`` (fp32 params, input and
kernel cast, bias added in ``dtype``); every BatchNorm normalises in fp32
(eps 1e-3) and returns fp32 whatever ``dtype`` is, so activations,
residual adds and the squeeze-excitation gate's product are fp32 and the
next conv casts its input back.

BatchNorm mode is chosen per call, ``forward(x, train=...)``, as JAX's
``train`` argument, not by ``nn.Module.train()``: ``train=False``
normalises with the running statistics; ``train=True`` with the batch's
and updates the running ones (JAX's ``TorchBatchNorm``, torch's
momentum convention, m = 0.01).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn

from edtr_torch.models.layers import Conv2d


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

    @property
    def is_cn(self) -> bool:
        return self.stride > 1


def mobilenet_v3_large_conf() -> List[IRConf]:
    """The MobileNetV3-Large table at width 1.0, full tail, no dilation (the
    detector's; every width is already a multiple of 8)."""

    def c(i, k, e, o, se, act, s):
        return IRConf(i, k, e, o, se, act == "HS", s)

    setting = [
        c(16, 3, 16, 16, False, "RE", 1),
        c(16, 3, 64, 24, False, "RE", 2),      # C1
        c(24, 3, 72, 24, False, "RE", 1),
        c(24, 5, 72, 40, True, "RE", 2),       # C2
        c(40, 5, 120, 40, True, "RE", 1),
        c(40, 5, 120, 40, True, "RE", 1),
        c(40, 3, 240, 80, False, "HS", 2),     # C3
        c(80, 3, 200, 80, False, "HS", 1),
        c(80, 3, 184, 80, False, "HS", 1),
        c(80, 3, 184, 80, False, "HS", 1),
        c(80, 3, 480, 112, True, "HS", 1),
        c(112, 3, 672, 112, True, "HS", 1),
        c(112, 5, 672, 160, True, "HS", 2),    # C4
        c(160, 5, 960, 160, True, "HS", 1),
        c(160, 5, 960, 160, True, "HS", 1),
    ]
    return setting


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
    (Bessel's n / (n - 1)), as ``nn.BatchNorm2d`` writes them."""

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
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
            n = xf.numel() // xf.shape[1]
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
                 dtype: Optional[torch.dtype] = None):
        super().__init__(
            Conv2d(in_ch, out_ch, kernel, stride=stride, padding=(kernel - 1) // 2,
                   bias=False, dtype=dtype, groups=groups),
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
        layers.append(ConvBNAct(cnf.exp_ch, cnf.exp_ch, cnf.kernel, stride=cnf.stride,
                                groups=cnf.exp_ch, act=act, dtype=dtype))
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


class MobileNetV3(nn.Module):
    """MobileNetV3-Large's ``features``; :meth:`forward` returns every
    stage's output. Width 1.0, full tail, no dilation: JAX's
    ``width_mult``, ``reduced_tail`` and ``dilated`` wait for the DeepLabV3
    port (ROADMAP.md, Queue 1)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.setting = mobilenet_v3_large_conf()
        first, last = self.setting[0].in_ch, 6 * self.setting[-1].out_ch
        self.features = nn.Sequential(
            ConvBNAct(3, first, 3, stride=2, act="hardswish", dtype=dtype),
            *(InvertedResidual(cnf, dtype=dtype) for cnf in self.setting),
            ConvBNAct(self.setting[-1].out_ch, last, 1, act="hardswish", dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> the 17 stage outputs, fp32 (the norms');
        ``train``: the norms' mode (:class:`BatchNorm2d`)."""
        x = x.to(self.dtype or x.dtype)
        feats = []
        for layer in self.features:
            x = layer(x, train)
            feats.append(x)
        return feats

    def stage_indices(self) -> List[int]:
        """[0] + the strided blocks + [last], indexing :meth:`forward`'s list."""
        return ([0] + [i + 1 for i, c in enumerate(self.setting) if c.is_cn]
                + [len(self.setting) + 1])

    def stage_channels(self) -> List[int]:
        return ([self.setting[0].in_ch] + [c.out_ch for c in self.setting]
                + [6 * self.setting[-1].out_ch])
