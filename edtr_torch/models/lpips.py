"""LPIPS perceptual distance (Zhang et al. 2018), NCHW.

Counterpart of ``edtr_tpu/models/lpips.py``: an AlexNet or VGG16 feature
tower tapped after each of its five stages, the ``lpips`` package's fixed
input shift and scale, per-tap unit normalisation over channels
(``a / sqrt(sum(a^2) + 1e-10)``), squared differences, the learned 1x1
``lin`` heads (no bias), the spatial mean, the sum over taps. Stock
PyTorch ops in fp32: JAX leaves LPIPS to XLA.

Parameter names are the ``lpips`` package's: the towers' convs at their
torchvision feature indices inside each slice (``net.slice1.0``,
``net.slice2.3``, ...), the heads at ``lin{i}.model.1``. The scaling
layer's constants are fixed and not in the state dict
(:func:`lpips_state_dict` checks a file's and drops them). The perceptual
weights are not bundled: :func:`load_lpips` reads an ``lpips`` package
state dict.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from edtr_torch.device import resolve_device

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG_CHANNELS = (64, 128, 256, 512, 512)

# each tower's torchvision ``features`` as (index, layer) runs, one per
# slice: ("conv", cin, cout, kernel, stride, pad), ("relu",), ("pool", k, s)
_ALEX = (
    ((0, ("conv", 3, 64, 11, 4, 2)), (1, ("relu",))),
    ((2, ("pool", 3, 2)), (3, ("conv", 64, 192, 5, 1, 2)), (4, ("relu",))),
    ((5, ("pool", 3, 2)), (6, ("conv", 192, 384, 3, 1, 1)), (7, ("relu",))),
    ((8, ("conv", 384, 256, 3, 1, 1)), (9, ("relu",))),
    ((10, ("conv", 256, 256, 3, 1, 1)), (11, ("relu",))),
)


def _vgg16() -> tuple:
    slices, idx, cin = [], 0, 3
    for si, (ch, reps) in enumerate(zip(VGG_CHANNELS, (2, 2, 3, 3, 3))):
        layers = []
        if si:
            layers.append((idx, ("pool", 2, 2)))
            idx += 1
        for _ in range(reps):
            layers += [(idx, ("conv", cin, ch, 3, 1, 1)), (idx + 1, ("relu",))]
            idx, cin = idx + 2, ch
        slices.append(tuple(layers))
    return tuple(slices)


TOWERS = {"alex": (_ALEX, ALEX_CHANNELS), "vgg": (_vgg16(), VGG_CHANNELS)}


def _layer(spec: tuple) -> nn.Module:
    if spec[0] == "conv":
        _, cin, cout, k, stride, pad = spec
        return nn.Conv2d(cin, cout, k, stride=stride, padding=pad)
    if spec[0] == "pool":
        return nn.MaxPool2d(spec[1], spec[2])
    return nn.ReLU()


class Tower(nn.Module):
    """The feature tower as the ``lpips`` package slices it: the five
    slices' outputs (after each ReLU tap)."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        for si, layers in enumerate(TOWERS[net][0]):
            setattr(self, f"slice{si + 1}",
                    nn.Sequential(OrderedDict((str(i), _layer(spec)) for i, spec in layers)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        taps = []
        for si in range(5):
            x = getattr(self, f"slice{si + 1}")(x)
            taps.append(x)
        return tuple(taps)


class NetLinLayer(nn.Module):
    """A tap's 1x1 head; ``model.0`` is the package's dropout (the identity
    at evaluation), ``model.1`` the conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class LPIPS(nn.Module):
    """``forward(x, y)``: NCHW images in [-1, 1] -> (B,) distances. (JAX's
    ``spatial=True`` sums the taps' maps of different sizes, which fails;
    it is not ported.)"""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in TOWERS:
            raise ValueError(f"LPIPS net {net!r}: one of {sorted(TOWERS)}")
        self.register_buffer("shift", torch.tensor(SHIFT)[None, :, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE)[None, :, None, None],
                             persistent=False)
        self.net = Tower(net)
        for i, ch in enumerate(TOWERS[net][1]):
            setattr(self, f"lin{i}", NetLinLayer(ch))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net((x.float() - self.shift) / self.scale)
        fy = self.net((y.float() - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt(a.square().sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(b.square().sum(1, keepdim=True) + 1e-10)
            d = getattr(self, f"lin{i}")((a - b).square())
            total = total + d.mean(dim=(1, 2, 3))
        return total


def lpips_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ``lpips`` package state dict as :class:`LPIPS` loads it: the
    package's second names of the heads (``lins.{i}.``) folded into
    ``lin{i}.`` (they must agree), the fixed scaling layer checked against
    :data:`SHIFT` / :data:`SCALE` and dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.startswith("scaling_layer."):
            want = torch.tensor(SHIFT if key.endswith("shift") else SCALE)
            if not torch.allclose(value.reshape(-1).float().cpu(), want):
                raise ValueError(f"{key} {value.reshape(-1).tolist()} is not the lpips "
                                 f"package's constant {want.tolist()}")
            continue
        if key.startswith("lins."):
            key = "lin" + key[len("lins."):]
            if key in sd and not torch.equal(sd[key], value):
                raise ValueError(f"lins/lin entries of {key} differ")
        out[key] = value
    return out


def load_lpips(path: str, net: str = "alex",
               device: Optional[torch.device | str] = None) -> LPIPS:
    """:class:`LPIPS` with an ``lpips`` package state dict read from
    ``path`` (``torch.load(weights_only=True)``), loaded strictly, in
    evaluation mode on ``device`` (the card unless the caller names
    another)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    module = LPIPS(net)
    module.load_state_dict(lpips_state_dict(sd), strict=True)
    return module.to(resolve_device(device)).eval()
