"""RRDBNet (the ESRGAN/BSRGAN super-resolution net), NCHW.

Counterpart of ``edtr_tpu/models/bsrnet.py``, which no config uses: five
densely connected convs a block (LeakyReLU 0.2, residual x 0.2), three
blocks an RRDB, ``nb`` RRDBs, the trunk conv, then nearest-2x + conv once
(``sf`` 2) or twice (``sf`` 4), ``HRconv`` and ``conv_last``. With
``unshuffle`` the input is pixel-unshuffled by ``unshuffle_scale`` first.
Stock PyTorch ops, as JAX leaves the net to XLA.

Parameter names are the reference state-dict keys (``conv_first`` or
``conv_first.1``, ``RRDB_trunk.{i}.RDB{j}.conv{k}``, ``trunk_conv``,
``upconv1``/``upconv2``, ``HRconv``, ``conv_last``), read by
``edtr_tpu/utils/convert.py:convert_rrdbnet``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.models.layers import Conv2d


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"conv{k}", Conv2d(nf + (k - 1) * gc, gc, 3, padding=1, dtype=dtype))
        self.conv5 = Conv2d(nf + 4 * gc, nf, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(_lrelu(getattr(self, f"conv{k}")(torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc, dtype)
        self.RDB2 = ResidualDenseBlock5C(nf, gc, dtype)
        self.RDB3 = ResidualDenseBlock5C(nf, gc, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """(B, in_nc, H, W) -> (B, out_nc, H * s, W * s), ``s`` = ``sf`` (4:
    two upsamplings, else one) divided by ``unshuffle_scale`` with
    ``unshuffle``."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, sf: int = 4, unshuffle: bool = False,
                 unshuffle_scale: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.sf = sf
        if unshuffle:
            s = unshuffle_scale
            self.conv_first = nn.Sequential(nn.PixelUnshuffle(s),
                                            Conv2d(in_nc * s * s, nf, 3, padding=1, dtype=dtype))
        else:
            self.conv_first = Conv2d(in_nc, nf, 3, padding=1, dtype=dtype)
        self.RRDB_trunk = nn.Sequential(*(RRDB(nf, gc, dtype) for _ in range(nb)))
        self.trunk_conv = Conv2d(nf, nf, 3, padding=1, dtype=dtype)
        self.upconv1 = Conv2d(nf, nf, 3, padding=1, dtype=dtype)
        if sf == 4:
            self.upconv2 = Conv2d(nf, nf, 3, padding=1, dtype=dtype)
        self.HRconv = Conv2d(nf, nf, 3, padding=1, dtype=dtype)
        self.conv_last = Conv2d(nf, out_nc, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        ups = (self.upconv1, self.upconv2) if self.sf == 4 else (self.upconv1,)
        for conv in ups:
            fea = _lrelu(conv(F.interpolate(fea, scale_factor=2, mode="nearest")))
        return self.conv_last(_lrelu(self.HRconv(fea)))
