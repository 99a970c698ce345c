"""Differentiable JPEG round trip of the port, batched, on the card (NCHW).

Counterpart of ``edtr_tpu/data/diffjpeg.py``: RGB -> YCbCr, 2x2 chroma
average, 8x8 block DCT as one fp32 product with the 8x8x8x8 cosine table,
the luminance/chrominance tables scaled by a per-sample quality factor,
rounding (half to even, as ``jnp.round``; the cubic soft round when
``differentiable``), the inverse DCT, nearest chroma upsampling and
YCbCr -> RGB. Inputs are padded with zeros to a multiple of 16 and cropped
back. JAX's functions take NHWC; :func:`diff_jpeg` takes the transform's
NCHW.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# standard JPEG quantization tables, transposed: the DCT's (u, v) has u on rows
Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32).T

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([
    [17, 18, 24, 47],
    [18, 21, 26, 66],
    [24, 26, 56, 99],
    [47, 66, 99, 99],
], dtype=np.float32)
C_TABLE = C_TABLE.T

RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], np.float32)
YCC_TO_RGB = np.array([[1.0, 0.0, 1.402],
                       [1.0, -0.344136, -0.714136],
                       [1.0, 1.772, 0.0]], np.float32)
YCC_OFFSET = np.array([0.0, 128.0, 128.0], np.float32)


@lru_cache()
def _dct_tensor() -> Tuple[np.ndarray, np.ndarray]:
    t = np.zeros((8, 8, 8, 8), dtype=np.float32)
    for x, y, u, v in itertools.product(range(8), repeat=4):
        t[x, y, u, v] = np.cos((2 * x + 1) * u * np.pi / 16) * np.cos(
            (2 * y + 1) * v * np.pi / 16)
    alpha = np.array([1.0 / np.sqrt(2)] + [1] * 7, dtype=np.float32)
    scale = np.outer(alpha, alpha) * 0.25
    return t, scale


_TABLES: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _table(name: str, device: torch.device) -> torch.Tensor:
    """The constant tables on ``device``, copied there once."""
    key = (name, device)
    if key not in _TABLES:
        t, scale = _dct_tensor()
        host = {"dct": t.reshape(64, 64), "scale": scale, "y": Y_TABLE, "c": C_TABLE,
                "rgb2ycc": RGB_TO_YCC, "ycc2rgb": YCC_TO_RGB, "offset": YCC_OFFSET}[name]
        _TABLES[key] = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    return _TABLES[key]


def quality_to_factor(quality: Union[float, torch.Tensor]) -> torch.Tensor:
    """Standard IJG quality -> scale factor (quality 100 clamped to 1/255)."""
    quality = torch.as_tensor(quality, dtype=torch.float32)
    factor = torch.where(quality < 50, 5000.0 / quality, 200.0 - quality * 2) / 100.0
    return torch.clamp(factor, min=1.0 / 255.0)


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W) in [0, 255] -> YCbCr with the +128 chroma offset."""
    m, off = _table("rgb2ycc", x.device), _table("offset", x.device)
    return torch.einsum("bchw,dc->bdhw", x, m) + off.view(1, 3, 1, 1)


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    m, off = _table("ycc2rgb", x.device), _table("offset", x.device)
    return torch.einsum("bchw,dc->bdhw", x - off.view(1, 3, 1, 1), m)


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/8 * W/8, 8, 8)."""
    b, h, w = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _unblockify(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    return x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h, w)


def block_dct(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) pixel blocks -> DCT coefficients (u, v), one fp32 product."""
    lead = blocks.shape[:-2]
    out = (blocks - 128.0).reshape(-1, 64) @ _table("dct", blocks.device)
    return out.reshape(*lead, 8, 8) * _table("scale", blocks.device)


def block_idct(coefs: torch.Tensor) -> torch.Tensor:
    """Type-III DCT: f(x, y) = 1/4 sum_uv a(u) a(v) F(u, v) cos(..u..) cos(..v..)."""
    lead = coefs.shape[:-2]
    alpha2 = _table("scale", coefs.device) * 4.0
    x = (coefs * alpha2).reshape(-1, 64) @ _table("dct", coefs.device).t()
    return 0.25 * x.reshape(*lead, 8, 8) + 128.0


def _quantize(coefs, table, factor, differentiable):
    q = table[None, None] * factor[:, None, None, None]
    scaled = coefs / q
    rounded = torch.round(scaled)
    if differentiable:  # cubic soft round
        rounded = rounded + (scaled - rounded) ** 3
    return rounded * q


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _upsample_2x2(x: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    return x[:, :, None, :, None].expand(b, h, 2, w, 2).reshape(b, h * 2, w * 2)


def diff_jpeg(x: torch.Tensor, quality: Union[float, torch.Tensor] = 75,
              differentiable: bool = False) -> torch.Tensor:
    """JPEG round trip of an NCHW [0, 1] RGB batch; ``quality`` a number or
    a (B,) tensor on ``x``'s device."""
    b, c, h, w = x.shape
    assert c == 3
    factor = quality_to_factor(quality).to(x.device).expand(b)
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    xp = F.pad(x, (0, pw, 0, ph))
    ycc = rgb_to_ycbcr(xp * 255.0)
    y, cb, cr = ycc[:, 0], _avg_pool_2x2(ycc[:, 1]), _avg_pool_2x2(ycc[:, 2])
    comps = []
    for comp, table in ((y, "y"), (cb, "c"), (cr, "c")):
        coefs = block_dct(_blockify(comp))
        deq = _quantize(coefs, _table(table, x.device), factor, differentiable)
        comps.append(_unblockify(block_idct(deq), comp.shape[1], comp.shape[2]))
    ycc_rec = torch.stack([comps[0], _upsample_2x2(comps[1]), _upsample_2x2(comps[2])], 1)
    rgb = torch.clamp(ycbcr_to_rgb(ycc_rec) / 255.0, 0.0, 1.0)
    return rgb[:, :, :h, :w]


class DiffJPEG:
    """The reference's call surface: ``jpeger(x, quality=q)``."""

    def __init__(self, differentiable: bool = False):
        self.differentiable = differentiable

    def __call__(self, x: torch.Tensor, quality=75) -> torch.Tensor:
        return diff_jpeg(x, quality, self.differentiable)
