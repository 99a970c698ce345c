"""SCUNet, the Swin-Conv UNet denoiser, NCHW.

Counterpart of ``edtr_tpu/models/scunet.py``, which no config uses: the
input edge-padded to a multiple of 64, a head conv, three downs (blocks,
then a 2x2 stride-2 conv), the body, three ups (a 2x2 stride-2 transposed
conv, then blocks) with additive skips, and the tail conv, cropped back. A
block (:class:`ConvTransBlock`) splits a 1x1 conv's output into a residual
conv pair and a Swin block (:class:`SwinBlock`), concatenated and mixed
back by a 1x1 conv. Its window attention (:class:`WMSA`) has a per-head
learnable ``(2p - 1)²`` relative-embedding grid and boolean shift masks;
the odd blocks of a stage whose resolution is above the window (8) shift
by half a window. Plain PyTorch, as JAX's is plain XLA.

Parameter names are the reference state-dict keys (``m_head.0``,
``m_down1.{i}.{conv1_1,conv1_2,conv_block.{0,2},trans_block.{ln1,ln2,
msa.embedding_layer,msa.relative_position_params,msa.linear,mlp.{0,2}}}``,
``m_down1.{n}`` the pool conv, ``m_up3.0`` the transposed conv,
``m_tail.0``), read by ``edtr_tpu/utils/convert.py:convert_scunet``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.models.layers import Conv2d, LayerNorm, Linear

HEAD_DIM = 32
WINDOW = 8


@lru_cache(maxsize=8)
def _rel_index(p: int, device: torch.device) -> torch.Tensor:
    cord = np.array([[i, j] for i in range(p) for j in range(p)])
    rel = cord[:, None, :] - cord[None, :, :] + p - 1
    return torch.as_tensor(rel, dtype=torch.long, device=device)


@lru_cache(maxsize=16)
def shift_mask(h_windows: int, w_windows: int, p: int, shift: int,
               device: torch.device) -> torch.Tensor:
    """Boolean (nW, p², p²) mask of the shifted windows, True where
    blocked."""
    m = np.zeros((h_windows, w_windows, p, p, p, p), bool)
    s = p - shift
    m[-1, :, :s, :, s:, :] = True
    m[-1, :, s:, :, :s, :] = True
    m[:, -1, :, :s, :, s:] = True
    m[:, -1, :, s:, :, :s] = True
    return torch.as_tensor(m.reshape(h_windows * w_windows, p * p, p * p), device=device)


class WMSA(nn.Module):
    """Window (or shifted-window) multi-head self-attention over NHWC."""

    def __init__(self, dim: int, head_dim: int = HEAD_DIM, window_size: int = WINDOW,
                 shifted: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.head_dim, self.p, self.shifted = dim, head_dim, window_size, shifted
        heads = dim // head_dim
        self.embedding_layer = Linear(dim, 3 * dim, dtype=dtype)
        self.relative_position_params = nn.Parameter(
            torch.randn(heads, 2 * window_size - 1, 2 * window_size - 1) * 0.02)
        self.linear = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p, hd = self.p, self.head_dim
        heads = self.dim // hd
        shifted = self.shifted and h > p
        if shifted:
            x = torch.roll(x, (-(p // 2), -(p // 2)), dims=(1, 2))
        hw, ww = h // p, w // p
        xw = x.reshape(b, hw, p, ww, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hw * ww, p * p, c)
        q, k, v = self.embedding_layer(xw).reshape(b, hw * ww, p * p, 3, heads, hd).unbind(3)
        sim = torch.einsum("bwphc,bwqhc->bhwpq", q, k).float() * hd ** -0.5
        rel = _rel_index(p, x.device)
        table = self.relative_position_params
        sim = sim + table[:, rel[..., 0], rel[..., 1]].float()[None, :, None]
        if shifted:
            sim = sim.masked_fill(shift_mask(hw, ww, p, p // 2, x.device)[None, None],
                                  float("-inf"))
        probs = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhwpq,bwqhc->bwphc", probs, v).reshape(b, hw * ww, p * p, self.dim)
        out = self.linear(out).reshape(b, hw, ww, p, p, self.dim).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, self.dim)
        if shifted:
            out = torch.roll(out, (p // 2, p // 2), dims=(1, 2))
        return out


class SwinBlock(nn.Module):
    """LN + (S)W-MSA and LN + GELU MLP (4x), each residual, over NHWC."""

    def __init__(self, dim: int, head_dim: int = HEAD_DIM, window_size: int = WINDOW,
                 shifted: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.msa = WMSA(dim, head_dim, window_size, shifted, dtype)
        self.ln2 = LayerNorm(dim)
        self.mlp = nn.Sequential(Linear(dim, 4 * dim, dtype=dtype), nn.GELU(),
                                 Linear(4 * dim, dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.msa(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ConvTransBlock(nn.Module):
    def __init__(self, conv_dim: int, trans_dim: int, shifted: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_dim = conv_dim
        c = conv_dim + trans_dim
        self.conv1_1 = Conv2d(c, c, 1, dtype=dtype)
        self.conv1_2 = Conv2d(c, c, 1, dtype=dtype)
        self.conv_block = nn.Sequential(
            Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False, dtype=dtype), nn.ReLU(),
            Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False, dtype=dtype))
        self.trans_block = SwinBlock(trans_dim, HEAD_DIM, WINDOW, shifted, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_x, trans_x = torch.split(self.conv1_1(x), [self.conv_dim, x.shape[1] - self.conv_dim],
                                      dim=1)
        conv_x = conv_x + self.conv_block(conv_x)
        trans_x = self.trans_block(trans_x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + self.conv1_2(torch.cat([conv_x, trans_x], 1))


class ConvTranspose2x(nn.Module):
    """2x2 stride-2 transposed conv without bias (``nn.ConvTranspose2d``'s
    (in, out, 2, 2) weight), computed in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.randn(in_channels, out_channels, 2, 2)
                                   * (4 * in_channels) ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), stride=2)


def _stage(n: int, cdim: int, tdim: int, resolution: int, dtype) -> list:
    return [ConvTransBlock(cdim, tdim, bool(i % 2) and resolution > WINDOW, dtype)
            for i in range(n)]


class SCUNet(nn.Module):
    """(B, in_nc, H, W) -> (B, in_nc, H, W). ``input_resolution`` decides
    which blocks shift (the stages at and below the window do not), as the
    reference's constructor does; ``drop_path_rate`` is the reference's
    training knob, inert here as in JAX."""

    def __init__(self, in_nc: int = 3, config: Sequence[int] = (2, 2, 2, 2, 2, 2, 2),
                 dim: int = 64, drop_path_rate: float = 0.0, input_resolution: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, r = dim, input_resolution
        self.m_head = nn.Sequential(Conv2d(in_nc, d, 3, padding=1, bias=False, dtype=dtype))
        downs = ((d // 2, r), (d, r // 2), (2 * d, r // 4))
        for i, (half, res) in enumerate(downs):
            setattr(self, f"m_down{i + 1}", nn.Sequential(
                *_stage(config[i], half, half, res, dtype),
                Conv2d(2 * half, 4 * half, 2, stride=2, bias=False, dtype=dtype)))
        self.m_body = nn.Sequential(*_stage(config[3], 4 * d, 4 * d, r // 8, dtype))
        ups = ((8 * d, 2 * d, r // 4), (4 * d, d, r // 2), (2 * d, d // 2, r))
        for i, (cin, half, res) in enumerate(ups):
            setattr(self, f"m_up{3 - i}", nn.Sequential(
                ConvTranspose2x(cin, 2 * half, dtype),
                *_stage(config[4 + i], half, half, res, dtype)))
        self.m_tail = nn.Sequential(Conv2d(d, in_nc, 3, padding=1, bias=False, dtype=dtype))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        h, w = x0.shape[-2:]
        ph, pw = (64 - h % 64) % 64, (64 - w % 64) % 64
        if ph or pw:
            x0 = F.pad(x0, (0, pw, 0, ph), mode="replicate")
        x1 = self.m_head(x0)
        x2 = self.m_down1(x1)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        x = self.m_up3(self.m_body(x4) + x4)
        x = self.m_up2(x + x3)
        x = self.m_up1(x + x2)
        return self.m_tail(x + x1)[..., :h, :w]
