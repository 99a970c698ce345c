"""fp32 normalisation statistics shared by the port's modules.

Counterparts of ``edtr_tpu/ops/_norms.py:ln_f32`` and
``edtr_tpu/ops/gn_conv.py:gn_stats``/``fold_from_moments``: LayerNorm with
torch ``nn.LayerNorm`` semantics in fp32, and fp32 GroupNorm moments
folded with the affine into a per-(B, C) ``(mul, add)``, so that
``x_f32 * mul + add`` is the normalised tensor. Channels are axis 1 (NCHW)
for GroupNorm and the last axis for LayerNorm.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (biased variance, eps inside
    the rsqrt, affine in fp32); returns fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)


def gn_stats(x: torch.Tensor, num_groups: int = 32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, G) fp32 GroupNorm ``(mean_g, var_g)`` (biased variance) of a
    channels-first tensor (B, C, *spatial), without the E[x^2] - E[x]^2
    cancellation. A tensor in channels-last memory is reduced over that
    memory, viewed as a contiguous (B, HW, G, C/G) tensor, by one Welford
    ``var_mean``; any other by :func:`gn_stats_two_pass`. Both equal
    ``gn_stats`` (JAX) to fp32 rounding."""
    if (x.ndim == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        b, c = x.shape[:2]
        xf = x.permute(0, 2, 3, 1).float().reshape(b, -1, num_groups, c // num_groups)
        var_g, mean_g = torch.var_mean(xf, dim=(1, 3), correction=0)
        return mean_g, var_g
    return gn_stats_two_pass(x, num_groups)


def gn_stats_two_pass(x: torch.Tensor, num_groups: int = 32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gn_stats` as ``gn_stats`` (JAX) computes it: two fp32 passes,
    channel sums first, then the groups. On channels-last memory its
    reductions run strided (``chip_smoke.py`` times it there as the
    yardstick of :func:`gn_stats`)."""
    b, c = x.shape[:2]
    g = num_groups
    cg = c // g
    spatial = tuple(range(2, x.ndim))
    count = float(cg * x[0, 0].numel())
    xf = x.float()
    mean_g = xf.sum(dim=spatial).reshape(b, g, cg).sum(-1) / count      # (B, G)
    mean_c = mean_g.repeat_interleave(cg, dim=1).reshape((b, c) + (1,) * len(spatial))
    diff = xf - mean_c
    var_g = (diff * diff).sum(dim=spatial).reshape(b, g, cg).sum(-1) / count
    return mean_g, var_g


def fold_from_moments(mean_g: torch.Tensor, var_g: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) fp32 ``(mul, add)`` from per-(B, G) moments + affine."""
    cg = scale.shape[0] // mean_g.shape[1]
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(cg, dim=1)
    mean_c = mean_g.repeat_interleave(cg, dim=1)
    mul = inv_c * scale.float()[None]
    add = bias.float()[None] - mean_c * mul
    return mul, add
