"""RoIAlign and multi-scale FPN pooling on static shapes.

Counterpart of ``edtr_tpu/ops/roi_align.py``, batched over images: NCHW
features (B, C, H, W), boxes (B, N, 4). Semantics of ``roi_align(aligned=
False)``: coordinates scaled by ``spatial_scale``, RoI sides at least 1,
``sampling_ratio`` sample points per bin and axis, averaged, zero outside
the map. As in JAX, bilinear sampling is separable: per-RoI weight
matrices along each axis (two nonzeros a sample row, averaged over the
samples) contracted with the features in two products, accumulated in
fp32 and rounded to the feature dtype after each. Stock PyTorch ops, as
the JAX package leaves this to XLA.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _axis_weights(starts: torch.Tensor, bin_size: torch.Tensor, s: int, sr: int,
                  size: int) -> torch.Tensor:
    """Interpolation weights along one axis: starts, bin_size (...,) ->
    (..., S, size). Row i holds the averaged bilinear weights of bin i's
    ``sr`` sample points against the ``size`` feature rows or columns;
    points with coord < -1 or > size contribute zero, others clamp to
    [0, size - 1]."""
    dev = starts.device
    iy = (torch.arange(s, dtype=torch.float32, device=dev)[:, None]
          + (torch.arange(sr, dtype=torch.float32, device=dev)[None, :] + 0.5) / sr
          ).reshape(-1)
    pts = starts[..., None] + iy * bin_size[..., None]            # (..., S*sr)
    outside = (pts < -1.0) | (pts > float(size))
    p = pts.clamp(0.0, size - 1.0)
    i0 = torch.floor(p)
    f = p - i0
    i1 = torch.clamp(i0 + 1.0, max=size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    w = ((grid == i0[..., None]) * (1.0 - f[..., None])
         + (grid == i1[..., None]) * f[..., None])                # (..., S*sr, size)
    w = w.masked_fill(outside[..., None], 0.0)
    return w.unflatten(-2, (s, sr)).mean(dim=-2)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """feat (B, C, H, W), boxes (B, N, 4) -> (B, N, C, S, S) in feat's dtype.

    The rows product (B, N·S, H) x (B, H, C·W) and the columns product per
    RoI (S·C, W) x (W, S) both accumulate in fp32 and are rounded to the
    feature dtype, JAX's two einsums."""
    b_, c, h, w = feat.shape
    n, s = boxes.shape[1], output_size
    b = boxes * spatial_scale
    x1, y1 = b[..., 0], b[..., 1]
    roi_w = torch.clamp(b[..., 2] - x1, min=1.0)
    roi_h = torch.clamp(b[..., 3] - y1, min=1.0)
    wy = _axis_weights(y1, roi_h / s, s, sampling_ratio, h).to(feat.dtype)  # (B, N, S, H)
    wx = _axis_weights(x1, roi_w / s, s, sampling_ratio, w).to(feat.dtype)  # (B, N, S, W)
    rows = torch.bmm(wy.reshape(b_, n * s, h), feat.permute(0, 2, 1, 3).reshape(b_, h, c * w))
    rows = rows.reshape(b_ * n, s * c, w)                                   # (B·N, S·C, W)
    out = torch.bmm(rows, wx.reshape(b_ * n, s, w).transpose(1, 2))         # (B·N, S·C, X)
    return out.reshape(b_, n, s, c, s).permute(0, 1, 3, 2, 4)


def fpn_level_for_rois(boxes: torch.Tensor, k_min: int, k_max: int,
                       canonical_scale: int = 224, canonical_level: int = 4) -> torch.Tensor:
    """torchvision's LevelMapper: floor(k0 + log2(sqrt(area) / 224)),
    clamped to [k_min, k_max], as an index from k_min."""
    area = torch.clamp((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1]),
                       min=1e-6)
    target = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_scale
                                                      + 1e-6))
    return target.clamp(k_min, k_max).to(torch.int32) - k_min


def multiscale_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                         spatial_scales: Sequence[float], output_size: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """``MultiScaleRoIAlign`` over FPN maps (B, C, H_l, W_l), boxes (B, N, 4)
    -> (B, N, C, S, S): each RoI pools from the level the area heuristic
    picks. As in JAX, every level is pooled and the levels are combined by
    mask (static shapes)."""
    k_levels = [int(-math.log2(sc)) for sc in spatial_scales]
    levels = fpn_level_for_rois(boxes, k_levels[0], k_levels[-1])
    out = None
    for li, (feat, sc) in enumerate(zip(feats, spatial_scales)):
        pooled = roi_align(feat, boxes, sc, output_size, sampling_ratio)
        contrib = pooled.masked_fill((levels != li)[..., None, None, None], 0.0)
        out = contrib if out is None else out + contrib
    return out
