"""Box operations of the detector, on static shapes.

Counterpart of ``edtr_tpu/ops/boxes.py``: fixed-size
padded box tensors with validity masks, never a shape that depends on the
data. Boxes are (x1, y1, x2, y2) in pixels, tensors of shape (..., N, 4).
These are stock PyTorch ops, as the JAX package leaves them to XLA.

Orders follow JAX's exactly: ``jax.lax.top_k`` and ``jnp.argsort`` put
equal values lowest index first, which ``torch.topk`` does not promise, so
every ranking here is a stable descending sort. NMS is JAX's greedy
fixpoint ``keep <- valid & ~any(sup & keep)``, batched over rows, iterated
on the device and checked for convergence on the host once every
:data:`NMS_CHECK_EVERY` iterations; :data:`host_syncs` counts the checks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# torchvision's BoxCoder clamp, log(1000 / 16) rounded to fp32 as JAX holds it
BBOX_XFORM_CLIP = float(np.float32(math.log(1000.0 / 16)))

# fixpoint iterations run on the device between two convergence checks; the
# iterations after the fixpoint change nothing, so the check only ends the loop
NMS_CHECK_EVERY = 8

# NMS calls and their host synchronisations (convergence checks) since the
# caller last set them to 0
host_syncs = {"calls": 0, "syncs": 0}


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU over leading batch axes: a (..., N, 4), b (..., M, 4)
    -> (..., N, M), JAX's arithmetic in JAX's order."""
    area_a = box_area(a)[..., :, None]
    area_b = box_area(b)[..., None, :]
    w = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
         - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp_(min=0)
    h = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
         - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp_(min=0)
    inter = w * h
    return inter / (area_a + area_b - inter).clamp_(min=1e-9)


def clip_boxes_to_image(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True for boxes with both sides >= ``min_size``."""
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & (
        (boxes[..., 3] - boxes[..., 1]) >= min_size)


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor,
                 weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """The regression targets of ``gt`` against ``anchors`` or proposals
    (``BoxCoder.encode``): both (..., N, 4) -> deltas (..., N, 4), widths
    floored at 1e-9 as JAX floors them."""
    wx, wy, ww, wh = weights
    pw = anchors[..., 2] - anchors[..., 0]
    ph = anchors[..., 3] - anchors[..., 1]
    pcx = anchors[..., 0] + 0.5 * pw
    pcy = anchors[..., 1] + 0.5 * ph
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    pw, ph = pw.clamp(min=1e-9), ph.clamp(min=1e-9)
    return torch.stack([wx * (gcx - pcx) / pw, wy * (gcy - pcy) / ph,
                        ww * torch.log(gw.clamp(min=1e-9) / pw),
                        wh * torch.log(gh.clamp(min=1e-9) / ph)], dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Deltas applied to anchors or proposals (``BoxCoder.decode``):
    deltas (..., N, K*4), boxes (..., N, 4) -> (..., N, K, 4)."""
    wx, wy, ww, wh = weights
    deltas = deltas.unflatten(-1, (-1, 4))
    pw = (boxes[..., 2] - boxes[..., 0])[..., None]
    ph = (boxes[..., 3] - boxes[..., 1])[..., None]
    pcx = boxes[..., 0][..., None] + 0.5 * pw
    pcy = boxes[..., 1][..., None] + 0.5 * ph
    cx = deltas[..., 0] / wx * pw + pcx
    cy = deltas[..., 1] / wy * ph + pcy
    w = torch.exp((deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)) * pw
    h = torch.exp((deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def _descending(scores: torch.Tensor) -> torch.Tensor:
    """Indices of ``scores`` (..., N) largest first, equal values lowest
    index first (``jax.lax.top_k`` and ``jnp.argsort`` of the negation)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def top_k_by_score(scores: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices and validity of the top ``k`` of ``scores`` (..., N) along
    the last axis; invalid entries score -inf and come out invalid."""
    masked = scores if valid is None else scores.masked_fill(~valid, -math.inf)
    idx = _descending(masked)[..., :k]
    return idx, torch.isfinite(masked.gather(-1, idx))


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep mask of each row: boxes (..., N, 4), scores and
    ``valid`` (..., N) -> (..., N) bool, aligned with the unsorted inputs.

    Each row is sorted by score (invalid last), box j suppresses a later box
    i where their IoU exceeds the threshold and j is valid, and
    ``keep <- valid & ~any(sup & keep)`` runs to its fixpoint, which is the
    greedy keep set (JAX's ``nms_mask``; JAX packs ``sup`` into bits for N >
    256 to save memory, with the same keep set). The iterations run on the
    device; every :data:`NMS_CHECK_EVERY` of them the host reads whether the
    last one changed anything, at most N iterations in all, JAX's cap."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    order = _descending(scores.masked_fill(~valid, -math.inf))
    sb = boxes.gather(-2, order[..., None].expand(order.shape + (4,)))
    sv = valid.gather(-1, order)
    earlier = torch.ones((n, n), dtype=torch.bool, device=boxes.device).tril_(-1)
    sup = (box_iou(sb, sb) > iou_threshold) & earlier & sv[..., None, :]
    keep, it = sv, 0
    host_syncs["calls"] += 1
    while it < n:
        for _ in range(min(NMS_CHECK_EVERY, n - it)):
            prev, keep = keep, sv & ~(sup & keep[..., None, :]).any(-1)
            it += 1
        host_syncs["syncs"] += 1
        if not bool((keep != prev).any()):
            break
    return torch.zeros_like(keep).scatter_(-1, order, keep)


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                     iou_threshold: float, valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Category-aware NMS by the coordinate offset (torchvision's
    ``batched_nms``): boxes of different ``idxs`` never overlap."""
    kept = boxes if valid is None else boxes.masked_fill(~valid[..., None], 0.0)
    max_coord = kept.amax(dim=(-2, -1), keepdim=True) + 1.0
    shifted = boxes + (idxs.to(boxes.dtype)[..., None] * max_coord)
    return nms_mask(shifted, scores, iou_threshold, valid)
