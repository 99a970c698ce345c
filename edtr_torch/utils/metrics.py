"""Task metrics of the port: top-k accuracy, the segmentation confusion
matrix and its IoU, on tensors (the card's outputs stay on the card).

Counterpart of ``edtr_tpu/utils/metrics.py`` (the reference's
``utils/classification.py:45-61`` and ``utils/segmentation.py:99-108``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Per-batch correct counts for each k: the labels among the ``k``
    highest logits, ties in index order (a stable sort, as ``jnp.argsort``)."""
    maxk = max(topk)
    pred = torch.argsort(-logits, dim=-1, stable=True)[:, :maxk]
    correct = pred == labels.to(pred.device)[:, None]
    return [correct[:, :k].any(dim=1).sum() for k in topk]


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion matrix (rows target, columns prediction),
    ``ignore_index`` left out; ``torch.bincount`` on the tensors' device."""
    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    n = num_classes ** 2
    idx = target.long() * num_classes + pred.to(target.device).long()
    idx = torch.where(target != ignore_index, idx, torch.full_like(idx, n))
    return torch.bincount(idx.reshape(-1), minlength=n + 1)[:n].reshape(num_classes,
                                                                         num_classes)


def compute_iou(mat: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """Per-class IoU (float64) and its mean."""
    mat = torch.as_tensor(mat)
    inter = torch.diag(mat).double()
    union = mat.sum(0) + mat.sum(1) - inter
    iou = inter / torch.clamp(union, min=1)
    return iou, float(iou.mean())
