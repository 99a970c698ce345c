"""The task losses of the training recipes.

Counterpart of ``edtr_tpu/train/recipes.py:34-48``: the classification
cross-entropy (label smoothing 0) and the segmentation cross-entropy over
the pixels whose label is not ``ignore_index`` (255, VOC's border), both in
fp32 and in JAX's layouts: logits (B, K) and (B, H, W, K), labels (B,) and
masks (B, H, W). The rest of that module (``SimpleTrainState``,
``cosine_tx`` and the recipe steps) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``-log_softmax(logits)[label]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def seg_cross_entropy(logits: torch.Tensor, mask: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """The per-pixel cross-entropy of NHWC ``logits`` against ``mask``,
    summed over the pixels not labelled ``ignore_index`` and divided by
    their number (at least 1)."""
    valid = mask != ignore_index
    safe = torch.where(valid, mask, torch.zeros_like(mask)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)
