"""The classification and segmentation task nets' halves of the EDTR step.

Counterpart of ``edtr_tpu/train/runner.py:_task_apply_for`` for "cls" and
"seg" (the detector's half lives in ``edtr_step.DetHalf``):
:func:`task_apply_for` returns ``(loss_fn, feats_fn)`` for
``make_edtr_generic_train_step``. The nets hold their parameters and
running statistics, so the functions take the net:

* ``loss_fn(net, images, target) -> (loss, metrics)``: the net in train
  mode (batch statistics, its running ones updated in place) on NCHW
  images in [0, 1], ImageNet-normalised: the cross-entropy of the logits
  against labels (B,) (cls), or of the ``out`` logits against masks (B, H,
  W) with 255 ignored (seg); metrics empty, as JAX's;
* ``feats_fn(net, images)``: the feature map the HLF and the feature
  matching compare, on the running statistics: ResNet's layer4 map before
  pooling (cls), DeepLabV3's ``C5`` tap (seg). Only the layers up to the
  map run: JAX computes the whole net and XLA drops the rest.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from edtr_torch.models.resnet import normalize_imagenet
from edtr_torch.train.recipes import cross_entropy, seg_cross_entropy

LossFn = Callable[[nn.Module, torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
FeatsFn = Callable[[nn.Module, torch.Tensor], torch.Tensor]


def _cls_loss(net: nn.Module, images: torch.Tensor, labels: torch.Tensor):
    return cross_entropy(net(images, normalize=True, train=True), labels), {}


def _cls_feats(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    return net(images, normalize=True, features=True)[-1]


def _seg_loss(net: nn.Module, images: torch.Tensor, masks: torch.Tensor):
    logits = net(images, normalize=True, train=True)["out"]
    return seg_cross_entropy(logits.permute(0, 2, 3, 1), masks), {}


def _seg_feats(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    return net.taps(normalize_imagenet(images), train=False)["C5"]


TASKS = {"cls": (_cls_loss, _cls_feats), "seg": (_seg_loss, _seg_feats)}


def task_apply_for(task: str) -> Tuple[LossFn, FeatsFn]:
    """(loss_fn, feats_fn) of ``task``, "cls" or "seg" (module docstring)."""
    if task not in TASKS:
        raise ValueError(f"task {task!r}: the generic step takes {sorted(TASKS)}; "
                         "detection is make_edtr_train_step(detnet=...)")
    return TASKS[task]
