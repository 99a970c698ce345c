"""The task nets' hooks of the training steps: loss and features.

Counterpart of ``edtr_tpu/train/runner.py:_task_apply_for``:
:func:`task_apply_for` returns ``(loss_fn, feats_fn)`` for "cls", "seg" or
"det", which ``make_edtr_generic_train_step`` and the recipes
(``edtr_torch.train.recipes``) call. The nets hold their parameters and
running statistics, so the functions take the net:

* ``loss_fn(net, images, target, generator=None) -> (loss, metrics)``:
  the net in train mode (batch statistics, its running ones updated in
  place) on NCHW images in [0, 1], ImageNet-normalised: the cross-entropy
  of the logits against labels (B,) (cls), or of the ``out`` logits against
  masks (B, H, W) with 255 ignored (seg), metrics empty, as JAX's; the sum
  of a detector's four losses against its padded targets, its samplers
  drawing from ``generator`` (or the ``uniforms`` given), metrics the four
  losses (det; :func:`det_losses`, which the EDTR step's detector half
  shares);
* ``feats_fn(net, images)``: the feature map the HLF and the feature
  matching compare, on the running statistics: ResNet's layer4 map before
  pooling (cls), DeepLabV3's ``C5`` tap (seg), the FPN's ``"0"`` map (det).
  Only the layers up to the map run: JAX computes the whole net and XLA
  drops the rest.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from edtr_torch.models.resnet import normalize_imagenet
from edtr_torch.train.recipes import cross_entropy, seg_cross_entropy

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
FeatsFn = Callable[[nn.Module, torch.Tensor], torch.Tensor]


def _cls_loss(net: nn.Module, images: torch.Tensor, labels: torch.Tensor,
              generator: Optional[torch.Generator] = None):
    return cross_entropy(net(images, normalize=True, train=True), labels), {}


def _cls_feats(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    return net(images, normalize=True, features=True)[-1]


def _seg_loss(net: nn.Module, images: torch.Tensor, masks: torch.Tensor,
              generator: Optional[torch.Generator] = None):
    logits = net(images, normalize=True, train=True)["out"]
    return seg_cross_entropy(logits.permute(0, 2, 3, 1), masks), {}


def _seg_feats(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    return net.taps(normalize_imagenet(images), train=False)["C5"]


def det_losses(net: nn.Module, images: torch.Tensor, targets: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A detector's training call: (its four losses, its FPN maps of that
    call), the norms on batch statistics and their running ones updated
    (not under ``norm_frozen``), the samplers on ``uniforms`` or drawing
    from ``generator``."""
    _, losses, feats = net(images, targets=targets, train=True, sampler_uniforms=uniforms,
                           generator=generator)
    return losses, feats["features"]


def _det_loss(net: nn.Module, images: torch.Tensor, targets: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              uniforms: Optional[Dict[str, torch.Tensor]] = None):
    losses, _ = det_losses(net, images, targets, generator, uniforms)
    return sum(losses.values()), losses


def _det_feats(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    return net.features(images)["0"]


TASKS = {"cls": (_cls_loss, _cls_feats), "seg": (_seg_loss, _seg_feats),
         "det": (_det_loss, _det_feats)}


def task_apply_for(task: str) -> Tuple[LossFn, FeatsFn]:
    """(loss_fn, feats_fn) of ``task``, "cls", "seg" or "det" (module
    docstring)."""
    if task not in TASKS:
        raise ValueError(f"task {task!r}: one of {sorted(TASKS)}")
    return TASKS[task]
