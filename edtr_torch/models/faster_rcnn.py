"""Faster R-CNN MobileNetV3-Large-FPN (NCHW, static shapes).

Counterpart of ``edtr_tpu/models/faster_rcnn.py`` for the MobileNet
variant the flagship detects with (``fasterrcnn_mobilenet_v3_large_fpn``,
``bench.py``): transform (normalise, resize, pad), MobileNetV3 body, FPN
(two levels and a stride-2 ``pool`` level), anchors, RPN head and
proposals, multi-scale RoIAlign, two-MLP box head, predictor and the
detections' post-processing. As in JAX every shape is static: proposals
and detections are padded tensors with validity masks and every top-k size
is fixed, so no shape depends on the data. Parameter names are
torchvision's (``backbone.body.features...``, ``backbone.fpn...``,
``rpn.head...``, ``roi_heads.box_head.fc6``...); pooled RoIs flatten
channel-major as torchvision flattens them.

Numerics as in JAX: fp32 params; the body, FPN, heads compute in ``dtype``;
the backbone's norms in fp32; head outputs, boxes, scores and NMS in fp32;
the FPN maps and pooled RoIs in ``dtype``.

Training (``forward(images, targets=...)``), as JAX's ``targets is not
None`` branches: the boxes resized with the image, the train-mode proposal
counts, anchor matching (:func:`match_boxes`) and balanced sampling
(:func:`balanced_sample`) for the RPN loss, the GT boxes appended to the
detached proposals and the sampled ones gathered first for the box head's
loss. ``train=True`` runs the body's BatchNorms on batch statistics and
updates their running ones, unless ``norm_frozen``. The sampler's uniform
draws can be given (``sampler_uniforms``) or come from ``generator``.
:func:`detnet_trainable_mask` freezes the body's early stages as
torchvision's ``trainable_layers`` does.

Not ported yet: the ResNet50-FPN-v2 variant (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.device import resolve_device
from edtr_torch.models.layers import Conv2d, Linear, calibrate_unit_rms_
from edtr_torch.models.mobilenetv3 import MobileNetV3
from edtr_torch.ops import boxes as box_ops
from edtr_torch.ops.roi_align import multiscale_roi_align

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)


class RCNNTransform(nn.Module):
    """Normalise, resize and pad (``GeneralizedRCNNTransform``, static):
    every image of a batch has one (H, W), so one bilinear resize serves
    them all, its scale taken from the static shape."""

    def __init__(self, min_size: int = 800, max_size: int = 1333,
                 image_mean: Sequence[float] = IMAGENET_MEAN,
                 image_std: Sequence[float] = IMAGENET_STD, size_divisible: int = 32):
        super().__init__()
        self.min_size, self.max_size = min_size, max_size
        self.size_divisible = size_divisible
        self.register_buffer("image_mean", torch.tensor(image_mean), persistent=False)
        self.register_buffer("image_std", torch.tensor(image_std), persistent=False)

    def scale_for(self, h: int, w: int) -> float:
        scale = self.min_size / min(h, w)
        if scale * max(h, w) > self.max_size:
            scale = self.max_size / max(h, w)
        return scale

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(x - mean) / std in the images' dtype."""
        mean = self.image_mean.to(images.dtype)[:, None, None]
        std = self.image_std.to(images.dtype)[:, None, None]
        return (images - mean) / std

    def resize(self, images: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int], float]:
        """(B, C, H, W) -> (resized and zero-padded to a multiple of
        ``size_divisible``, the resized (h, w), the scale). Bilinear with
        half-pixel centres, antialiased when it shrinks: what
        ``jax.image.resize(..., "bilinear")`` computes either way."""
        h, w = images.shape[-2:]
        scale = self.scale_for(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        images = F.interpolate(images, size=(nh, nw), mode="bilinear", align_corners=False,
                               antialias=scale < 1)
        d = self.size_divisible
        return F.pad(images, (0, -nw % d, 0, -nh % d)), (nh, nw), scale


class FeaturePyramidNetwork(nn.Module):
    """1x1 inner convs, top-down nearest upsample + add, 3x3 layer convs,
    and the extra ``pool`` level (torchvision's LastLevelMaxPool: kernel 1,
    stride 2, a plain subsample); no norms."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(Conv2d(c, out_channels, 1, dtype=dtype)) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype))
            for _ in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        inner = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        results = [inner[-1]]
        for t in reversed(inner[:-1]):
            last = results[0]
            if last.shape[-2:] != t.shape[-2:]:  # JAX's nearest: half-pixel centres
                last = F.interpolate(last, size=t.shape[-2:], mode="nearest-exact")
            results.insert(0, t + last)
        outs = [blk(r) for blk, r in zip(self.layer_blocks, results)]
        return outs + [outs[-1][:, :, ::2, ::2]]


def generate_anchors(feat_shapes: Sequence[Tuple[int, int]],
                     strides: Sequence[Tuple[int, int]],
                     sizes: Sequence[Sequence[int]],
                     aspect_ratios: Sequence[Sequence[float]]) -> List[np.ndarray]:
    """Per-level anchor grids (host numpy, (H·W·A, 4)): cell anchors
    aspect-ratio-major, rounded half to even, shifted over the grid,
    shifts outer and cell anchors inner (``AnchorGenerator``)."""
    out = []
    for (fh, fw), (stride_y, stride_x), szs, ars in zip(
            feat_shapes, strides, sizes, aspect_ratios):
        cell = []
        for ar in ars:
            hr = math.sqrt(ar)
            wr = 1.0 / hr
            for s in szs:
                cell.append([-wr * s / 2, -hr * s / 2, wr * s / 2, hr * s / 2])
        cell = np.round(np.asarray(cell, np.float32))
        ys = np.arange(fh, dtype=np.float32) * stride_y
        xs = np.arange(fw, dtype=np.float32) * stride_x
        shift_x, shift_y = np.meshgrid(xs, ys)
        shifts = np.stack([shift_x.ravel(), shift_y.ravel(),
                           shift_x.ravel(), shift_y.ravel()], axis=1)
        out.append((shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4))
    return out


class RPNHead(nn.Module):
    """3x3 conv + relu (``conv.0.0``), then objectness and box deltas, both
    fp32, per level as (B, A, H, W) and (B, 4A, H, W)."""

    def __init__(self, channels: int, num_anchors: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Sequential(nn.Sequential(
            Conv2d(channels, channels, 3, padding=1, dtype=dtype)))
        self.cls_logits = Conv2d(channels, num_anchors, 1, dtype=dtype)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1, dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, deltas = [], []
        for f in feats:
            t = f
            for conv in self.conv:
                t = torch.relu(conv(t))
            logits.append(self.cls_logits(t).float())
            deltas.append(self.bbox_pred(t).float())
        return logits, deltas


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, representation_size: int = 1024,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc6 = Linear(in_features, representation_size, dtype=dtype)
        self.fc7 = Linear(representation_size, representation_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc7(torch.relu(self.fc6(x.flatten(1)))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes, dtype=dtype)
        self.bbox_pred = Linear(in_features, num_classes * 4, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x).float(), self.bbox_pred(x).float()


BELOW_LOW = -1
BETWEEN = -2


def match_boxes(iou: torch.Tensor, high: float, low: float, allow_low_quality: bool,
                gt_valid: torch.Tensor) -> torch.Tensor:
    """torchvision's ``Matcher``, batched: ``iou`` (..., G, N) GT x
    candidates, ``gt_valid`` (..., G) -> (..., N) the best GT's index, or
    :data:`BELOW_LOW` under ``low``, :data:`BETWEEN` in [low, high). The
    best is the first maximum; with ``allow_low_quality`` a candidate that
    is a (tied, by ``==``) best for any valid GT keeps its best GT whatever
    its IoU (``set_low_quality_matches_``)."""
    iou = iou.masked_fill(~gt_valid[..., None], -1.0)
    best_val, best_gt = iou.max(dim=-2)
    matches = best_gt.masked_fill(best_val < low, BELOW_LOW)
    matches = matches.masked_fill((best_val >= low) & (best_val < high), BETWEEN)
    if allow_low_quality:
        is_best = (iou == iou.amax(dim=-1, keepdim=True)) & gt_valid[..., None]
        matches = torch.where(is_best.any(dim=-2), best_gt, matches)
    return matches


def _pick(u: torch.Tensor, mask: torch.Tensor, k) -> torch.Tensor:
    """The first ``k`` of ``mask``'s candidates in the order of their
    uniforms ``u`` (a stable sort: ties by index)."""
    n = mask.shape[-1]
    order = torch.sort(u + (~mask) * 10.0, dim=-1, stable=True).indices
    pos = torch.arange(n, device=u.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(-1, order, pos)
    avail = mask.sum(-1, keepdim=True)
    k = avail.clamp(max=k) if isinstance(k, int) else torch.minimum(k, avail)
    return mask & (ranks < k)


def balanced_sample(pos: torch.Tensor, neg: torch.Tensor, batch_size: int,
                    fraction: float, u_pos: torch.Tensor, u_neg: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchvision's ``BalancedPositiveNegativeSampler`` on static shapes,
    batched over leading axes: masks (..., N) of the sampled positives (at
    most ``int(batch_size * fraction)``) and negatives (the rest of
    ``batch_size``), each picked in the order of its uniform draws (..., N)
    as JAX's ``balanced_sample`` picks them."""
    sampled_pos = _pick(u_pos, pos, int(batch_size * fraction))
    n_pos = sampled_pos.sum(-1, keepdim=True)
    return sampled_pos, _pick(u_neg, neg, batch_size - n_pos)


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits, JAX's form."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def _nhwc_flat(t: torch.Tensor, last: int) -> torch.Tensor:
    """A head output (B, A·last, H, W) flattened in JAX's NHWC order,
    index (h·W + w)·A + a, which is the anchors' order: (B, H·W·A, last)."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, last)


class FasterRCNN(nn.Module):
    """The MobileNetV3-Large-FPN detector. :meth:`forward` takes (B, 3, H, W)
    images in [0, 1] and returns ``(detections, losses, feats)`` as JAX's
    ``__call__`` does. The fields are JAX's (its ``box_pre_nms_top_n`` is
    not ported)."""

    def __init__(self, num_classes: int = 91, min_size: int = 800, max_size: int = 1333,
                 rpn_pre_nms_top_n_train: int = 2000, rpn_pre_nms_top_n_test: int = 1000,
                 rpn_post_nms_top_n_train: int = 2000, rpn_post_nms_top_n_test: int = 1000,
                 rpn_nms_thresh: float = 0.7, rpn_fg_iou_thresh: float = 0.7,
                 rpn_bg_iou_thresh: float = 0.3, rpn_batch_size_per_image: int = 256,
                 rpn_positive_fraction: float = 0.5, rpn_score_thresh: float = 0.0,
                 box_score_thresh: float = 0.05, box_nms_thresh: float = 0.5,
                 box_detections_per_img: int = 100, box_fg_iou_thresh: float = 0.5,
                 box_bg_iou_thresh: float = 0.5, box_batch_size_per_image: int = 512,
                 box_positive_fraction: float = 0.25,
                 bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0),
                 norm_frozen: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.rpn_pre_nms_top_n = dict(train=rpn_pre_nms_top_n_train,
                                      test=rpn_pre_nms_top_n_test)
        self.rpn_post_nms_top_n = dict(train=rpn_post_nms_top_n_train,
                                       test=rpn_post_nms_top_n_test)
        self.rpn_nms_thresh, self.rpn_score_thresh = rpn_nms_thresh, rpn_score_thresh
        self.rpn_iou_thresh = (rpn_fg_iou_thresh, rpn_bg_iou_thresh)
        self.rpn_batch_size_per_image = rpn_batch_size_per_image
        self.rpn_positive_fraction = rpn_positive_fraction
        self.box_score_thresh, self.box_nms_thresh = box_score_thresh, box_nms_thresh
        self.box_detections_per_img = box_detections_per_img
        self.box_iou_thresh = (box_fg_iou_thresh, box_bg_iou_thresh)
        self.box_batch_size_per_image = box_batch_size_per_image
        self.box_positive_fraction = box_positive_fraction
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        # FrozenBatchNorm2d: every norm on its running statistics, never
        # updated, whatever forward's ``train`` says
        self.norm_frozen = norm_frozen
        self.dtype = dtype
        self.transform = RCNNTransform(min_size, max_size)
        body = MobileNetV3(dtype=dtype)
        self.stage_taps = body.stage_indices()[-2:]  # C4, C5: both at stride 32
        channels = body.stage_channels()
        fpn = FeaturePyramidNetwork([channels[i] for i in self.stage_taps], 256, dtype)
        self.backbone = nn.ModuleDict(dict(body=body, fpn=fpn))
        self.num_anchors = len(ANCHOR_SIZES) * len(ASPECT_RATIOS)
        self.rpn = nn.ModuleDict(dict(head=RPNHead(256, self.num_anchors, dtype)))
        self.roi_heads = nn.ModuleDict(dict(
            box_head=TwoMLPHead(256 * 7 * 7, 1024, dtype),
            box_predictor=FastRCNNPredictor(1024, num_classes, dtype)))
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}

    def anchors(self, feat_shapes: Sequence[Tuple[int, int]],
                strides: Sequence[Tuple[int, int]], device: torch.device
                ) -> List[torch.Tensor]:
        """Each level's anchors on ``device``, made once per input shape."""
        key = (tuple(feat_shapes), tuple(strides), device)
        if key not in self._anchors:
            n = len(feat_shapes)
            self._anchors[key] = [torch.from_numpy(a).to(device) for a in generate_anchors(
                feat_shapes, strides, (ANCHOR_SIZES,) * n, (ASPECT_RATIOS,) * n)]
        return self._anchors[key]

    def proposals(self, objectness: Sequence[torch.Tensor],
                  deltas: Sequence[torch.Tensor], anchors: Sequence[torch.Tensor],
                  img_hw: Tuple[int, int], mode: str = "test"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per image and level the top ``rpn_pre_nms_top_n_{mode}`` anchors,
        decoded, clipped, masked (sides >= 1e-3, sigmoid >= the score
        threshold), padded to one size with -inf scores, NMS per level,
        then the top ``rpn_post_nms_top_n_{mode}``: (B, P, 4), (B, P)."""
        pre_nms = self.rpn_pre_nms_top_n[mode]
        max_k = min(pre_nms, max(a.shape[0] for a in anchors))
        lvl_boxes, lvl_scores, lvl_valid = [], [], []
        for obj, dlt, anc in zip(objectness, deltas, anchors):
            obj_f = _nhwc_flat(obj, 1)[..., 0]                            # (B, n_l)
            dlt_f = _nhwc_flat(dlt, 4)                                    # (B, n_l, 4)
            k = min(pre_nms, anc.shape[0])
            idx, _ = box_ops.top_k_by_score(obj_f, k)
            scores = obj_f.gather(1, idx)
            picked = dlt_f.gather(1, idx[..., None].expand(-1, -1, 4))
            boxes = box_ops.decode_boxes(picked, anc[idx])[..., 0, :]
            boxes = box_ops.clip_boxes_to_image(boxes, *img_hw)
            valid = box_ops.small_box_mask(boxes, 1e-3)
            valid &= torch.sigmoid(scores) >= self.rpn_score_thresh
            if k < max_k:  # pad the level so the levels' NMS runs as one batch
                boxes = F.pad(boxes, (0, 0, 0, max_k - k))
                scores = F.pad(scores, (0, max_k - k), value=-math.inf)
                valid = torch.cat([valid, valid.new_zeros(valid.shape[0], max_k - k)], 1)
            lvl_boxes.append(boxes)
            lvl_scores.append(scores)
            lvl_valid.append(valid)
        lb, ls, lv = (torch.stack(t, 1) for t in (lvl_boxes, lvl_scores, lvl_valid))
        keep = box_ops.nms_mask(lb, ls, self.rpn_nms_thresh, lv)         # (B, L, max_k)
        b = lb.shape[0]
        all_boxes, all_scores = lb.reshape(b, -1, 4), ls.reshape(b, -1)
        idx, valid = box_ops.top_k_by_score(
            all_scores, min(self.rpn_post_nms_top_n[mode], all_scores.shape[1]),
            keep.reshape(b, -1))
        return all_boxes.gather(1, idx[..., None].expand(-1, -1, 4)), valid

    def _fpn(self, images: torch.Tensor, train_bn: bool = False) -> tuple:
        """(FPN maps, the resized and padded images, the resized (h, w)) of
        (B, 3, H, W) images in [0, 1]; ``train_bn``: the body's norms on
        batch statistics."""
        tfm = self.transform
        images_r, img_hw, _ = tfm.resize(tfm.normalize(images))
        images_r = images_r.to(self.dtype or images_r.dtype)
        feats_all = self.backbone.body(images_r, train_bn)
        return self.backbone.fpn([feats_all[i] for i in self.stage_taps]), images_r, img_hw

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The FPN maps ``'0'``, ``'1'`` and ``'pool'`` of (B, 3, H, W)
        images in [0, 1], norms on running statistics: an inference
        :meth:`forward`'s ``feats["features"]`` alone (the outputs JAX's
        feature passes keep of a whole call)."""
        return dict(zip(("0", "1", "pool"), self._fpn(images)[0]))

    def forward(self, images: torch.Tensor, targets: Optional[Dict[str, torch.Tensor]] = None,
                manual_proposals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_feat: bool = False, train: bool = False,
                sampler_uniforms: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """``images`` (B, 3, H, W) in [0, 1] -> ``(detections, losses, feats)``.

        ``detections``: ``boxes`` (B, D, 4) in input pixels, ``scores``,
        ``labels`` and ``valid`` (B, D), D = ``box_detections_per_img``,
        scores and labels 0 where not valid. ``feats``: the FPN maps
        (``features`` '0', '1', 'pool'), per-level ``objectness`` and
        ``pred_bbox_deltas`` (NCHW), the ``proposals`` (B, P, 4) the box
        head pooled and their ``class_logits`` (B, P, num_classes).
        ``manual_proposals``: (boxes (B, P, 4), valid (B, P)) in the resized
        image's pixels, pooled in place of the RPN's. As in JAX, ``feats``
        come back whatever ``return_feat`` says.

        ``targets``: ``boxes`` (B, G, 4) in input pixels, ``labels`` (B, G)
        and ``valid`` (B, G), padded. Given, the call trains as JAX's does:
        ``losses`` holds ``loss_objectness``, ``loss_rpn_box_reg``,
        ``loss_classifier`` and ``loss_box_reg``, the proposals are the
        train-mode counts' (detached), the sampled ones gathered first, and
        ``detections`` is empty (the jitted JAX step computes none it
        uses). ``sampler_uniforms``: ``rpn`` (B, 2, anchors) and ``roi``
        (B, 2, P + G) uniforms in [0, 1), each pair (positives, negatives)
        of one image's :func:`balanced_sample`; else drawn from
        ``generator``. ``train``: the body's norms on batch statistics,
        their running ones updated (not under ``norm_frozen``)."""
        training_mode = targets is not None
        train_bn = train and not self.norm_frozen
        b, _, orig_h, orig_w = images.shape
        fpn_feats, images_r, img_hw = self._fpn(images, train_bn)
        objectness, pred_deltas = self.rpn.head(fpn_feats)

        # anchor strides: padded image size // grid size, per axis; the
        # MobileNet taps give both maps at stride 32
        pad_h, pad_w = images_r.shape[-2:]
        feat_shapes = [tuple(f.shape[-2:]) for f in fpn_feats]
        strides = [(pad_h // fh, pad_w // fw) for fh, fw in feat_shapes]
        anchors = self.anchors(feat_shapes, strides, images_r.device)
        proposals, prop_valid = self.proposals(objectness, pred_deltas, anchors, img_hw,
                                               "train" if training_mode else "test")
        # detached, as torchvision's RPN detaches them: no box-head
        # gradient reaches the RPN through the proposals
        proposals = proposals.detach()

        losses: Dict[str, torch.Tensor] = {}
        if training_mode:
            nh, nw = img_hw
            sx, sy = nw / orig_w, nh / orig_h
            b_in = targets["boxes"].to(images.device, torch.float32)
            gt_boxes = torch.stack([b_in[..., 0] * sx, b_in[..., 1] * sy,
                                    b_in[..., 2] * sx, b_in[..., 3] * sy], dim=-1)
            gt_labels = targets["labels"].to(images.device)
            gt_valid = targets["valid"].to(images.device, torch.bool)
            anchors_cat = torch.cat(anchors)
            n_cand = proposals.shape[1] + gt_boxes.shape[1]
            if sampler_uniforms is None:
                sampler_uniforms = dict(
                    rpn=torch.rand((b, 2, anchors_cat.shape[0]), generator=generator,
                                   device=images.device),
                    roi=torch.rand((b, 2, n_cand), generator=generator, device=images.device))
            losses.update(self.rpn_loss(objectness, pred_deltas, anchors_cat, gt_boxes,
                                        gt_valid, sampler_uniforms["rpn"]))
            proposals, prop_valid, box_labels, reg_targets = self.select_training_samples(
                proposals, prop_valid, gt_boxes, gt_labels, gt_valid, sampler_uniforms["roi"])
        if manual_proposals is not None:
            proposals, prop_valid = manual_proposals

        # RoIAlign scales inferred as 2^round(log2(feat / image)), as
        # MultiScaleRoIAlign does: both MobileNet maps give 1/32, so the
        # level mapper sends every RoI to level '0', as in torchvision
        pool_feats = fpn_feats[:2]
        scales = [2.0 ** round(math.log2(f.shape[-2] / img_hw[0])) for f in pool_feats]
        pooled = multiscale_roi_align(pool_feats, proposals, scales, 7, 2)
        n_p = proposals.shape[1]
        rep = self.roi_heads.box_head(pooled.reshape(b * n_p, -1))
        class_logits, box_deltas = self.roi_heads.box_predictor(rep)
        class_logits = class_logits.reshape(b, n_p, -1)
        box_deltas = box_deltas.reshape(b, n_p, -1)

        feats = {"features": {"0": fpn_feats[0], "1": fpn_feats[1], "pool": fpn_feats[2]},
                 "objectness": objectness, "pred_bbox_deltas": pred_deltas,
                 "proposals": proposals, "class_logits": class_logits}
        if training_mode:
            losses.update(self.box_loss(class_logits, box_deltas, box_labels, reg_targets,
                                        prop_valid))
            return {}, losses, feats
        detections = self.postprocess(class_logits, box_deltas, proposals, prop_valid,
                                      img_hw, (orig_h, orig_w))
        return detections, losses, feats

    def rpn_loss(self, objectness: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
                 anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                 uniforms: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The RPN's objectness BCE and box smooth-L1 over the sampled
        anchors of each image, each over the sampled count, then the mean
        over the batch. ``anchors`` (N, 4), the levels concatenated in the
        order of the flattened head outputs."""
        obj = torch.cat([_nhwc_flat(o, 1)[..., 0] for o in objectness], 1)   # (B, N)
        dlt = torch.cat([_nhwc_flat(d, 4) for d in deltas], 1)                # (B, N, 4)
        high, low = self.rpn_iou_thresh
        matches = match_boxes(box_ops.box_iou(gt_boxes, anchors), high, low, True, gt_valid)
        pos, neg = matches >= 0, matches == BELOW_LOW
        matched = gt_boxes.gather(1, matches.clamp(min=0)[..., None].expand(-1, -1, 4))
        reg_targets = box_ops.encode_boxes(matched, anchors)
        sp, sn = balanced_sample(pos, neg, self.rpn_batch_size_per_image,
                                 self.rpn_positive_fraction, uniforms[:, 0], uniforms[:, 1])
        sampled = sp | sn
        n_sampled = sampled.sum(-1).clamp(min=1)
        box_l = (smooth_l1(dlt - reg_targets).sum(-1) * sp).sum(-1) / n_sampled
        obj_l = (bce_with_logits(obj, pos.float()) * sampled).sum(-1) / n_sampled
        return dict(loss_objectness=obj_l.mean(), loss_rpn_box_reg=box_l.mean())

    def select_training_samples(self, proposals: torch.Tensor, prop_valid: torch.Tensor,
                                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                                gt_valid: torch.Tensor, uniforms: torch.Tensor) -> tuple:
        """GT boxes appended to the proposals, matched and sampled, the
        sampled ones first (a stable order) and the first
        ``box_batch_size_per_image`` kept: (proposals, valid, labels: the
        matched class, 0 background, -1 padding, regression targets)."""
        props = torch.cat([proposals, gt_boxes], 1)
        pvalid = torch.cat([prop_valid, gt_valid], 1)
        iou = box_ops.box_iou(gt_boxes, props).masked_fill(~pvalid[:, None, :], -1.0)
        high, low = self.box_iou_thresh
        matches = match_boxes(iou, high, low, False, gt_valid)
        pos, neg = (matches >= 0) & pvalid, (matches == BELOW_LOW) & pvalid
        sp, sn = balanced_sample(pos, neg, self.box_batch_size_per_image,
                                 self.box_positive_fraction, uniforms[:, 0], uniforms[:, 1])
        sampled = sp | sn
        order = torch.sort((~sampled).to(torch.uint8), dim=-1, stable=True).indices
        idx = order[:, :self.box_batch_size_per_image]
        sel_valid = sampled.gather(1, idx)
        sel_props = props.gather(1, idx[..., None].expand(-1, -1, 4))
        sel_matches = matches.gather(1, idx).clamp(min=0)
        labels = torch.where(matches.gather(1, idx) >= 0, gt_labels.gather(1, sel_matches),
                             torch.zeros_like(sel_matches))
        labels = labels.masked_fill(~sel_valid, -1)
        matched = gt_boxes.gather(1, sel_matches[..., None].expand(-1, -1, 4))
        reg_targets = box_ops.encode_boxes(matched, sel_props, self.bbox_reg_weights)
        return sel_props, sel_valid, labels, reg_targets

    def box_loss(self, class_logits: torch.Tensor, box_deltas: torch.Tensor,
                 labels: torch.Tensor, reg_targets: torch.Tensor, valid: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """The box head's cross-entropy over the valid samples and its box
        smooth-L1 over the positives' own class, each over the valid count,
        then the mean over the batch."""
        b, n, nc = class_logits.shape
        lbl = labels.clamp(min=0)
        ce = -torch.log_softmax(class_logits, -1).gather(-1, lbl[..., None])[..., 0]
        n_valid = valid.sum(-1).clamp(min=1)
        cls_l = (ce * valid).sum(-1) / n_valid
        d = box_deltas.reshape(b, n, nc, 4).gather(
            2, lbl[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        pos = (labels > 0) & valid
        box_l = (smooth_l1(d - reg_targets).sum(-1) * pos).sum(-1) / n_valid
        return dict(loss_classifier=cls_l.mean(), loss_box_reg=box_l.mean())

    def postprocess(self, class_logits: torch.Tensor, box_deltas: torch.Tensor,
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_hw: Tuple[int, int], orig_hw: Tuple[int, int]
                    ) -> Dict[str, torch.Tensor]:
        """Softmax, decode, clip, per-class score threshold, 1e-2 small-box
        test and NMS, the top detections, boxes back to input pixels
        (``RoIHeads.postprocess_detections`` + the transform's
        ``postprocess``)."""
        img_h, img_w = img_hw
        orig_h, orig_w = orig_hw
        b = class_logits.shape[0]
        scores = torch.softmax(class_logits, dim=-1)                      # (B, P, C)
        boxes = box_ops.decode_boxes(box_deltas, proposals, self.bbox_reg_weights)
        boxes = box_ops.clip_boxes_to_image(boxes, img_h, img_w)         # (B, P, C, 4)
        # NMS per class as one batch of rows, (B, C-1, P)
        cb = boxes[:, :, 1:].transpose(1, 2)
        cs = scores[:, :, 1:].transpose(1, 2)
        valid = prop_valid[:, None, :] & (cs > self.box_score_thresh)
        valid &= box_ops.small_box_mask(cb, 1e-2)
        keep = box_ops.nms_mask(cb, cs, self.box_nms_thresh, valid)
        n = cs.shape[-1]
        flat_scores, flat_boxes = cs.reshape(b, -1), cb.reshape(b, -1, 4)
        labels = torch.arange(1, self.num_classes, device=cs.device).repeat_interleave(n)
        idx, fvalid = box_ops.top_k_by_score(flat_scores, self.box_detections_per_img,
                                             keep.reshape(b, -1))
        out = flat_boxes.gather(1, idx[..., None].expand(-1, -1, 4))
        sx, sy = orig_w / img_w, orig_h / img_h
        out = torch.stack([out[..., 0] * sx, out[..., 1] * sy,
                           out[..., 2] * sx, out[..., 3] * sy], dim=-1)
        return dict(boxes=out,
                    scores=flat_scores.gather(1, idx).masked_fill(~fvalid, 0.0),
                    labels=labels[idx].masked_fill(~fvalid, 0),
                    valid=fvalid)


def fasterrcnn_mobilenet_v3_large_fpn(weights=None, weights_backbone=None,
                                      num_classes: int = 91,
                                      dtype: Optional[torch.dtype] = None,
                                      device: Optional[torch.device | str] = None,
                                      **kwargs) -> FasterRCNN:
    """The detector with torchvision's MobileNet settings
    (``rpn_score_thresh`` 0.05), with random weights, on ``device`` (the
    card unless the caller names another). It loads no weights by name:
    naming ``weights`` or ``weights_backbone`` raises. Trained weights load
    through ``model.load_state_dict(from_jax(variables, "fasterrcnn"))``;
    pass ``norm_frozen=True`` with them, as torchvision's rule freezes the
    norms of named weights (train-mode calls then keep every norm on its
    running statistics). Other keyword arguments set :class:`FasterRCNN`'s
    fields, JAX's training knobs among them; ``box_pre_nms_top_n`` is not
    ported, and naming it raises."""
    if weights is not None or weights_backbone is not None:
        raise ValueError("fasterrcnn_mobilenet_v3_large_fpn loads no weights by name; "
                         "load them with edtr_torch.utils.convert.from_jax(variables, "
                         "'fasterrcnn') and pass norm_frozen=True")
    kwargs.setdefault("rpn_score_thresh", 0.05)
    model = FasterRCNN(num_classes=num_classes, dtype=dtype, **kwargs)
    return model.to(resolve_device(device)).eval()


def detnet_trainable_mask(model: nn.Module, trainable_layers: int = 3) -> Dict[str, bool]:
    """torchvision's backbone freezing (``trainable_layers`` of the
    MobileNet's stages train), as JAX's ``detnet_trainable_mask``: the body's
    ``features.i`` with ``i < stage_indices[num_stages - trainable_layers]``
    (every one when 0) are frozen, everything else trains. Sets each
    parameter's ``requires_grad`` and returns name -> trainable. Frozen
    stages' BatchNorm running statistics still update in train-mode calls,
    as torchvision's plain BatchNorm does. A net that is not a
    :class:`FasterRCNN` (a classification or segmentation net) trains every
    parameter, as JAX's ``mask_detnet_tx`` leaves its optimizer unmasked."""
    if not isinstance(model, FasterRCNN):
        for p in model.parameters():
            p.requires_grad_(True)
        return {name: True for name, _ in model.named_parameters()}
    si = model.backbone.body.stage_indices()
    freeze_before = si[-1] + 1 if trainable_layers == 0 else si[len(si) - trainable_layers]
    mask = {}
    for name, p in model.named_parameters():
        m = re.match(r"backbone\.body\.features\.(\d+)\.", name)
        mask[name] = m is None or int(m.group(1)) >= freeze_before
        p.requires_grad_(mask[name])
    return mask


def calibrate_heads_(model: FasterRCNN, images: torch.Tensor) -> FasterRCNN:
    """For seeded random weights (runs without a checkpoint): one forward
    of ``images`` in which every conv and linear layer after the backbone's
    body (FPN, RPN head, box head, predictor) is scaled to unit output RMS
    (``layers.calibrate_unit_rms_``), so the FPN maps, objectness, deltas
    and class logits are O(1) and class scores pass the score threshold, as
    trained weights' do. The body keeps its weights: a random MobileNet
    whose norms are set to unit gain amplifies bf16 rounding from layer to
    layer (to ~15% relative L2 at the FPN, on the CPU), while scaling a
    linear or ReLU layer moves no relative rounding."""
    heads = [m for name, m in model.named_modules() if isinstance(m, (Conv2d, Linear))
             and not name.startswith("backbone.body.")]
    calibrate_unit_rms_(heads, lambda: model(images))
    return model
