"""Faster R-CNN MobileNetV3-Large-FPN, inference (NCHW, static shapes).

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

Not ported yet: training (targets, matching, sampling, losses) and the
ResNet50-FPN-v2 variant (ROADMAP.md, Queue 1 items 4 and 5).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.device import resolve_device
from edtr_torch.models.layers import Conv2d, Linear
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


def _nhwc_flat(t: torch.Tensor, last: int) -> torch.Tensor:
    """A head output (B, A·last, H, W) flattened in JAX's NHWC order,
    index (h·W + w)·A + a, which is the anchors' order: (B, H·W·A, last)."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, last)


class FasterRCNN(nn.Module):
    """The MobileNetV3-Large-FPN detector, inference. :meth:`forward` takes
    (B, 3, H, W) images in [0, 1] and returns ``(detections, losses,
    feats)`` as JAX's ``__call__`` does."""

    def __init__(self, num_classes: int = 91, min_size: int = 800, max_size: int = 1333,
                 rpn_pre_nms_top_n_test: int = 1000, rpn_post_nms_top_n_test: int = 1000,
                 rpn_nms_thresh: float = 0.7, rpn_score_thresh: float = 0.0,
                 box_score_thresh: float = 0.05, box_nms_thresh: float = 0.5,
                 box_detections_per_img: int = 100,
                 bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0),
                 norm_frozen: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.rpn_pre_nms_top_n_test = rpn_pre_nms_top_n_test
        self.rpn_post_nms_top_n_test = rpn_post_nms_top_n_test
        self.rpn_nms_thresh, self.rpn_score_thresh = rpn_nms_thresh, rpn_score_thresh
        self.box_score_thresh, self.box_nms_thresh = box_score_thresh, box_nms_thresh
        self.box_detections_per_img = box_detections_per_img
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        # FrozenBatchNorm2d: read by nothing yet. Inference runs every norm
        # on its running statistics either way; the training half
        # (ROADMAP.md, Queue 1 item 4) will keep frozen norms' statistics
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
                  img_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per image and level the top ``rpn_pre_nms_top_n_test`` anchors,
        decoded, clipped, masked (sides >= 1e-3, sigmoid >= the score
        threshold), padded to one size with -inf scores, NMS per level,
        then the top ``rpn_post_nms_top_n_test``: (B, P, 4), (B, P)."""
        pre_nms = self.rpn_pre_nms_top_n_test
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
            all_scores, min(self.rpn_post_nms_top_n_test, all_scores.shape[1]),
            keep.reshape(b, -1))
        return all_boxes.gather(1, idx[..., None].expand(-1, -1, 4)), valid

    def forward(self, images: torch.Tensor, targets=None,
                manual_proposals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_feat: bool = False):
        """``images`` (B, 3, H, W) in [0, 1] -> ``(detections, {}, feats)``.

        ``detections``: ``boxes`` (B, D, 4) in input pixels, ``scores``,
        ``labels`` and ``valid`` (B, D), D = ``box_detections_per_img``,
        scores and labels 0 where not valid. ``feats``: the FPN maps
        (``features`` '0', '1', 'pool'), per-level ``objectness`` and
        ``pred_bbox_deltas`` (NCHW), the ``proposals`` (B, P, 4) the box
        head pooled and their ``class_logits`` (B, P, num_classes).
        ``manual_proposals``: (boxes (B, P, 4), valid (B, P)) in the resized
        image's pixels, pooled in place of the RPN's. As in JAX, ``feats``
        come back whatever ``return_feat`` says."""
        if targets is not None:
            raise NotImplementedError(
                "the port's detector runs inference only; training (targets, "
                "matching, sampling, losses) is ROADMAP.md Queue 1 item 4")
        b, _, orig_h, orig_w = images.shape
        tfm = self.transform
        images_r, img_hw, _ = tfm.resize(tfm.normalize(images))
        images_r = images_r.to(self.dtype or images_r.dtype)

        feats_all = self.backbone.body(images_r)
        fpn_feats = self.backbone.fpn([feats_all[i] for i in self.stage_taps])
        objectness, pred_deltas = self.rpn.head(fpn_feats)

        # anchor strides: padded image size // grid size, per axis; the
        # MobileNet taps give both maps at stride 32
        pad_h, pad_w = images_r.shape[-2:]
        feat_shapes = [tuple(f.shape[-2:]) for f in fpn_feats]
        strides = [(pad_h // fh, pad_w // fw) for fh, fw in feat_shapes]
        anchors = self.anchors(feat_shapes, strides, images_r.device)
        proposals, prop_valid = self.proposals(objectness, pred_deltas, anchors, img_hw)
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
        detections = self.postprocess(class_logits, box_deltas, proposals, prop_valid,
                                      img_hw, (orig_h, orig_w))
        return detections, {}, feats

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
    norms of named weights (read by nothing at inference). Other keyword
    arguments set :class:`FasterRCNN`'s fields; JAX's training knobs and
    ``box_pre_nms_top_n`` are not ported, and naming one raises."""
    if weights is not None or weights_backbone is not None:
        raise ValueError("fasterrcnn_mobilenet_v3_large_fpn loads no weights by name; "
                         "load them with edtr_torch.utils.convert.from_jax(variables, "
                         "'fasterrcnn') and pass norm_frozen=True")
    kwargs.setdefault("rpn_score_thresh", 0.05)
    model = FasterRCNN(num_classes=num_classes, dtype=dtype, **kwargs)
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def calibrate_heads_(model: FasterRCNN, images: torch.Tensor) -> FasterRCNN:
    """For seeded random weights (runs without a checkpoint): one forward
    of ``images`` in which every conv and linear layer after the backbone's
    body (FPN, RPN head, box head, predictor), at its first call, divides
    its weight and bias by the root mean square of its output, so the FPN
    maps, objectness, deltas and class logits are O(1) and class scores
    pass the score threshold, as trained weights' do. The body keeps its
    weights: a random MobileNet whose norms are set to unit gain amplifies
    bf16 rounding from layer to layer (to ~15% relative L2 at the FPN, on
    the CPU), while scaling a linear or ReLU layer moves no relative
    rounding."""
    done = set()

    def unit_rms(layer, args, out):
        if layer in done:
            return None
        done.add(layer)
        r = out.float().square().mean().sqrt()
        layer.weight.div_(r)
        if layer.bias is not None:
            layer.bias.div_(r)
        return out / r

    heads = [m for name, m in model.named_modules() if isinstance(m, (Conv2d, Linear))
             and not name.startswith("backbone.body.")]
    hooks = [m.register_forward_hook(unit_rms) for m in heads]
    try:
        model(images)
    finally:
        for h in hooks:
            h.remove()
    return model
