"""Minimal COCO annotation index (pycocotools replacement, host-side).

Counterpart of ``edtr_tpu/data/coco.py``, host code copied.

The reference uses pycocotools' ``COCO`` via torchvision's ``CocoDetection``
(``datasets/detection_cocov2.py:28``) plus ``convert_to_coco_api``
(``datasets/utils_coco.py:19-204``, ``utils/detection.py:370-419``).
pycocotools is unavailable here; this is a small JSON index with the same
query surface used by the datasets and the evaluator.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List


class COCOIndex:
    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.anns = {ann["id"]: ann for ann in data.get("annotations", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)

    # pycocotools-compatible query surface (subset)
    def getImgIds(self) -> List[int]:
        return sorted(self.imgs.keys())

    def getAnnIds(self, img_id) -> List[int]:
        return [a["id"] for a in self.img_to_anns.get(img_id, [])]

    def loadAnns(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]


def convert_coco_annotations(anno: List[dict], h: int, w: int) -> Dict:
    """Raw COCO annotation list -> {boxes(xyxy), labels, masks, area,
    iscrowd[, keypoints]} numpy target dict.

    Parity: ``ConvertCocoPolysToMask`` (datasets/utils_coco.py:36-88) —
    drops crowd annotations, clamps boxes to the image, rasterizes polygon
    segmentations, keeps only positive-area boxes.
    """
    import numpy as np

    from edtr_torch.data.coco_mask import convert_coco_poly_to_mask

    anno = [obj for obj in anno if obj.get("iscrowd", 0) == 0]
    boxes = np.asarray([obj["bbox"] for obj in anno], np.float32).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    labels = np.asarray([obj["category_id"] for obj in anno], np.int64)
    masks = convert_coco_poly_to_mask([obj["segmentation"] for obj in anno], h, w)

    keypoints = None
    if anno and "keypoints" in anno[0]:
        keypoints = np.asarray([obj["keypoints"] for obj in anno], np.float32)
        if len(keypoints):
            keypoints = keypoints.reshape(len(keypoints), -1, 3)

    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    target = dict(
        boxes=boxes[keep],
        labels=labels[keep],
        masks=masks[keep],
        area=np.asarray([obj.get("area", 0.0) for obj in anno], np.float64),
        iscrowd=np.asarray([obj.get("iscrowd", 0) for obj in anno], np.int64),
    )
    if keypoints is not None:
        target["keypoints"] = keypoints[keep]
    return target


def gt_from_coco_index(coco: COCOIndex) -> Dict:
    """COCOIndex -> the {image_id: {boxes, labels, iscrowd, area}} dict our
    CocoEvaluator consumes (xywh -> xyxy)."""
    import numpy as np

    out = {}
    for img_id in coco.getImgIds():
        anns = coco.img_to_anns.get(img_id, [])
        boxes = np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4)
        if len(boxes):
            boxes[:, 2:] += boxes[:, :2]
        out[img_id] = dict(
            boxes=boxes,
            labels=np.asarray([a["category_id"] for a in anns], np.int64),
            iscrowd=np.asarray([a.get("iscrowd", 0) for a in anns], np.int64),
            area=np.asarray([a.get("area", 0.0) for a in anns], np.float64),
        )
    return out


def gt_from_dataset(dataset) -> Dict:
    """Build evaluator GT from a (VOC-style) dataset's annot dicts.

    Parity: ``convert_to_coco_api`` (utils/detection.py:370-419), reduced to
    the fields mAP needs.
    """
    import numpy as np

    out = {}
    for i in range(len(dataset)):
        item = dataset[i]
        annot = item[2]
        boxes = np.asarray(annot["boxes"], np.float64).reshape(-1, 4)
        entry = dict(
            boxes=boxes,
            labels=np.asarray(annot["labels"], np.int64),
            iscrowd=np.asarray(annot.get("iscrowd", np.zeros(len(boxes))), np.int64),
            area=np.asarray(
                annot.get("area", (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])),
                np.float64,
            ),
        )
        if "masks" in annot:  # utils_coco.py:153-169: RLE-encode instance masks
            from edtr_torch.data.coco_mask import rle_compress, rle_encode_mask

            entry["segmentation"] = [
                {
                    "size": r["size"],
                    "counts": rle_compress(r["counts"]),
                }
                for r in (rle_encode_mask(np.asarray(m)) for m in annot["masks"])
            ]
        out[annot["image_id"]] = entry
    return out
