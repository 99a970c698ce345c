"""COCO detection dataset v1 (CodeFormer degradation) + paired variant.

Counterpart of ``edtr_tpu/data/detection_coco.py``, host code copied.

Parity: ``datasets/detection_coco.py``:
  DegradedDetectionDatasetCoco -> :25-203 (same CodeFormer block as the VOC
    dataset but over COCO annotations)
  PairedDetectionDatasetCoco   -> :205-311 (dumped gt/lq pairs)
"""

from __future__ import annotations

import io
import os
import random
from typing import Any, Mapping, Optional, Sequence

import numpy as np
from PIL import Image

from edtr_torch.config import instantiate_from_config
from edtr_torch.data.coco import COCOIndex
from edtr_torch.data.degradation import codeformer_degrade

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class DegradedDetectionDatasetCoco:
    def __init__(
        self,
        root: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: int,
        out_size: int,
        crop_type: str,
        hflip: bool,
        rotation: bool,
        blur_kernel_size: Optional[int],
        kernel_list: Sequence[str],
        kernel_prob: Sequence[float],
        blur_sigma: Sequence[float],
        downsample_range: Sequence[float],
        noise_range: Optional[Sequence[float]],
        jpeg_range: Optional[Sequence[float]],
        image_set: str = "train",
        exclude_no_annotation: bool = True,
        data_length: int = -1,
        **_unused,
    ):
        img_folder = os.path.join(root, f"{image_set}2017")
        ann_file = os.path.join(root, "annotations", f"instances_{image_set}2017.json")
        self.root = img_folder
        self.coco = COCOIndex(ann_file)
        self.ids = self.coco.getImgIds()
        if exclude_no_annotation:
            self.ids = [i for i in self.ids if len(self.coco.getAnnIds(i)) > 0]
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.gt_size = gt_size
        self.out_size = out_size
        self.crop_type = crop_type
        self.hflip = hflip
        self.rotation = rotation
        self.blur_kernel_size = blur_kernel_size
        self.kernel_list = list(kernel_list)
        self.kernel_prob = list(kernel_prob)
        self.blur_sigma = tuple(blur_sigma)
        self.downsample_range = tuple(downsample_range)
        self.noise_range = tuple(noise_range) if noise_range else None
        self.jpeg_range = tuple(jpeg_range) if jpeg_range else None
        self.image_set = image_set
        self.data_length = data_length

    def load_items(self, img_id: int, max_retry: int = 5):
        # identical geometry pipeline as cocov2 (hflip/resize/keep-valid)
        from edtr_torch.data.detection_cocov2 import DegradedDetectionDatasetCocov2

        return DegradedDetectionDatasetCocov2.load_items(self, img_id, max_retry)

    def __getitem__(self, index: int):
        img_id = self.ids[index % len(self.ids)]
        img_gt, n = None, 0
        while img_gt is None or (n == 0 and self.image_set == "train"):
            img_gt, annot, path = self.load_items(img_id)
            n = len(annot.get("boxes", [])) if annot else 0
            if img_gt is None or n == 0:
                img_id = self.ids[random.randint(0, len(self.ids) - 1)]

        img_gt_bgr = (img_gt[..., ::-1] / 255.0).astype(np.float32)
        img_lq_bgr = codeformer_degrade(
            img_gt_bgr,
            blur_kernel_size=self.blur_kernel_size,
            kernel_list=self.kernel_list,
            kernel_prob=self.kernel_prob,
            blur_sigma=self.blur_sigma,
            downsample_range=self.downsample_range,
            noise_range=self.noise_range,
            jpeg_range=self.jpeg_range,
        )
        gt = np.ascontiguousarray(img_gt_bgr[..., ::-1], dtype=np.float32)
        lq = np.ascontiguousarray(img_lq_bgr[..., ::-1], dtype=np.float32)
        return gt, lq, annot, path

    def __len__(self) -> int:
        return self.data_length if self.data_length > len(self.ids) else len(self.ids)


class PairedDetectionDatasetCoco:
    """Dumped (gt, lq) COCO pairs; parity ``datasets/detection_coco.py:205-311``."""

    def __init__(
        self,
        root: str,
        path: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: int,
        image_set: str = "val",
        **_unused,
    ):
        img_folder = os.path.join(root, f"{image_set}2017")
        ann_file = os.path.join(root, "annotations", f"instances_{image_set}2017.json")
        self.root = img_folder
        self.pair_root = os.path.join(root, path)
        self.coco = COCOIndex(ann_file)
        self.ids = self.coco.getImgIds()
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.gt_size = gt_size
        self.image_set = image_set
        self.hflip = False

    def __getitem__(self, index: int):
        from edtr_torch.data.detection_cocov2 import DegradedDetectionDatasetCocov2

        img_id = self.ids[index]
        name = os.path.splitext(self.coco.loadImgs(img_id)[0]["file_name"])[0]
        gt = np.array(
            Image.open(io.BytesIO(self.file_backend.get(
                os.path.join(self.pair_root, "gt", name + ".png")))).convert("RGB")
        )
        lq = np.array(
            Image.open(io.BytesIO(self.file_backend.get(
                os.path.join(self.pair_root, "lq", name + ".png")))).convert("RGB")
        )
        # annotations rescaled with the same geometry rule
        _, annot, _ = DegradedDetectionDatasetCocov2.load_items(self, img_id)
        gt = (gt / 255.0).astype(np.float32)
        lq = (lq / 255.0).astype(np.float32)
        return gt, lq, annot, name

    def __len__(self) -> int:
        return len(self.ids)
