"""COCO detection dataset v2 (Real-ESRGAN degradation kernels per sample).

Counterpart of ``edtr_tpu/data/detection_cocov2.py``, host code copied.

Parity: ``datasets/detection_cocov2.py:28-260``:
``__getitem__`` returns ``(hq, kernel1, kernel2, sinc_kernel, annot, path)``
where the image is clean (degradation happens on-device in
``edtr_torch.data.realesrgan.RealESRGANBatchTransform``) and the three blur
kernels are sampled per item — stage-1 mixed/sinc, stage-2 mixed/sinc,
final sinc (or identity pulse), all padded to 21x21.
"""

from __future__ import annotations

import io
import math
import os
import random
import time
from typing import Any, Mapping

import numpy as np
from PIL import Image

from edtr_torch.config import instantiate_from_config
from edtr_torch.data.coco import COCOIndex
from edtr_torch.data.degradation import circular_lowpass_kernel, random_mixed_kernels

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

PULSE_21 = np.zeros((21, 21), np.float32)
PULSE_21[10, 10] = 1.0


class DegradedDetectionDatasetCocov2:
    def __init__(
        self,
        root: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: int,
        out_size: int,
        crop_type: str,
        hflip: bool,
        rotation: bool,
        blur_kernel_size,
        kernel_list,
        kernel_prob,
        blur_sigma,
        betag_range,
        betap_range,
        sinc_prob,
        blur_kernel_size2,
        kernel_list2,
        kernel_prob2,
        blur_sigma2,
        betag_range2,
        betap_range2,
        sinc_prob2,
        final_sinc_prob,
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
        self.kernel_list = kernel_list
        self.kernel_prob = kernel_prob
        self.blur_sigma = tuple(blur_sigma)
        self.betag_range = tuple(betag_range)
        self.betap_range = tuple(betap_range)
        self.sinc_prob = sinc_prob
        self.kernel_list2 = kernel_list2
        self.kernel_prob2 = kernel_prob2
        self.blur_sigma2 = tuple(blur_sigma2)
        self.betag_range2 = tuple(betag_range2)
        self.betap_range2 = tuple(betap_range2)
        self.sinc_prob2 = sinc_prob2
        self.final_sinc_prob = final_sinc_prob
        self.kernel_range = [2 * v + 1 for v in range(3, 11)]  # 7..21
        self.image_set = image_set
        self.data_length = data_length

    def load_items(self, img_id: int, max_retry: int = 5):
        image_bytes = None
        while image_bytes is None:
            if max_retry == 0:
                return None, None, None
            path = os.path.join(self.root, self.coco.loadImgs(img_id)[0]["file_name"])
            image_bytes = self.file_backend.get(path)
            max_retry -= 1
            if image_bytes is None:
                time.sleep(0.5)
        image = np.array(Image.open(io.BytesIO(image_bytes)).convert("RGB"))
        height, width = image.shape[:2]

        anns = [a for a in self.coco.loadAnns(self.coco.getAnnIds(img_id)) if a["iscrowd"] == 0]
        annot: dict = {}
        if anns:
            boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
            boxes[:, 2:] += boxes[:, :2]
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, width)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, height)
            labels = np.asarray([a["category_id"] for a in anns], np.int64)
            area = np.asarray([a["area"] for a in anns], np.float32)
            iscrowd = np.asarray([a["iscrowd"] for a in anns], np.int64)

            if self.hflip and random.random() < 0.5:
                image = np.ascontiguousarray(image[:, ::-1])
                xmin, xmax = boxes[:, 0].copy(), boxes[:, 2].copy()
                boxes[:, 0] = np.maximum(width - xmax, 1.0)
                boxes[:, 2] = width - xmin

            if height >= width:
                scale = self.gt_size / height
                new_wh = (int(width * scale), self.gt_size)
            else:
                scale = self.gt_size / width
                new_wh = (self.gt_size, int(height * scale))
            image = cv2.resize(image, dsize=new_wh, interpolation=cv2.INTER_CUBIC)
            height, width = image.shape[:2]
            boxes[:, 0] = np.maximum(boxes[:, 0] * scale, 1.0)
            boxes[:, 2] = np.minimum(boxes[:, 2] * scale, width)
            boxes[:, 1] = np.maximum(boxes[:, 1] * scale, 1.0)
            boxes[:, 3] = np.minimum(boxes[:, 3] * scale, height)

            keep = (boxes[:, 3] > boxes[:, 1] + 1) & (boxes[:, 2] > boxes[:, 0] + 1)
            annot = dict(
                image_id=anns[0]["image_id"],
                boxes=boxes[keep],
                labels=labels[keep],
                area=area[keep],
                iscrowd=iscrowd[keep],
            )
        return image, annot, path

    def _sample_kernel(self, sinc_prob, kernel_list, kernel_prob, blur_sigma,
                       betag_range, betap_range) -> np.ndarray:
        kernel_size = random.choice(self.kernel_range)
        if np.random.uniform() < sinc_prob:
            omega_lo = math.pi / 3 if kernel_size < 13 else math.pi / 5
            omega_c = np.random.uniform(omega_lo, math.pi)
            kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)
        else:
            kernel = random_mixed_kernels(
                kernel_list, kernel_prob, kernel_size,
                blur_sigma, blur_sigma, (-math.pi, math.pi),
                betag_range, betap_range, noise_range=None,
            )
        pad = (21 - kernel_size) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)

    def __getitem__(self, index: int):
        img_id = self.ids[index % len(self.ids)]
        img_gt, n = None, 0
        while img_gt is None or (n == 0 and self.image_set == "train"):
            img_gt, annot, path = self.load_items(img_id)
            n = len(annot.get("boxes", [])) if annot else 0
            if img_gt is None or n == 0:
                img_id = self.ids[random.randint(0, len(self.ids) - 1)]

        hq = (img_gt / 255.0).astype(np.float32)  # HWC RGB [0,1]
        kernel1 = self._sample_kernel(
            self.sinc_prob, self.kernel_list, self.kernel_prob,
            self.blur_sigma, self.betag_range, self.betap_range,
        )
        kernel2 = self._sample_kernel(
            self.sinc_prob2, self.kernel_list2, self.kernel_prob2,
            self.blur_sigma2, self.betag_range2, self.betap_range2,
        )
        if np.random.uniform() < self.final_sinc_prob:
            kernel_size = random.choice(self.kernel_range)
            omega_c = np.random.uniform(math.pi / 3, math.pi)
            sinc_kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=21).astype(np.float32)
        else:
            sinc_kernel = PULSE_21
        return hq, kernel1, kernel2, sinc_kernel, annot, path

    def __len__(self) -> int:
        return self.data_length if self.data_length > len(self.ids) else len(self.ids)
