"""Detection datasets (VOC): degraded + paired + real-world.

Counterpart of ``edtr_tpu/data/detection.py``, host code copied.

Parity: ``datasets/detection.py``:
  DegradedDetectionDataset  -> :26-194 (hflip syncs boxes :85-90,
    aspect-preserving resize to gt_size with box rescale :92-106, crop with
    box clipping + min-size-15 filter :109-130, VOC XML -> COCO dict)
  PairedDetectionDataset    -> :197-277 ({path}/gt|lq dumped pairs)
  RealworldDetectionDataset -> :280-333 (images only)

Returns ``(gt, lq, annot, path)``: HWC RGB float32 [0,1] + numpy annot dict.
"""

from __future__ import annotations

import io
import os
import random
import time
import xml.etree.ElementTree as ET
from typing import Any, Mapping, Optional, Sequence

import numpy as np
from PIL import Image

from edtr_torch.config import instantiate_from_config
from edtr_torch.data.augment import center_crop_arr, random_crop_arr
from edtr_torch.data.degradation import codeformer_degrade
from edtr_torch.data.voc import convert2coco, get_label2id, parse_voc_xml, voc_file_lists

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _annot_to_numpy(annot: dict) -> dict:
    out = dict(annot)
    out["boxes"] = np.asarray(annot["boxes"], np.float32).reshape(-1, 4)
    out["labels"] = np.asarray(annot["labels"], np.int32)
    out["area"] = np.asarray(annot["area"], np.float32)
    out["iscrowd"] = np.asarray(annot["iscrowd"], np.int32)
    return out


class DegradedDetectionDataset:
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
        year: str = "2012",
        image_set: str = "train",
        labels_path: Optional[str] = None,
        data_length: int = -1,
        **_unused,
    ):
        self.images, self.annotations = voc_file_lists(root, year, image_set, "detection")
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.gt_size = gt_size
        self.out_size = out_size
        self.crop_type = crop_type
        assert crop_type in ("none", "center", "random")
        self.hflip = hflip
        self.rotation = rotation
        self.blur_kernel_size = blur_kernel_size
        self.kernel_list = list(kernel_list)
        self.kernel_prob = list(kernel_prob)
        self.blur_sigma = tuple(blur_sigma)
        self.downsample_range = tuple(downsample_range)
        self.noise_range = tuple(noise_range) if noise_range else None
        self.jpeg_range = tuple(jpeg_range) if jpeg_range else None
        self.label2id = get_label2id(labels_path)
        self.data_length = data_length

    def load_items(self, image_path: str, annot_path: str, max_retry: int = 5):
        image_bytes = None
        while image_bytes is None:
            if max_retry == 0:
                return None, None
            image_bytes = self.file_backend.get(image_path)
            max_retry -= 1
            if image_bytes is None:
                time.sleep(0.5)
        image = np.array(Image.open(io.BytesIO(image_bytes)).convert("RGB"))
        annot = parse_voc_xml(ET.parse(annot_path).getroot())
        height, width = image.shape[:2]

        # hflip with box sync (ref :85-90)
        if self.hflip and random.random() < 0.5:
            image = np.ascontiguousarray(image[:, ::-1])
            for item in annot["annotation"]["object"]:
                xmin = int(item["bndbox"]["xmin"])
                xmax = int(item["bndbox"]["xmax"])
                item["bndbox"]["xmin"] = str(max(width - xmax, 1))
                item["bndbox"]["xmax"] = str(width - xmin)

        # aspect-preserving resize to gt_size (ref :92-106)
        if height >= width:
            scale = self.gt_size / height
            new_wh = (int(width * scale), self.gt_size)
        else:
            scale = self.gt_size / width
            new_wh = (self.gt_size, int(height * scale))
        image = cv2.resize(image, dsize=new_wh, interpolation=cv2.INTER_CUBIC)
        height, width = image.shape[:2]
        for item in annot["annotation"]["object"]:
            bb = item["bndbox"]
            bb["xmin"] = str(max(int(int(bb["xmin"]) * scale), 1))
            bb["xmax"] = str(min(int(int(bb["xmax"]) * scale), width))
            bb["ymin"] = str(max(int(int(bb["ymin"]) * scale), 1))
            bb["ymax"] = str(min(int(int(bb["ymax"]) * scale), height))

        # crop with box clipping + min-size filter (ref :109-130)
        if self.crop_type != "none" and not (
            height == self.out_size and width == self.out_size
        ):
            if self.crop_type == "center":
                image, pos = center_crop_arr(image, self.out_size, return_params=True)
            else:
                image, pos = random_crop_arr(image, self.out_size, return_params=True)
            y0, x0 = pos
            new_obj = []
            for item in annot["annotation"]["object"]:
                bb = item["bndbox"]
                xmin, xmax = int(bb["xmin"]), int(bb["xmax"])
                ymin, ymax = int(bb["ymin"]), int(bb["ymax"])
                if xmax > x0 and ymax > y0:
                    xmin, xmax = max(xmin - x0, 1), min(xmax - x0, self.out_size)
                    ymin, ymax = max(ymin - y0, 1), min(ymax - y0, self.out_size)
                    if xmax > xmin + 15 and ymax > ymin + 15:
                        bb["xmin"], bb["xmax"] = str(xmin), str(xmax)
                        bb["ymin"], bb["ymax"] = str(ymin), str(ymax)
                        new_obj.append(dict(item))
            annot["annotation"]["object"] = new_obj

        return image, convert2coco(annot, self.label2id)

    def __getitem__(self, index: int):
        index = index % len(self.images)
        img_gt, n_annot = None, 0
        while img_gt is None or n_annot == 0:
            gt_path, annot_path = self.images[index], self.annotations[index]
            img_gt, annot = self.load_items(gt_path, annot_path)
            n_annot = len(annot["boxes"]) if annot else 0
            if img_gt is None or n_annot == 0:
                index = random.randint(0, len(self) - 1)
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
        return gt, lq, _annot_to_numpy(annot), gt_path

    def __len__(self) -> int:
        return self.data_length if self.data_length > len(self.images) else len(self.images)


class PairedDetectionDataset:
    """Dumped (gt, lq) pairs + rescaled VOC annots; ref :197-277."""

    def __init__(
        self,
        root: str,
        path: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: int,
        year: str = "2012",
        image_set: str = "val",
        labels_path: Optional[str] = None,
        **_unused,
    ):
        self.images, self.annotations = voc_file_lists(root, year, image_set, "detection")
        self.path = path
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.gt_size = gt_size
        self.label2id = get_label2id(labels_path)

    def __getitem__(self, index: int):
        img_path, annot_path = self.images[index], self.annotations[index]
        gt_path = img_path.replace(
            "JPEGImages", os.path.join(self.path, "gt")
        ).replace(".jpg", ".png")
        lq_path = img_path.replace(
            "JPEGImages", os.path.join(self.path, "lq")
        ).replace(".jpg", ".png")
        gt = np.array(Image.open(io.BytesIO(self.file_backend.get(gt_path))).convert("RGB"))
        lq = np.array(Image.open(io.BytesIO(self.file_backend.get(lq_path))).convert("RGB"))
        annot = parse_voc_xml(ET.parse(annot_path).getroot())

        height = int(annot["annotation"]["size"]["height"])
        width = int(annot["annotation"]["size"]["width"])
        if height >= width:
            scale = self.gt_size / height
            height, width = self.gt_size, int(width * scale)
        else:
            scale = self.gt_size / width
            height, width = int(height * scale), self.gt_size
        assert gt.shape[:2] == (height, width)
        for item in annot["annotation"]["object"]:
            bb = item["bndbox"]
            bb["xmin"] = str(max(int(int(bb["xmin"]) * scale), 1))
            bb["xmax"] = str(min(int(int(bb["xmax"]) * scale), width))
            bb["ymin"] = str(max(int(int(bb["ymin"]) * scale), 1))
            bb["ymax"] = str(min(int(int(bb["ymax"]) * scale), height))
        annot = convert2coco(annot, self.label2id)

        gt = (gt / 255.0).astype(np.float32)
        lq = (lq / 255.0).astype(np.float32)
        return gt, lq, _annot_to_numpy(annot), gt_path

    def __len__(self) -> int:
        return len(self.images)


class RealworldDetectionDataset:
    """Folder of real LQ images, no annotations; ref :280-333."""

    def __init__(
        self,
        root: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: Optional[int] = None,
        **_unused,
    ):
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
        self.images = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.lower().endswith(exts)
        )
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.gt_size = gt_size

    def __getitem__(self, index: int):
        path = self.images[index]
        img = np.array(Image.open(io.BytesIO(self.file_backend.get(path))).convert("RGB"))
        if self.gt_size is not None:
            h, w = img.shape[:2]
            if h >= w:
                new_wh = (int(w * self.gt_size / h), self.gt_size)
            else:
                new_wh = (self.gt_size, int(h * self.gt_size / w))
            img = cv2.resize(img, new_wh, interpolation=cv2.INTER_CUBIC)
        lq = (img / 255.0).astype(np.float32)
        return lq, path

    def __len__(self) -> int:
        return len(self.images)
