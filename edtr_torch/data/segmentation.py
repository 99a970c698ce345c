"""Segmentation datasets (VOC2012): degraded + paired.

Counterpart of ``edtr_tpu/data/segmentation.py``, host code copied.

Parity: ``datasets/segmentation.py``:
  DegradedSegmentationDataset -> :24-174 (VOCSegmentation + shorter-side
    resize to gt_size*r, mask NEAREST, pad with 255 ignore, crop, augment,
    CodeFormer degrade)
  PairedSegmentationDataset   -> :177-242

Returns ``(gt, lq, mask, path)``: HWC RGB float32 [0,1] + uint8 mask.
"""

from __future__ import annotations

import io
import random
import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
from PIL import Image

from edtr_torch.config import instantiate_from_config
from edtr_torch.data.augment import augment, center_crop_arr, random_crop_arr
from edtr_torch.data.degradation import codeformer_degrade
from edtr_torch.data.voc import voc_file_lists


class DegradedSegmentationDataset:
    def __init__(
        self,
        root: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: int,
        resize_range: Optional[Sequence[float]],
        out_size: Optional[int],
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
        data_length: int = -1,
        **_unused,
    ):
        self.images, self.masks = voc_file_lists(root, year, image_set, "segmentation")
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.gt_size = gt_size
        self.resize_range = tuple(resize_range) if resize_range else None
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
        self.data_length = data_length

    def load_items(self, image_path: str, mask_path: str, max_retry: int = 5):
        image_bytes = None
        while image_bytes is None:
            if max_retry == 0:
                return None, None
            image_bytes = self.file_backend.get(image_path)
            max_retry -= 1
            if image_bytes is None:
                time.sleep(0.5)
        image = Image.open(io.BytesIO(image_bytes)).convert("RGB")
        mask = Image.open(mask_path)

        r = random.uniform(*self.resize_range) if self.resize_range else 1.0
        w, h = image.size
        if w >= h:
            tw, th = int(self.gt_size * w / h * r), int(self.gt_size * r)
        else:
            tw, th = int(self.gt_size * r), int(self.gt_size * h / w * r)
        image = image.resize((tw, th), Image.BICUBIC)
        mask = mask.resize((tw, th), Image.NEAREST)
        image, mask = np.array(image), np.array(mask)

        # pad short side with 0 (image) / 255 ignore (mask); ref :96-101
        if self.out_size is not None and min(mask.shape) < self.out_size:
            oh, ow = mask.shape
            padh = max(self.out_size - oh, 0)
            padw = max(self.out_size - ow, 0)
            image = np.pad(image, ((0, padh), (0, padw), (0, 0)))
            mask = np.pad(mask, ((0, padh), (0, padw)), constant_values=255)

        if self.crop_type == "center":
            image = center_crop_arr(image, self.out_size)
            mask = center_crop_arr(mask, self.out_size)
        elif self.crop_type == "random":
            image, pos = random_crop_arr(image, self.out_size, return_params=True)
            mask = random_crop_arr(mask, self.out_size, crop_pos=pos)

        image, mask = augment([image, mask], self.hflip, self.rotation)
        return image, mask

    def __getitem__(self, index: int):
        index = index % len(self.images)
        img_gt = None
        while img_gt is None:
            gt_path, mask_path = self.images[index], self.masks[index]
            img_gt, mask = self.load_items(gt_path, mask_path)
            if img_gt is None:
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
        return gt, lq, mask, gt_path

    def __len__(self) -> int:
        return self.data_length if self.data_length > len(self.images) else len(self.images)


class PairedSegmentationDataset:
    """Pre-generated gt/lq pairs over VOC segmentation val split.

    Parity: ``datasets/segmentation.py:177-242`` (optional 512 center crop).
    """

    def __init__(
        self,
        root: str,
        path: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: int = 512,
        year: str = "2012",
        image_set: str = "val",
        center_crop: bool = False,
        data_length: int = -1,
        **_unused,
    ):
        import os

        self.images, self.masks = voc_file_lists(root, year, image_set, "segmentation")
        # dumped pairs: JPEGImages -> {path}/gt|lq, .jpg -> .png (ref :228-230)
        self.gt_images = [
            img.replace("JPEGImages", os.path.join(path, "gt")).replace(".jpg", ".png")
            for img in self.images
        ]
        self.lq_images = [
            img.replace("JPEGImages", os.path.join(path, "lq")).replace(".jpg", ".png")
            for img in self.images
        ]
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.gt_size = gt_size
        self.center_crop = center_crop
        self.data_length = data_length

    def _load_rgb(self, path: str) -> np.ndarray:
        data = self.file_backend.get(path)
        return np.array(Image.open(io.BytesIO(data)).convert("RGB"))

    def __getitem__(self, index: int):
        index = index % len(self.images)
        gt = self._load_rgb(self.gt_images[index])
        lq = self._load_rgb(self.lq_images[index])
        mask = Image.open(self.masks[index])
        mask = np.array(mask.resize((gt.shape[1], gt.shape[0]), Image.NEAREST))
        if self.center_crop:
            gt = center_crop_arr(gt, 512)
            lq = center_crop_arr(lq, 512)
            mask = center_crop_arr(mask, 512)
        gt = (gt / 255.0).astype(np.float32)
        lq = (lq / 255.0).astype(np.float32)
        return gt, lq, mask, self.gt_images[index]

    def __len__(self) -> int:
        return self.data_length if self.data_length > 0 else len(self.images)
