"""Classification datasets (CUB200): degraded + paired.

Counterpart of ``edtr_tpu/data/classification.py``, host code copied.

Parity: ``datasets/classification.py``:
  DegradedClassificationDataset -> :24-155 (ImageFolder + resize shorter side
    to gt_size, optional crop to out_size, hflip augment, CodeFormer degrade)
  PairedClassificationDataset   -> :158-207 (pre-generated gt/lq dirs)

Returns numpy HWC RGB float32 [0,1] tuples ``(gt, lq, label, path)``.
"""

from __future__ import annotations

import io
import os
import random
import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
from PIL import Image

from edtr_torch.config import instantiate_from_config
from edtr_torch.data.augment import augment, center_crop_arr, random_crop_arr
from edtr_torch.data.degradation import codeformer_degrade

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_image_folder(root: str):
    """(path, class_idx) pairs + class list, torchvision ImageFolder layout."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        cdir = os.path.join(root, c)
        for dirpath, _, files in sorted(os.walk(cdir)):
            for fn in sorted(files):
                if fn.lower().endswith(IMG_EXTS):
                    samples.append((os.path.join(dirpath, fn), class_to_idx[c]))
    return samples, classes


class DegradedClassificationDataset:
    def __init__(
        self,
        root: str,
        file_backend_cfg: Mapping[str, Any],
        gt_size: int,
        out_size: Optional[int] = None,
        crop_type: str = "none",
        hflip: bool = False,
        rotation: bool = False,
        blur_kernel_size: Optional[int] = 41,
        kernel_list: Sequence[str] = ("iso", "aniso"),
        kernel_prob: Sequence[float] = (0.5, 0.5),
        blur_sigma: Sequence[float] = (0.1, 8),
        downsample_range: Sequence[float] = (1, 16),
        noise_range: Optional[Sequence[float]] = (0, 10),
        jpeg_range: Optional[Sequence[float]] = (50, 100),
        data_length: int = -1,
        random_index: bool = False,
        **_unused,
    ):
        self.imgs, self.classes = list_image_folder(root)
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
        self.noise_range = tuple(noise_range) if noise_range is not None else None
        self.jpeg_range = tuple(jpeg_range) if jpeg_range is not None else None
        self.data_length = data_length
        self.random_index = random_index

    def load_gt_image(self, path: str, max_retry: int = 5) -> Optional[np.ndarray]:
        image_bytes = None
        while image_bytes is None:
            if max_retry == 0:
                return None
            image_bytes = self.file_backend.get(path)
            max_retry -= 1
            if image_bytes is None:
                time.sleep(0.5)
        image = Image.open(io.BytesIO(image_bytes)).convert("RGB")
        # resize shorter side to gt_size (bicubic), crop/augment
        w, h = image.size
        if w >= h:
            image = image.resize(
                (int(self.gt_size * w / h), self.gt_size), Image.BICUBIC
            )
        else:
            image = image.resize(
                (self.gt_size, int(self.gt_size * h / w)), Image.BICUBIC
            )
        arr = np.array(image)
        if self.crop_type == "center":
            arr = center_crop_arr(arr, self.out_size)
        elif self.crop_type == "random":
            arr = random_crop_arr(arr, self.out_size)
        arr = augment(arr, self.hflip, self.rotation)
        return arr  # HWC RGB uint8

    def __getitem__(self, index: int):
        if self.random_index:
            index = random.randint(0, len(self.imgs) - 1)
        index = index % len(self.imgs)
        img_gt = None
        while img_gt is None:
            gt_path, label = self.imgs[index]
            img_gt = self.load_gt_image(gt_path)
            if img_gt is None:
                index = random.randint(0, len(self) - 1)
        # degrade in BGR [0,1] like the reference, return RGB
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
        return gt, lq, label, gt_path

    def __len__(self) -> int:
        return self.data_length if self.data_length > 0 else len(self.imgs)


class PairedClassificationDataset:
    """Pre-generated (gt, lq) image pairs in parallel folders."""

    def __init__(
        self,
        root: str,
        file_backend_cfg: Mapping[str, Any],
        gt_folder: str = "gt",
        lq_folder: str = "lq",
        data_length: int = -1,
        **_unused,
    ):
        self.gt_imgs, self.classes = list_image_folder(os.path.join(root, gt_folder))
        self.lq_imgs, _ = list_image_folder(os.path.join(root, lq_folder))
        assert len(self.gt_imgs) == len(self.lq_imgs)
        self.file_backend = instantiate_from_config(file_backend_cfg)
        self.data_length = data_length

    def _load(self, path: str) -> np.ndarray:
        data = self.file_backend.get(path)
        img = Image.open(io.BytesIO(data)).convert("RGB")
        return (np.array(img) / 255.0).astype(np.float32)

    def __getitem__(self, index: int):
        index = index % len(self.gt_imgs)
        gt_path, label = self.gt_imgs[index]
        lq_path, _ = self.lq_imgs[index]
        return self._load(gt_path), self._load(lq_path), label, gt_path

    def __len__(self) -> int:
        return self.data_length if self.data_length > 0 else len(self.gt_imgs)
