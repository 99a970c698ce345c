"""Small synthetic datasets on disk, laid out as the configs' datasets are.

The VOC, COCO and image-folder trees the ``Degraded*`` and ``Paired*``
datasets read are not in the repository. These writers make seeded
stand-ins of the same layout (coloured boxes on a noisy background, their
annotations) so the data path runs end to end without them:

* :func:`write_voc_tree`: ``VOCdevkit/VOC2012/{JPEGImages, Annotations,
  SegmentationClass, ImageSets/{Main, Segmentation}/<split>.txt}``;
* :func:`write_coco_tree`: ``<split>2017/*.jpg`` and
  ``annotations/instances_<split>2017.json`` (boxes, polygons, a crowd
  RLE, an image without annotations);
* :func:`write_image_folder`: ``<class>/*.jpg`` for the classification
  datasets.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

VOC_NAMES = ("person", "car", "dog", "bicycle", "chair")


def _scene(g: np.random.Generator, h: int, w: int, n_boxes: int
           ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int, int]]]:
    """(H, W, 3) uint8 image and its boxes (x0, y0, x1, y1, class index)."""
    img = (g.random((h, w, 3)) * 64 + 96).astype(np.uint8)
    boxes = []
    for _ in range(n_boxes):
        bw, bh = int(g.integers(w // 6, w // 2)), int(g.integers(h // 6, h // 2))
        x0, y0 = int(g.integers(0, w - bw)), int(g.integers(0, h - bh))
        c = int(g.integers(0, len(VOC_NAMES)))
        img[y0:y0 + bh, x0:x0 + bw] = g.integers(0, 256, 3, dtype=np.uint8)
        boxes.append((x0, y0, x0 + bw, y0 + bh, c))
    return img, boxes


def _size(g: np.random.Generator, size_range: Tuple[int, int]) -> Tuple[int, int]:
    lo, hi = size_range
    return int(g.integers(lo, hi + 1)), int(g.integers(lo, hi + 1))


def write_voc_tree(root: str, n: int = 8, size_range: Tuple[int, int] = (96, 160),
                   splits: Sequence[str] = ("train", "val"), seed: int = 0) -> str:
    """A VOC2012 tree of ``n`` images, every split listing all of them;
    returns ``root``."""
    g = np.random.default_rng(seed)
    base = os.path.join(root, "VOCdevkit", "VOC2012")
    for d in ("JPEGImages", "Annotations", "SegmentationClass", "ImageSets/Main",
              "ImageSets/Segmentation"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    names = [f"2012_{i:06d}" for i in range(n)]
    for name in names:
        h, w = _size(g, size_range)
        img, boxes = _scene(g, h, w, int(g.integers(1, 4)))
        Image.fromarray(img).save(os.path.join(base, "JPEGImages", name + ".jpg"), quality=95)
        mask = np.zeros((h, w), np.uint8)
        objs = []
        for x0, y0, x1, y1, c in boxes:
            mask[y0:y1, x0:x1] = c + 1
            mask[y0, x0:x1] = mask[y1 - 1, x0:x1] = 255
            objs.append(f"<object><name>{VOC_NAMES[c]}</name><difficult>0</difficult>"
                        f"<bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin>"
                        f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>")
        Image.fromarray(mask, mode="P").save(os.path.join(base, "SegmentationClass",
                                                          name + ".png"))
        xml = (f"<annotation><folder>VOC2012</folder><filename>{name}.jpg</filename>"
               f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
               + "".join(objs) + "</annotation>")
        with open(os.path.join(base, "Annotations", name + ".xml"), "w") as f:
            f.write(xml)
    for split in splits:
        for sub in ("Main", "Segmentation"):
            with open(os.path.join(base, "ImageSets", sub, split + ".txt"), "w") as f:
                f.write("\n".join(names) + "\n")
    return root


def write_coco_tree(root: str, n: int = 8, size_range: Tuple[int, int] = (96, 160),
                    split: str = "train", seed: int = 0) -> str:
    """A COCO 2017 split of ``n`` images (the last without annotations, the
    first with a crowd RLE besides its boxes); returns ``root``."""
    g = np.random.default_rng(seed)
    img_dir = os.path.join(root, f"{split}2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = _size(g, size_range)
        img, boxes = _scene(g, h, w, int(g.integers(1, 4)))
        name = f"{i + 1:012d}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=95)
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        if i == n - 1:
            continue
        for x0, y0, x1, y1, c in boxes:
            poly = [x0, y0, x1, y0, x1, y1, x0, y1]
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=c + 1,
                             bbox=[x0, y0, x1 - x0, y1 - y0], area=float((x1 - x0) * (y1 - y0)),
                             iscrowd=0, segmentation=[[float(v) for v in poly]]))
        if i == 0:
            counts = [h * (w // 4), h * 2, h * w - h * (w // 4) - h * 2]
            anns.append(dict(id=len(anns) + 1, image_id=1, category_id=1,
                             bbox=[w // 4, 0, 2, h], area=float(2 * h), iscrowd=1,
                             segmentation=dict(size=[h, w], counts=counts)))
    cats = [dict(id=c + 1, name=name) for c, name in enumerate(VOC_NAMES)]
    with open(os.path.join(root, "annotations", f"instances_{split}2017.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return root


def write_image_folder(root: str, n_classes: int = 3, per_class: int = 2,
                       size_range: Tuple[int, int] = (96, 160), seed: int = 0) -> str:
    """``root/<class>/*.jpg``; returns ``root``."""
    g = np.random.default_rng(seed)
    for c in range(n_classes):
        d = os.path.join(root, f"{c:03d}.class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            h, w = _size(g, size_range)
            img, _ = _scene(g, h, w, 2)
            Image.fromarray(img).save(os.path.join(d, f"img_{i}.jpg"), quality=95)
    return root
