"""Pascal VOC dataset scaffolding (host-side).

Counterpart of ``edtr_tpu/data/voc.py``, host code copied.

Replaces the torchvision ``VOCDetection``/``VOCSegmentation`` base classes
the reference inherits from (``datasets/detection.py:26``,
``datasets/segmentation.py:24``): file listing from
``VOCdevkit/VOC{year}/ImageSets``, XML annotation parsing, and the VOC->COCO
annotation conversion (``datasets/utils.py:40-67``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

VOC_LABELS = (
    "aeroplane bicycle bird boat bottle bus car cat chair cow diningtable "
    "dog horse motorbike person pottedplant sheep sofa train tvmonitor"
).split()


def get_label2id(labels_path: Optional[str] = None) -> Dict[str, int]:
    """1-indexed label map; parity ``datasets/utils.py:38-45``."""
    labels = VOC_LABELS
    if labels_path and os.path.exists(labels_path):
        with open(labels_path) as f:
            labels = f.read().split()
    return {name: i + 1 for i, name in enumerate(labels)}


def voc_file_lists(
    root: str, year: str, image_set: str, task: str
) -> Tuple[List[str], List[str]]:
    """(images, annotations-or-masks) path lists for a VOC split."""
    base = os.path.join(root, "VOCdevkit", f"VOC{year}")
    if not os.path.isdir(base):
        base = os.path.join(root, f"VOC{year}")
    if task == "detection":
        split_file = os.path.join(base, "ImageSets", "Main", f"{image_set}.txt")
        tgt_dir, tgt_ext = os.path.join(base, "Annotations"), ".xml"
    else:
        split_file = os.path.join(base, "ImageSets", "Segmentation", f"{image_set}.txt")
        tgt_dir, tgt_ext = os.path.join(base, "SegmentationClass"), ".png"
    with open(split_file) as f:
        names = [line.strip() for line in f if line.strip()]
    images = [os.path.join(base, "JPEGImages", f"{n}.jpg") for n in names]
    targets = [os.path.join(tgt_dir, f"{n}{tgt_ext}") for n in names]
    return images, targets


def parse_voc_xml(node: ET.Element) -> Dict:
    """ElementTree -> nested dict (torchvision ``parse_voc_xml`` semantics)."""
    voc_dict: Dict = {}
    children = list(node)
    if children:
        def_dic: Dict = {}
        for dc in map(parse_voc_xml, children):
            for ind, v in dc.items():
                def_dic.setdefault(ind, []).append(v)
        if node.tag == "annotation":
            def_dic["object"] = def_dic.get("object", [])
        voc_dict = {
            node.tag: {
                ind: v[0] if len(v) == 1 and ind != "object" else v
                for ind, v in def_dic.items()
            }
        }
    if node.text and node.text.strip():
        voc_dict[node.tag] = node.text.strip()
    return voc_dict


def convert2coco(obj: Dict, label2id: Dict[str, int]) -> Dict:
    """VOC dict -> COCO-style annotation; parity ``datasets/utils.py:47-67``."""
    ann = {"boxes": [], "labels": [], "image_id": [], "area": [], "iscrowd": []}
    ann["image_id"] = os.path.splitext(obj["annotation"]["filename"])[0]
    for each_obj in obj["annotation"]["object"]:
        label = each_obj["name"]
        assert label in label2id, f"{label} not in label2id"
        bnd = each_obj["bndbox"]
        xmin = int(float(bnd["xmin"])) - 1
        ymin = int(float(bnd["ymin"])) - 1
        xmax = int(float(bnd["xmax"]))
        ymax = int(float(bnd["ymax"]))
        assert xmax > xmin and ymax > ymin
        ann["boxes"].append([xmin, ymin, xmax, ymax])
        ann["labels"].append(label2id[label])
        ann["area"].append((xmax - xmin) * (ymax - ymin))
        ann["iscrowd"].append(0)
    return ann
