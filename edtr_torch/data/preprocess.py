"""Dataset preprocessing: unzip/reorganize the Kaggle CUB200 / VOC2012 dumps.

Counterpart of ``edtr_tpu/data/preprocess.py``, copied (host code). Parity:
``datasets/preprocess/{cub200,voc2012}.py``.

Usage:
    python -m edtr_torch.data.preprocess cub200 [--source datasets/source]
    python -m edtr_torch.data.preprocess voc2012 [--source datasets/source]
"""

from __future__ import annotations

import argparse
import os
import shutil
import zipfile


def preprocess_cub200(source: str = "datasets/source") -> None:
    archive = os.path.join(source, "archive.zip")
    if not os.path.exists(archive):
        print(f"FAILED: {archive} does not exist")
        return
    print("Unzipping archive.zip ...")
    with zipfile.ZipFile(archive) as z:
        z.extractall(source)

    base = os.path.join(source, "CUB_200_2011")
    with open(os.path.join(base, "images.txt")) as f:
        img_names = f.readlines()
    with open(os.path.join(base, "train_test_split.txt")) as f:
        splits = f.readlines()

    for img_line, split_line in zip(img_names, splits):
        idx1, filename = img_line.strip().split(" ")
        idx2, is_train = split_line.strip().split(" ")
        assert idx1 == idx2
        split = "train" if is_train == "1" else "val"
        dst_dir = os.path.join(source, "CUB200", split, os.path.dirname(filename))
        os.makedirs(dst_dir, exist_ok=True)
        shutil.copyfile(
            os.path.join(base, "images", filename),
            os.path.join(dst_dir, os.path.basename(filename)),
        )

    for junk in ("CUB_200_2011", "cvpr2016_cub", "segmentations"):
        p = os.path.join(source, junk)
        if os.path.isdir(p):
            shutil.rmtree(p)
    for junk in ("attributes.txt", "archive.zip"):
        p = os.path.join(source, junk)
        if os.path.exists(p):
            os.remove(p)
    print("Done; CUB200 at", os.path.join(source, "CUB200"))


def preprocess_voc2012(source: str = "datasets/source") -> None:
    archive = os.path.join(source, "archive.zip")
    if not os.path.exists(archive):
        print(f"FAILED: {archive} does not exist")
        return
    print("Unzipping archive.zip ...")
    with zipfile.ZipFile(archive) as z:
        z.extractall(source)
    dst = os.path.join(source, "VOC", "VOCdevkit", "VOC2012")
    shutil.copytree(
        os.path.join(source, "VOC2012_train_val", "VOC2012_train_val"),
        dst, dirs_exist_ok=True,
    )
    for junk in ("VOC2012_test", "VOC2012_train_val"):
        p = os.path.join(source, junk)
        if os.path.isdir(p):
            shutil.rmtree(p)
    if os.path.exists(archive):
        os.remove(archive)
    print("Done; VOC at", dst)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["cub200", "voc2012"])
    p.add_argument("--source", default="datasets/source")
    args = p.parse_args()
    {"cub200": preprocess_cub200, "voc2012": preprocess_voc2012}[args.dataset](args.source)
