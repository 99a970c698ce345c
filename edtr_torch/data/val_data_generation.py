"""Deterministic degraded val-set generation (seed 231).

Counterpart of ``edtr_tpu/data/val_data_generation.py`` (the reference's
``datasets/val_data_generation/gen_{det,seg,cls}-dataset.py``): instantiate the Degraded* dataset from a config, fix the
seed, and dump gt/lq PNG pairs next to the source tree so the Paired*
datasets can evaluate reproducibly.

Usage:
    python -m edtr_torch.data.val_data_generation --config <yaml> --task det

One seed writes the same files every run: the port's ``Degraded*``
datasets draw their CodeFormer generator from the seeded numpy state
(``edtr_torch.data.degradation.default_rng``), which JAX's do not.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch
from PIL import Image

from edtr_torch.config import instantiate_from_config, load_config


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def generate(cfg_path: str, task: str, seed: int = 231,
             out_name: str = None, limit: int = -1) -> str:
    cfg = load_config(cfg_path)
    set_seed(seed)
    ds_cfg = cfg["dataset"] if "dataset" in cfg else cfg
    node = ds_cfg.get("val_generation", None) or ds_cfg.get("train", None) or ds_cfg
    dataset = instantiate_from_config(node)

    root = node["params"]["root"]
    out_name = out_name or {
        "det": "JPEGImagesDet-deg",
        "seg": "JPEGImagesSeg-deg",
        "cls": "val-deg",
    }[task]
    # VOC tree layout (det/seg); cls uses a sibling folder of the split root
    base = os.path.join(root, "VOCdevkit", "VOC2012") if task in ("det", "seg") else root
    if task in ("det", "seg") and not os.path.isdir(base):
        base = os.path.join(root, "VOC2012")
    gt_dir = os.path.join(base, out_name, "gt")
    lq_dir = os.path.join(base, out_name, "lq")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(lq_dir, exist_ok=True)

    n = len(dataset) if limit <= 0 else min(limit, len(dataset))
    for i in range(n):
        item = dataset[i]
        gt, lq = item[0], item[1]
        path = item[-1]
        name = os.path.splitext(os.path.basename(path))[0]
        Image.fromarray((np.clip(gt, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(gt_dir, name + ".png"))
        Image.fromarray((np.clip(lq, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(lq_dir, name + ".png"))
    print(f"wrote {n} gt/lq pairs under {os.path.dirname(gt_dir)}")
    return os.path.dirname(gt_dir)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--task", choices=["det", "seg", "cls"], required=True)
    p.add_argument("--seed", type=int, default=231)
    p.add_argument("--limit", type=int, default=-1)
    args = p.parse_args()
    generate(args.config, args.task, args.seed, limit=args.limit)
