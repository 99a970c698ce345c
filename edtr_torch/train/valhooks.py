"""In-training validation and periodic image dumps of the port's runner.

Counterpart of ``edtr_tpu/train/valhooks.py`` (the val and image blocks of
the reference's train scripts, ``main/det/train_edtr.py:276-362``). Images
are NHWC in [0, 1], as JAX's: the restore functions take and return NHWC
batches on the device; the task nets' outputs are the port's (class logits
(B, K); a segmentation net's ``out`` logits (B, K, H, W)). The metrics stay
on the device until their host summaries (``utils/metrics``,
``utils/coco_eval``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from edtr_torch.data.coco import gt_from_dataset
from edtr_torch.train.harness import list_to_batch
from edtr_torch.utils.coco_eval import CocoEvaluator
from edtr_torch.utils.image import calculate_psnr
from edtr_torch.utils.metrics import compute_iou, confusion_matrix, topk_accuracy

# (restore_fn(lq NHWC, generator) -> restored NHWC)
RestoreFn = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def save_image_grid(img_dir: str, step: int, rows: Dict[str, object], max_cols: int = 4) -> str:
    """JAX's PNG grid at ``img_dir/step_{step:07d}.png``: one row per named
    (B, H, W, 3) batch in [0, 1] (tensors or arrays), one column per sample
    up to ``max_cols``, NaN as 0, clipped, ``* 255`` truncated to uint8 (the
    same bytes as JAX's for the same values). Returns the path."""
    from PIL import Image

    arrays = {name: _host(v) for name, v in rows.items()}
    cols = min(max_cols, min(a.shape[0] for a in arrays.values()))
    h = min(a.shape[1] for a in arrays.values())
    w = min(a.shape[2] for a in arrays.values())
    grid = np.zeros((len(arrays) * h, cols * w, 3), np.uint8)
    for r, arr in enumerate(arrays.values()):
        arr = np.clip(np.nan_to_num(arr), 0, 1)
        for c in range(cols):
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = (arr[c, :h, :w] * 255).astype(np.uint8)
    os.makedirs(img_dir, exist_ok=True)
    path = os.path.join(img_dir, f"step_{step:07d}.png")
    Image.fromarray(grid).save(path)
    return path


def _psnr(restored: torch.Tensor, gt: torch.Tensor) -> float:
    return float(calculate_psnr(restored.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2))[0])


def validate_detection(dataset, det_fn: Callable, det, generator: Optional[torch.Generator],
                       restore_fn: Optional[RestoreFn] = None, max_images: Optional[int] = None,
                       img_size: int = 512, device=None) -> Dict[str, float]:
    """JAX's ``validate_detection``: image by image (bs 1) each lq padded to
    ``img_size`` by ``list_to_batch`` onto ``device``, restored (``restore_fn``,
    drawing from ``generator``; PSNR on the unpadded crop), detected by
    ``det_fn(det, x) -> dets`` (padded ``boxes``, ``scores``, ``labels`` and
    their ``valid`` mask), the valid ones into a ``CocoEvaluator`` over
    ``gt_from_dataset``. Returns the 12 COCO stats (and ``psnr``)."""
    evaluator = CocoEvaluator(gt_from_dataset(dataset))
    n = min(len(dataset), max_images or len(dataset))
    psnrs = []
    for i in range(n):
        gt, lq, annot, _ = dataset[i]
        h, w = gt.shape[:2]
        x = torch.from_numpy(list_to_batch([lq], img_size)).to(device)
        if restore_fn is not None:
            x = restore_fn(x, generator)
            gt_b = torch.from_numpy(list_to_batch([gt], img_size)).to(x.device)
            psnrs.append(_psnr(x[:, :h, :w], gt_b[:, :h, :w]))
        dets = det_fn(det, x)
        valid = dets["valid"][0]
        evaluator.update({annot["image_id"]: dict(boxes=dets["boxes"][0][valid],
                                                  scores=dets["scores"][0][valid],
                                                  labels=dets["labels"][0][valid])})
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    stats = evaluator.summarize(verbose=False)
    if psnrs:
        stats["psnr"] = float(np.mean(psnrs))
    return stats


def task_scores(task: str, out, target) -> tuple:
    """(top-1 correct count, None) of class logits against a label, or
    (None, confusion matrix) of a segmentation net's ``out`` logits (B, K,
    H, W) argmax against a mask: one image's contribution."""
    if task == "cls":
        return int(topk_accuracy(out, torch.as_tensor([target]))[0]), None
    logits = out["out"]
    pred = logits.argmax(1)[0]
    return None, confusion_matrix(pred, torch.as_tensor(target).to(pred.device),
                                  logits.shape[1])


def task_stats(task: str, correct: int, total: int, mats) -> Dict[str, float]:
    """top-1 (cls) or mIoU (seg) of the summed scores."""
    if task == "cls":
        return {"top1": correct / max(total, 1)}
    return {} if mats is None else {"miou": compute_iou(mats)[1]}


def validate_task(task: str, dataset, net_apply: Callable, net,
                  generator: Optional[torch.Generator], restore_fn: Optional[RestoreFn] = None,
                  max_images: Optional[int] = None, device=None) -> Dict[str, float]:
    """JAX's ``validate_task``: image by image each lq (NHWC, onto
    ``device``) restored by ``restore_fn`` (PSNR against gt), then
    ``net_apply(net, x)``: top-1 (cls) or the mIoU of the summed confusion
    matrices (seg)."""
    n = min(len(dataset), max_images or len(dataset))
    psnrs, correct, total, mats = [], 0, 0, None
    for i in range(n):
        gt, lq, target, _ = dataset[i]
        x = torch.from_numpy(np.asarray(lq, np.float32))[None].to(device)
        if restore_fn is not None:
            x = restore_fn(x, generator)
            psnrs.append(_psnr(x, torch.from_numpy(np.asarray(gt, np.float32))[None].to(x.device)))
        hit, mat = task_scores(task, net_apply(net, x), target)
        if task == "cls":
            correct, total = correct + hit, total + 1
        else:
            mats = mat if mats is None else mats + mat
    stats: Dict[str, float] = {}
    if psnrs:
        stats["psnr"] = float(np.mean(psnrs))
    stats.update(task_stats(task, correct, total, mats))
    return stats


def log_val_stats(logger, writer, step: int, stats: Dict[str, float],
                  prefix: str = "val") -> None:
    """JAX's ``log_val_stats``: one ``{prefix} @ step`` line of the float
    stats, each number to the writer under ``{prefix}/{name}``."""
    logger(f"{prefix} @ step {step}: "
           + " ".join(f"{k}={v:.4f}" for k, v in stats.items() if isinstance(v, float)))
    if writer:
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                writer.add_scalar(f"{prefix}/{k}", v, step)
