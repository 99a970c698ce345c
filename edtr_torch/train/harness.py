"""Training/eval harness: batching, grouped sampling, dataloading.

Counterpart of ``edtr_tpu/train/harness.py``. The Real-ESRGAN branch of
:func:`prepare_batch` returns the transform's GT and LQ batches as tensors
on its device and slices the LQ list there; :func:`make_dataloader` reads
the process count and index from ``torch.distributed`` (1 and 0 without a
process group).

Parity with the reference's ``utils/detection.py`` harness:
  prepare_batch / list_to_batch -> :695-721,141-164 (HWC lists padded to a
    fixed 512 square NHWC batch; annotations to fixed-size padded arrays)
  GroupedBatchSampler           -> :173-351 (aspect-ratio grouped batches)
  collate_fn                    -> :354-355 (tuple-of-lists)

The batch is NHWC and annotations become fixed-size (MAX_GT) padded arrays
and masks, the static shapes the detector and the train steps take. Host
loading uses torch.utils.data.DataLoader for its worker pool.
"""

from __future__ import annotations

import bisect
import itertools
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from edtr_torch.parallel.distributed import process_rank

MAX_GT = 100


def list_to_batch(imgs: List[np.ndarray], img_size: int = 512) -> np.ndarray:
    """Pad HWC images bottom/right to (img_size, img_size); stack NHWC."""
    out = np.zeros((len(imgs), img_size, img_size, imgs[0].shape[-1]), np.float32)
    for i, img in enumerate(imgs):
        h, w = img.shape[:2]
        out[i, :h, :w] = img
    return out


def batch_to_list(batch, ref_imgs: List[np.ndarray]) -> list:
    """Crop each padded image back to its size (a tensor batch on its device)."""
    return [batch[i, : im.shape[0], : im.shape[1]] for i, im in enumerate(ref_imgs)]


def pad_annots(annot_list: List[Dict], max_gt: int = MAX_GT) -> Dict[str, np.ndarray]:
    """COCO-style dicts -> fixed-size {boxes, labels, valid} arrays."""
    b = len(annot_list)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i, ann in enumerate(annot_list):
        bx = np.asarray(ann["boxes"], np.float32).reshape(-1, 4)[:max_gt]
        lb = np.asarray(ann["labels"], np.int32).ravel()[:max_gt]
        n = len(bx)
        boxes[i, :n] = bx
        labels[i, :n] = lb
        valid[i, :n] = True
    return dict(boxes=boxes, labels=labels, valid=valid)


def prepare_batch(batch, img_size: int = 512, batch_transform=None):
    """Tuple-of-lists batch -> NHWC arrays + padded annots.

    Parity: ``prepare_batch`` (utils/detection.py:695-721). Two shapes:

    * CodeFormer path (``batch_transform is None``): the dataset already
      degraded per item; batch is (gt, lq, annot, path) lists.
    * RealESRGAN path: the COCO v2 dataset yields clean images + per-item
      blur kernels (hq, kernel1, kernel2, sinc_kernel, annot, path); the
      ``RealESRGANBatchTransform`` produces GT/LQ here on its device
      (reference: ``utils/detection.py:706-716``,
      ``main/det/train_edtr.py:115-117,163``).

    Returns (gt_list, lq_list, gt_batch, lq_batch, annot_list, path_list, bs).
    """
    if batch_transform is None:
        gt_list, lq_list, annot_list, path_list = batch
        gt_list = [np.asarray(g, np.float32) for g in gt_list]
        lq_list = [np.asarray(l, np.float32) for l in lq_list]
        gt_batch = list_to_batch(gt_list, img_size)
        lq_batch = list_to_batch(lq_list, img_size)
    else:
        gt_list, k1_list, k2_list, sk_list, annot_list, path_list = batch
        gt_list = [np.asarray(g, np.float32) for g in gt_list]
        gt_batch = list_to_batch(gt_list, img_size)
        out = batch_transform(dict(
            hq=gt_batch,
            kernel1=np.stack([np.asarray(k, np.float32) for k in k1_list]),
            kernel2=np.stack([np.asarray(k, np.float32) for k in k2_list]),
            sinc_kernel=np.stack([np.asarray(k, np.float32) for k in sk_list]),
        ))
        gt_batch, lq_batch = out["GT"], out["LQ"]
        lq_list = batch_to_list(lq_batch, gt_list)
    return gt_list, lq_list, gt_batch, lq_batch, list(annot_list), list(path_list), len(gt_list)


def collate_fn(batch):
    """tuple-of-lists collate; parity utils/detection.py:354-355."""
    return tuple(zip(*batch))


# -- aspect-ratio grouped batching ---------------------------------------------

def _quantize(x, bins):
    return [bisect.bisect_right(sorted(bins), v) for v in x]


def compute_aspect_ratios(dataset) -> List[float]:
    ratios = []
    for i in range(len(dataset)):
        if hasattr(dataset, "get_height_and_width"):
            h, w = dataset.get_height_and_width(i)
        elif hasattr(dataset, "images"):
            from PIL import Image

            with Image.open(dataset.images[i]) as im:
                w, h = im.size
        else:
            h = w = 1
        ratios.append(w / h)
    return ratios


class GroupedBatchSampler:
    """Yields batches whose elements share an aspect-ratio group.

    Parity: ``GroupedBatchSampler`` + ``create_aspect_ratio_groups``
    (utils/detection.py:173-351).
    """

    def __init__(self, sampler, group_ids: Sequence[int], batch_size: int):
        self.sampler = sampler
        self.group_ids = list(group_ids)
        self.batch_size = batch_size

    def __iter__(self):
        buffer_per_group = defaultdict(list)
        samples_per_group = defaultdict(list)
        num_batches = 0
        for idx in self.sampler:
            gid = self.group_ids[idx]
            buffer_per_group[gid].append(idx)
            samples_per_group[gid].append(idx)
            if len(buffer_per_group[gid]) == self.batch_size:
                yield buffer_per_group[gid]
                num_batches += 1
                del buffer_per_group[gid]
        # fill remaining batches by repeating from the same group
        expected = len(self)
        if num_batches < expected:
            for gid, buf in sorted(buffer_per_group.items(), key=lambda kv: -len(kv[1])):
                remaining = self.batch_size - len(buf)
                samples = samples_per_group[gid]
                buf.extend(itertools.islice(itertools.cycle(samples), remaining))
                yield buf
                num_batches += 1
                if num_batches >= expected:
                    break

    def __len__(self):
        # torch samplers expose __len__; avoid materializing the permutation
        # (this used to be an O(N) list build per call — COCO-scale waste)
        try:
            n = len(self.sampler)
        except TypeError:
            n = sum(1 for _ in self.sampler)
        return n // self.batch_size


def create_aspect_ratio_groups(dataset, k: int = 0) -> List[int]:
    ratios = compute_aspect_ratios(dataset)
    if k == 0:
        return [0] * len(ratios)
    bins = (2 ** np.linspace(-1, 1, 2 * k + 1)).tolist()
    return _quantize(ratios, bins)


class ShardedSampler:
    """Every ``process_count``-th index of a base sampler, starting at
    ``process_index`` — per-host dataloader sharding.

    Parity: Accelerate shards each rank's loader (DDP,
    ``main/det/train_edtr.py:138-139``). All hosts seed the base
    RandomSampler identically, so shards partition one global permutation.
    Like torch's DistributedSampler, shards are padded to EQUAL length by
    wrapping around the permutation — otherwise hosts with shorter shards
    would finish their epoch one step early and desynchronize their RNG
    streams from then on.
    """

    def __init__(self, base, process_index: int, process_count: int):
        self.base = base
        self.process_index = process_index
        self.process_count = process_count

    def __iter__(self):
        order = list(self.base)
        per_host = (len(order) + self.process_count - 1) // self.process_count
        shard = order[self.process_index::self.process_count]
        while len(shard) < per_host:  # wrap-pad (DistributedSampler semantics)
            shard.extend(order[: per_host - len(shard)])
        return iter(shard)

    def __len__(self):
        return (len(self.base) + self.process_count - 1) // self.process_count


def make_dataloader(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    num_workers: int = 0,
    aspect_ratio_group_factor: int = -1,
    seed: int = 231,
    drop_last: bool = True,
    collate=collate_fn,
    process_index: int = None,
    process_count: int = None,
    split_batches: bool = True,
):
    """Host dataloader: optional aspect-ratio grouped batching + per-host
    sharding. ``batch_size`` is GLOBAL when ``split_batches`` (the reference's
    ``DataLoaderConfiguration(split_batches=True)``): each host loads
    batch_size / process_count items."""
    import torch
    import torch.utils.data as tud

    if process_count is None:
        process_index, process_count = process_rank()

    if split_batches and process_count > 1:
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} must divide across "
                f"{process_count} hosts (split_batches semantics)")
        batch_size = batch_size // process_count

    if shuffle:
        g = torch.Generator()
        g.manual_seed(seed)  # same permutation on every host
        sampler = tud.RandomSampler(_TorchWrap(dataset), generator=g)
    else:
        sampler = tud.SequentialSampler(_TorchWrap(dataset))
    if process_count > 1:
        sampler = ShardedSampler(sampler, process_index, process_count)

    if aspect_ratio_group_factor >= 0:
        group_ids = create_aspect_ratio_groups(dataset, aspect_ratio_group_factor)
        batch_sampler = GroupedBatchSampler(sampler, group_ids, batch_size)
    else:
        batch_sampler = tud.BatchSampler(sampler, batch_size, drop_last=drop_last)
    return tud.DataLoader(
        _TorchWrap(dataset),
        batch_sampler=batch_sampler,
        num_workers=num_workers,
        collate_fn=collate,
    )


class _TorchWrap:
    """Minimal torch Dataset adapter around our plain datasets."""

    def __init__(self, ds):
        self.ds = ds

    def __getitem__(self, i):
        return self.ds[i]

    def __len__(self):
        return len(self.ds)
