"""Paired augmentation and crops of the port's datasets (host numpy).

Counterpart of ``edtr_tpu/data/augment.py``, copied: hflip, vflip and
rot90 applied alike to every array of a list (``datasets/augment.py:35-99``
of the reference) and the center/random crops with optional returned
offsets (``datasets/utils.py:11-36``).
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple, Union

import numpy as np


def augment(
    imgs: Union[np.ndarray, List[np.ndarray]],
    hflip: bool = True,
    rotation: bool = True,
    return_status: bool = False,
    rng: Optional[random.Random] = None,
):
    """hflip (p=.5), vflip+rot90 (p=.5 each) applied to all arrays alike."""
    r = rng or random
    do_hflip = hflip and r.random() < 0.5
    do_vflip = rotation and r.random() < 0.5
    do_rot90 = rotation and r.random() < 0.5

    def _aug(img: np.ndarray) -> np.ndarray:
        if do_hflip:
            img = img[:, ::-1, ...]
        if do_vflip:
            img = img[::-1, :, ...]
        if do_rot90:
            img = np.transpose(img, (1, 0) + tuple(range(2, img.ndim)))
        return np.ascontiguousarray(img)

    single = not isinstance(imgs, list)
    out = [_aug(i) for i in ([imgs] if single else imgs)]
    out = out[0] if single else out
    if return_status:
        return out, (do_hflip, do_vflip, do_rot90)
    return out


def center_crop_arr(
    arr: np.ndarray, size: int, return_params: bool = False
):
    h, w = arr.shape[:2]
    y0 = (h - size) // 2
    x0 = (w - size) // 2
    out = arr[y0 : y0 + size, x0 : x0 + size, ...]
    if return_params:
        return out, (y0, x0)
    return out


def random_crop_arr(
    arr: np.ndarray,
    size: int,
    return_params: bool = False,
    crop_pos: Optional[Tuple[int, int]] = None,
    rng: Optional[random.Random] = None,
):
    r = rng or random
    h, w = arr.shape[:2]
    if crop_pos is None:
        y0 = r.randrange(h - size + 1)
        x0 = r.randrange(w - size + 1)
    else:
        y0, x0 = crop_pos
    out = arr[y0 : y0 + size, x0 : x0 + size, ...]
    if return_params:
        return out, (y0, x0)
    return out
