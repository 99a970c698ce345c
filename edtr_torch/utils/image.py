"""Image utilities (NCHW): the wavelet colour fix, padding, PSNR, luma and
LPIPS.

Counterpart of ``edtr_tpu/utils/image.py``: ``wavelet_blur`` /
``wavelet_decomposition`` / ``wavelet_reconstruction`` (a separable
[1, 2, 1] / 4 blur with dilation ``radius`` and replicate padding, five
levels, content high frequencies plus style low frequencies);
``pad_if_smaller`` and ``pad_to_multiples_of`` (bottom and right zeros);
``calculate_psnr`` over [0, 1] images; ``rgb2ycbcr_y`` (BT.601 luma);
``calculate_lpips`` (``models/lpips.py`` on an ``lpips`` package state
dict from ``weights_path`` or ``$EDTR_LPIPS_WEIGHTS``; without one it
raises ``NotImplementedError``, as JAX's does). JAX's functions are NHWC;
these take the port's NCHW.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    h, w = image.shape[-2:]
    p = F.pad(image, (0, 0, radius, radius), mode="replicate")
    v = (p[:, :, :h] + 2.0 * p[:, :, radius:h + radius] + p[:, :, 2 * radius:]) * 0.25
    p = F.pad(v, (radius, radius, 0, 0), mode="replicate")
    return (p[..., :w] + 2.0 * p[..., radius:w + radius] + p[..., 2 * radius:]) * 0.25


def wavelet_decomposition(image: torch.Tensor, levels: int = 5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ``(high_freq, low_freq)``."""
    high_freq = torch.zeros_like(image)
    low_freq = image
    for i in range(levels):
        low_freq = wavelet_blur(image, 2 ** i)
        high_freq = high_freq + (image - low_freq)
        image = low_freq
    return high_freq, low_freq


def wavelet_reconstruction(content_feat: torch.Tensor,
                           style_feat: torch.Tensor) -> torch.Tensor:
    """Content high frequencies + style low frequencies."""
    content_high, _ = wavelet_decomposition(content_feat)
    _, style_low = wavelet_decomposition(style_feat)
    return content_high + style_low


def pad_if_smaller(imgs: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad bottom and right so that H and W are at least ``size``."""
    h, w = imgs.shape[-2:]
    return F.pad(imgs, (0, max(0, size - w), 0, max(0, size - h)))


def pad_to_multiples_of(imgs: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad bottom and right to multiples of ``multiple``."""
    h, w = imgs.shape[-2:]
    return F.pad(imgs, (0, -w % multiple, 0, -h % multiple))


def rgb2ycbcr_y(img: torch.Tensor) -> torch.Tensor:
    """BT.601 luma (B, 1, H, W) of [0, 1] RGB (B, 3, H, W)."""
    w = torch.tensor([65.481, 128.553, 24.966], dtype=img.dtype, device=img.device) / 255.0
    return (img * w[:, None, None]).sum(1, keepdim=True) + 16.0 / 255.0


def calculate_psnr(img1: torch.Tensor, img2: torch.Tensor, crop_border: int = 0,
                   test_y_channel: bool = False) -> torch.Tensor:
    """(B,) PSNR in dB of [0, 1] batches, in fp64 when ``img1`` is fp64,
    else fp32; ``crop_border`` pixels cut from each side first;
    ``test_y_channel``: on the luma."""
    if crop_border:
        img1 = img1[..., crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[..., crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img1, img2 = rgb2ycbcr_y(img1), rgb2ycbcr_y(img2)
    img1 = img1.double() if img1.dtype == torch.float64 else img1.float()
    img2 = img2.to(img1.dtype)
    mse = (img1 - img2).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-12))


_LPIPS: Dict[tuple, torch.nn.Module] = {}


def calculate_lpips(img1: torch.Tensor, img2: torch.Tensor, net: str = "alex",
                    crop_border: int = 8, weights_path: Optional[str] = None) -> torch.Tensor:
    """(B,) LPIPS distances of [0, 1] batches on their device: scaled to
    [-1, 1], ``crop_border`` pixels cut from each side. The net
    (``models/lpips.py``, ``net`` "alex" or "vgg") loads an ``lpips``
    package state dict from ``weights_path`` or ``$EDTR_LPIPS_WEIGHTS``,
    once per file, net and device; without one this raises
    ``NotImplementedError``: the perceptual weights are not bundled."""
    from edtr_torch.models.lpips import load_lpips

    path = weights_path or os.environ.get("EDTR_LPIPS_WEIGHTS")
    if not path:
        raise NotImplementedError(
            "LPIPS needs pretrained perceptual weights: set $EDTR_LPIPS_WEIGHTS or pass "
            "weights_path to an `lpips` package state dict (see models/lpips.py)")
    key = (path, net, img1.device)
    if key not in _LPIPS:
        _LPIPS[key] = load_lpips(path, net, img1.device)
    x, y = img1 * 2.0 - 1.0, img2 * 2.0 - 1.0
    if crop_border:
        x = x[..., crop_border:-crop_border, crop_border:-crop_border]
        y = y[..., crop_border:-crop_border, crop_border:-crop_border]
    with torch.no_grad():
        return _LPIPS[key](x, y)
