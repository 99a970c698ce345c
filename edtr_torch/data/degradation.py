"""Degradation kernels, noises and JPEG of the port's data path.

Counterpart of ``edtr_tpu/data/degradation.py``. The host part is a copy
(numpy, cv2, scipy): the bivariate Gaussian, generalized Gaussian and
plateau blur kernels, ``random_mixed_kernels``, the sinc
``circular_lowpass_kernel``, Gaussian/Poisson noise and cv2 JPEG for one
HWC image, and :func:`codeformer_degrade`, the blur -> downsample ->
noise -> JPEG -> resize-back block every ``Degraded*`` dataset runs.

The batched part runs on the card in torch, NCHW: :func:`filter2d`
(reflect padding, one kernel per sample, depthwise ``conv2d`` with
``groups = B*C`` row by row, the rows summed in fp64), :func:`random_add_gaussian_noise_pt` and
:func:`random_add_poisson_noise_pt` (JAX's ``*_jax``: the Poisson noise is
JAX's matched-variance normal with ``vals`` = 256). Their random draws are
tensors: from a ``torch.Generator`` on the image's device, or given as
``draws`` (the parity tests hand in the values JAX's keys drew).

One repair: a host function called without ``rng`` (every ``Degraded*``
dataset's :func:`codeformer_degrade`, the COCO v2 dataset's
``random_mixed_kernels``) draws its generator from the seeded global numpy
state (:func:`default_rng`), where JAX's called ``np.random.default_rng()``,
which no seed reaches.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def default_rng() -> np.random.Generator:
    """A numpy Generator seeded from the global ``np.random`` state, so
    ``np.random.seed`` (``set_seed``) fixes what it draws."""
    return np.random.default_rng(np.random.randint(0, 2 ** 31 - 1))


# ---------------------------------------------------------------------------
# blur kernels (host numpy)
# ---------------------------------------------------------------------------

def mesh_grid(kernel_size: int):
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    grid = np.stack([xx, yy], axis=-1)  # (K, K, 2)
    return grid, xx, yy


def sigma_matrix2(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    return u @ d @ u.T


def pdf2(sigma_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum((grid @ inv) * grid, axis=2))


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, isotropic=True):
    grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = sigma_matrix2(sig_x, sig_y, theta)
    k = pdf2(sigma, grid)
    return k / k.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, isotropic=True):
    grid, _, _ = mesh_grid(kernel_size)
    sigma = (
        np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
        if isotropic
        else sigma_matrix2(sig_x, sig_y, theta)
    )
    inv = np.linalg.inv(sigma)
    k = np.exp(-0.5 * np.power(np.sum((grid @ inv) * grid, 2), beta))
    return k / k.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, isotropic=True):
    grid, _, _ = mesh_grid(kernel_size)
    sigma = (
        np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
        if isotropic
        else sigma_matrix2(sig_x, sig_y, theta)
    )
    inv = np.linalg.inv(sigma)
    k = np.reciprocal(np.power(np.sum((grid @ inv) * grid, 2), beta) + 1)
    return k / k.sum()


def _rand_ks_params(rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range, isotropic):
    assert kernel_size % 2 == 1
    sigma_x = rng.uniform(*sigma_x_range)
    if isotropic:
        return sigma_x, sigma_x, 0.0
    sigma_y = rng.uniform(*sigma_y_range)
    rotation = rng.uniform(*rotation_range)
    return sigma_x, sigma_y, rotation


def _maybe_noise(rng, kernel, noise_range):
    if noise_range is not None:
        noise = rng.uniform(noise_range[0], noise_range[1], size=kernel.shape)
        kernel = kernel * noise
    return kernel / kernel.sum()


def random_bivariate_gaussian(
    kernel_size, sigma_x_range, sigma_y_range, rotation_range,
    noise_range=None, isotropic=True, rng: Optional[np.random.Generator] = None,
):
    rng = rng or default_rng()
    sx, sy, rot = _rand_ks_params(rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range, isotropic)
    k = bivariate_gaussian(kernel_size, sx, sy, rot, isotropic)
    return _maybe_noise(rng, k, noise_range)


def random_bivariate_generalized_gaussian(
    kernel_size, sigma_x_range, sigma_y_range, rotation_range, beta_range,
    noise_range=None, isotropic=True, rng=None,
):
    rng = rng or default_rng()
    sx, sy, rot = _rand_ks_params(rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range, isotropic)
    # reference samples beta <1 or >1 uniformly around 1
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1)
    else:
        beta = rng.uniform(1, beta_range[1])
    k = bivariate_generalized_gaussian(kernel_size, sx, sy, rot, beta, isotropic)
    return _maybe_noise(rng, k, noise_range)


def random_bivariate_plateau(
    kernel_size, sigma_x_range, sigma_y_range, rotation_range, beta_range,
    noise_range=None, isotropic=True, rng=None,
):
    rng = rng or default_rng()
    sx, sy, rot = _rand_ks_params(rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range, isotropic)
    if rng.uniform() < 0.5:
        beta = rng.uniform(beta_range[0], 1)
    else:
        beta = rng.uniform(1, beta_range[1])
    k = bivariate_plateau(kernel_size, sx, sy, rot, beta, isotropic)
    return _maybe_noise(rng, k, noise_range)


def random_mixed_kernels(
    kernel_list: Sequence[str],
    kernel_prob: Sequence[float],
    kernel_size: int = 21,
    sigma_x_range=(0.6, 5),
    sigma_y_range=(0.6, 5),
    rotation_range=(-math.pi, math.pi),
    betag_range=(0.5, 8),
    betap_range=(0.5, 8),
    noise_range=None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Parity: ``random_mixed_kernels`` (``datasets/degradation.py:325-384``)."""
    rng = rng or default_rng()
    kind = rng.choice(kernel_list, p=kernel_prob)
    common = dict(rng=rng, noise_range=noise_range)
    if kind == "iso":
        return random_bivariate_gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            isotropic=True, **common)
    if kind == "aniso":
        return random_bivariate_gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            isotropic=False, **common)
    if kind == "generalized_iso":
        return random_bivariate_generalized_gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, isotropic=True, **common)
    if kind == "generalized_aniso":
        return random_bivariate_generalized_gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, isotropic=False, **common)
    if kind == "plateau_iso":
        return random_bivariate_plateau(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betap_range, isotropic=True, **common)
    if kind == "plateau_aniso":
        return random_bivariate_plateau(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betap_range, isotropic=False, **common)
    raise ValueError(f"unknown kernel kind {kind}")


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2-D sinc filter; parity ``datasets/degradation.py:390-410``."""
    from scipy.special import j1

    assert kernel_size % 2 == 1
    c = (kernel_size - 1) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        xs, ys = np.meshgrid(np.arange(kernel_size), np.arange(kernel_size))
        r = np.sqrt((xs - c) ** 2 + (ys - c) ** 2)
        kernel = cutoff * j1(cutoff * r) / (2 * np.pi * r)
    kernel[int(c), int(c)] = cutoff ** 2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


# ---------------------------------------------------------------------------
# noise (host numpy)
# ---------------------------------------------------------------------------

def _apply_clip_round(out, clip, rounds, xp):
    if clip and rounds:
        return xp.clip((out * 255.0).round(), 0, 255) / 255.0
    if clip:
        return xp.clip(out, 0, 1)
    if rounds:
        return (out * 255.0).round() / 255.0
    return out


def add_gaussian_noise(img, sigma=10, clip=True, rounds=False, gray_noise=False, rng=None):
    rng = rng or default_rng()
    if gray_noise:
        noise = rng.standard_normal(img.shape[:2]).astype(np.float32) * sigma / 255.0
        noise = np.repeat(noise[:, :, None], 3, axis=2)
    else:
        noise = rng.standard_normal(img.shape).astype(np.float32) * sigma / 255.0
    return _apply_clip_round(img + noise, clip, rounds, np)


def random_add_gaussian_noise(img, sigma_range=(0, 1.0), gray_prob=0, clip=True, rounds=False, rng=None):
    rng = rng or default_rng()
    sigma = rng.uniform(*sigma_range)
    gray = rng.uniform() < gray_prob
    return add_gaussian_noise(img, sigma, clip, rounds, gray, rng)


def add_poisson_noise(img, scale=1.0, clip=True, rounds=False, gray_noise=False, rng=None):
    """Poisson (shot) noise; parity ``generate_poisson_noise`` semantics."""
    rng = rng or default_rng()
    base = cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_BGR2GRAY) / 255.0 if gray_noise else img
    base = np.clip(base, 0, 1)
    vals = 10 ** np.ceil(np.log10(len(np.unique((base * 255).astype(np.uint8)))))
    noisy = rng.poisson(base * vals) / float(vals)
    noise = noisy - base
    if gray_noise:
        noise = np.repeat(noise[:, :, None], 3, axis=2)
    return _apply_clip_round(img + noise * scale, clip, rounds, np)


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0, clip=True, rounds=False, rng=None):
    rng = rng or default_rng()
    scale = rng.uniform(*scale_range)
    gray = rng.uniform() < gray_prob
    return add_poisson_noise(img, scale, clip, rounds, gray, rng)


# ---------------------------------------------------------------------------
# JPEG (host cv2)
# ---------------------------------------------------------------------------

def add_jpg_compression(img, quality=90):
    img = np.clip(img, 0, 1)
    _, enc = cv2.imencode(".jpg", img * 255.0, [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    return np.float32(cv2.imdecode(enc, 1)) / 255.0


def random_add_jpg_compression(img, quality_range=(90, 100), rng=None):
    rng = rng or default_rng()
    quality = rng.uniform(*quality_range)
    return add_jpg_compression(img, int(quality))


# ---------------------------------------------------------------------------
# batched device variants (torch, NCHW) -- the Real-ESRGAN transform on the card
# ---------------------------------------------------------------------------

def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Batched depthwise filter, reflect padding; JAX's ``filter2d`` in NCHW.

    img (B, C, H, W); kernel (B, K, K) or (K, K), K odd. Depthwise
    ``conv2d`` with ``groups = B*C`` on a (1, B*C, H, W) view, one kernel
    row at a time in the image's dtype (TF32 off), the K row sums added in
    fp64: one fp32 sum of USM's 51 x 51 products in PyTorch's order lands
    2e-6 from the exact filter, XLA's 1e-7.
    """
    b, c, h, w = img.shape
    if kernel.ndim == 2:
        kernel = kernel.expand(b, *kernel.shape)
    k = kernel.shape[-1]
    x = F.pad(img, (k // 2,) * 4, mode="reflect").reshape(1, b * c, h + k - 1, w + k - 1)
    weight = kernel.to(img.dtype)[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    out = torch.zeros((1, b * c, h, w), dtype=torch.float64, device=img.device)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for r in range(k):
            out += F.conv2d(x[:, :, r:r + h], weight[:, :, r:r + 1], groups=b * c)
    return out.reshape(b, c, h, w).to(img.dtype)


def _uniform(b, lo, hi, generator, device):
    u = torch.rand((b,), generator=generator, device=device)
    return lo + (hi - lo) * u


def noise_draws(kind: str, shape: Sequence[int], rng_range: Tuple[float, float],
                generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """The draws of one batched noise call, from ``generator``: per sample
    ``sigma`` (Gaussian) or ``scale`` (Poisson) in ``rng_range`` and a
    uniform ``gray`` for the gray branch; ``noise`` (B, C, H, W) normal;
    the Gaussian also ``noise_gray`` (B, 1, H, W)."""
    b, c, h, w = shape
    out = {"sigma" if kind == "gaussian" else "scale":
           _uniform(b, rng_range[0], rng_range[1], generator, device),
           "gray": torch.rand((b,), generator=generator, device=device),
           "noise": torch.randn((b, c, h, w), generator=generator, device=device)}
    if kind == "gaussian":
        out["noise_gray"] = torch.randn((b, 1, h, w), generator=generator, device=device)
    return out


def _apply_clip_round_pt(out, clip, rounds):
    if clip and rounds:
        return torch.clamp((out * 255.0).round(), 0, 255) / 255.0
    if clip:
        return torch.clamp(out, 0, 1)
    if rounds:
        return (out * 255.0).round() / 255.0
    return out


def random_add_gaussian_noise_pt(img: torch.Tensor, sigma_range=(0, 1.0), gray_prob=0.0,
                                 clip=True, rounds=False,
                                 generator: Optional[torch.Generator] = None,
                                 draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Batched Gaussian noise (JAX's ``random_add_gaussian_noise_jax``), NCHW."""
    if draws is None:
        draws = noise_draws("gaussian", img.shape, sigma_range, generator, img.device)
    sigma = draws["sigma"].view(-1, 1, 1, 1)
    gray = (draws["gray"] < gray_prob).to(img.dtype).view(-1, 1, 1, 1)
    noise = draws["noise"] * sigma / 255.0
    noise_gray = draws["noise_gray"] * sigma / 255.0
    noise = noise * (1 - gray) + noise_gray * gray
    return _apply_clip_round_pt(img + noise, clip, rounds)


def random_add_poisson_noise_pt(img: torch.Tensor, scale_range=(0, 1.0), gray_prob=0.0,
                                clip=True, rounds=False,
                                generator: Optional[torch.Generator] = None,
                                draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Batched "Poisson" noise as JAX draws it (``random_add_poisson_noise_jax``):
    a normal with the variance of Poisson noise at ``vals`` = 256 levels, NCHW."""
    if draws is None:
        draws = noise_draws("poisson", img.shape, scale_range, generator, img.device)
    scale = draws["scale"].view(-1, 1, 1, 1)
    gray = (draws["gray"] < gray_prob).to(img.dtype).view(-1, 1, 1, 1)
    base = torch.clamp(img, 0, 1)
    luma = base.mean(dim=1, keepdim=True)
    vals = 2.0 ** 8
    std_color = torch.sqrt(torch.clamp(base, min=1e-8) / vals)
    std_gray = torch.sqrt(torch.clamp(luma, min=1e-8) / vals)
    noise = draws["noise"] * (std_color * (1 - gray) + std_gray * gray)
    return _apply_clip_round_pt(img + noise * scale, clip, rounds)


# ---------------------------------------------------------------------------
# the shared CodeFormer-style per-sample block
# ---------------------------------------------------------------------------

def codeformer_degrade(
    img_gt_bgr: np.ndarray,
    blur_kernel_size: Optional[int] = 41,
    kernel_list: Sequence[str] = ("iso", "aniso"),
    kernel_prob: Sequence[float] = (0.5, 0.5),
    blur_sigma: Tuple[float, float] = (0.1, 8),
    downsample_range: Tuple[float, float] = (1, 16),
    noise_range: Optional[Tuple[float, float]] = (0, 10),
    jpeg_range: Optional[Tuple[float, float]] = (50, 100),
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """blur -> random downsample -> noise -> jpeg -> resize back.

    JAX's ``codeformer_degrade`` (the block the reference clones into each
    Degraded* dataset). Input/output: BGR float32 [0,1] HWC. Without
    ``rng`` it draws from :func:`default_rng` (seeded by ``np.random``).
    """
    rng = rng or default_rng()
    h, w, _ = img_gt_bgr.shape
    if blur_kernel_size is not None:
        kernel = random_mixed_kernels(
            kernel_list, kernel_prob, blur_kernel_size,
            blur_sigma, blur_sigma, (-math.pi, math.pi),
            noise_range=None, rng=rng,
        )
        img_lq = cv2.filter2D(img_gt_bgr, -1, kernel)
    else:
        img_lq = img_gt_bgr
    scale = rng.uniform(downsample_range[0], downsample_range[1])
    img_lq = cv2.resize(
        img_lq, (int(w // scale), int(h // scale)), interpolation=cv2.INTER_LINEAR
    )
    if noise_range is not None:
        img_lq = random_add_gaussian_noise(img_lq, noise_range, rng=rng)
    if jpeg_range is not None:
        img_lq = random_add_jpg_compression(img_lq, jpeg_range, rng=rng)
    img_lq = cv2.resize(img_lq, (w, h), interpolation=cv2.INTER_LINEAR)
    return img_lq.astype(np.float32)
