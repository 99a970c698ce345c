"""Real-ESRGAN two-stage batch degradation of the port, on the card.

Counterpart of ``edtr_tpu/data/realesrgan.py`` (the reference's
``RealESRGANBatchTransform``): USM sharpen -> blur(kernel1) -> random
resize -> Gaussian or Poisson noise -> DiffJPEG -> [p] blur(kernel2) ->
stage-2 scale and resize -> noise -> {JPEG + sinc} in random order ->
resize back -> clamp and round, and the ``_dequeue_and_enqueue`` shuffle
pool.

* Batches are NHWC at the call, as JAX's; the stages run NCHW on the
  transform's device (the card unless ``device`` names another).
* Resizes are ``jax.image.resize``'s, not ``F.interpolate``'s: the
  weight matrices of ``jax/_src/image/scale.py:compute_weight_mat``
  (triangle for ``area`` and ``bilinear``, Keys cubic a = -0.5 for
  ``bicubic``, the kernel widened by ``max(1/scale, 1)`` to antialias,
  columns normalised, samples outside the input zeroed), built on the
  device, cached per (in, out, method, device) and applied as two fp32
  products; a dimension whose size does not change is skipped. Sizes are
  quantised to multiples of ``SIZE_QUANT`` as JAX's are.
* Host branching draws from a numpy ``Generator`` and a Python ``Random``
  seeded with ``seed``, in JAX's order, so one seed gives JAX's branches,
  sizes and qualities. They are all drawn before the first device op and
  reach the card in one copy with the three kernel stacks (the images in
  another; both from pinned memory, so neither stalls the host). Device noise
  comes from :meth:`noise_draws` (a ``torch.Generator`` on the device,
  seeded with ``seed``); a caller may replace it to hand in draws.
* The shuffle pool is kept as device tensors; its permutation comes from
  the numpy Generator. The transform copies nothing back to the host and,
  once its tables are on the card, never waits for it.
"""

from __future__ import annotations

import random as pyrandom
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from edtr_torch.data.degradation import (
    filter2d,
    noise_draws,
    random_add_gaussian_noise_pt,
    random_add_poisson_noise_pt,
)
from edtr_torch.data.diffjpeg import diff_jpeg
from edtr_torch.device import resolve_device

SIZE_QUANT = 16


def _quantize_size(v: float) -> int:
    return max(SIZE_QUANT, int(round(v / SIZE_QUANT)) * SIZE_QUANT)


_RESIZE: Dict[Tuple[int, int, str, torch.device], torch.Tensor] = {}


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, method: str,
                   device: torch.device) -> torch.Tensor:
    """(out_size, in_size) fp32 resampling matrix of ``jax.image.resize``
    (antialiased; ``method`` "linear" or "cubic"), made on ``device`` and
    cached there."""
    key = (in_size, out_size, method, torch.device(device))
    if key not in _RESIZE:
        kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
        inv_scale = 1.0 / (out_size / in_size)
        kernel_scale = max(inv_scale, 1.0)
        sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
            * inv_scale - 0.5
        src = torch.arange(in_size, dtype=torch.float32, device=device)
        weights = kernel((sample_f[None, :] - src[:, None]).abs() / kernel_scale)
        total = weights.sum(dim=0, keepdim=True)
        weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                              weights / torch.where(total != 0, total, torch.ones_like(total)),
                              torch.zeros_like(weights))
        inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
        _RESIZE[key] = torch.where(inside[None, :], weights,
                                   torch.zeros_like(weights)).t().contiguous()
    return _RESIZE[key]


def resize(img: torch.Tensor, h: int, w: int, mode: str) -> torch.Tensor:
    """JAX's ``_resize`` on an NCHW batch: ``area`` and ``bilinear`` are
    antialiased linear, ``bicubic`` Keys cubic."""
    method = {"area": "linear", "bilinear": "linear", "bicubic": "cubic"}[mode]
    if img.shape[-2] != h:
        img = torch.matmul(resize_weights(img.shape[-2], h, method, img.device), img)
    if img.shape[-1] != w:
        img = torch.matmul(img, resize_weights(img.shape[-1], w, method, img.device).t())
    return img


class USMSharp:
    """Unsharp masking with a 51 x 51 Gaussian (``cv2.getGaussianKernel``)."""

    def __init__(self, radius: int = 50, sigma: float = 0):
        import cv2

        if radius % 2 == 0:
            radius += 1
        k = cv2.getGaussianKernel(radius, sigma)
        self.kernel = (k @ k.T).astype(np.float32)
        self._on: Dict[torch.device, torch.Tensor] = {}

    def kernel_on(self, device: torch.device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = torch.from_numpy(self.kernel).to(device)
        return self._on[device]

    def __call__(self, img: torch.Tensor, weight: float = 0.5, threshold: int = 10
                 ) -> torch.Tensor:
        """img (B, C, H, W) in [0, 1]."""
        k = self.kernel_on(img.device)
        blur = filter2d(img, k)
        residual = img - blur
        mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
        soft_mask = filter2d(mask, k)
        sharp = torch.clamp(img + weight * residual, 0, 1)
        return soft_mask * sharp + (1 - soft_mask) * img


class RealESRGANBatchTransform:
    def __init__(
        self,
        hq_key: str = "hq",
        extra_keys: Sequence[str] = (),
        use_sharpener: bool = True,
        queue_size: int = 256,
        resize_prob: Sequence[float] = (0.2, 0.7, 0.1),
        resize_range: Sequence[float] = (0.15, 1.5),
        gray_noise_prob: float = 0.4,
        gaussian_noise_prob: float = 0.5,
        noise_range: Sequence[float] = (1, 30),
        poisson_scale_range: Sequence[float] = (0.05, 3),
        jpeg_range: Sequence[float] = (30, 95),
        second_blur_prob: float = 0.8,
        stage2_scale: Union[float, Sequence[float]] = 4,
        resize_prob2: Sequence[float] = (0.3, 0.4, 0.3),
        resize_range2: Sequence[float] = (0.3, 1.2),
        gray_noise_prob2: float = 0.4,
        gaussian_noise_prob2: float = 0.5,
        noise_range2: Sequence[float] = (1, 25),
        poisson_scale_range2: Sequence[float] = (0.05, 2.5),
        jpeg_range2: Sequence[float] = (30, 95),
        resize_back: bool = True,
        seed: int = 0,
        device: Optional[Union[torch.device, str]] = None,
    ):
        self.hq_key = hq_key
        self.extra_keys = list(extra_keys)
        self.resize_prob = list(resize_prob)
        self.resize_range = tuple(resize_range)
        self.gray_noise_prob = gray_noise_prob
        self.gaussian_noise_prob = gaussian_noise_prob
        self.noise_range = tuple(noise_range)
        self.poisson_scale_range = tuple(poisson_scale_range)
        self.jpeg_range = tuple(jpeg_range)
        self.second_blur_prob = second_blur_prob
        self.stage2_scale = stage2_scale
        self.resize_prob2 = list(resize_prob2)
        self.resize_range2 = tuple(resize_range2)
        self.gray_noise_prob2 = gray_noise_prob2
        self.gaussian_noise_prob2 = gaussian_noise_prob2
        self.noise_range2 = tuple(noise_range2)
        self.poisson_scale_range2 = tuple(poisson_scale_range2)
        self.jpeg_range2 = tuple(jpeg_range2)
        self.resize_back = resize_back
        self.use_sharpener = use_sharpener
        self.usm = USMSharp() if use_sharpener else None
        self.queue_size = queue_size
        self.queue: Dict[str, Any] = {}
        self.queue_ptr = 0
        self.device = resolve_device(device)
        self._np = np.random.default_rng(seed)
        self._py = pyrandom.Random(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def noise_draws(self, kind: str, shape: Sequence[int], rng_range: Tuple[float, float]
                    ) -> Dict[str, torch.Tensor]:
        """The draws of one noise call (``kind`` "gaussian" or "poisson",
        NCHW ``shape``) from :attr:`generator`."""
        return noise_draws(kind, shape, rng_range, self.generator, self.device)

    def _rand_resize_params(self, probs, rng_range):
        updown = self._py.choices(["up", "down", "keep"], probs)[0]
        if updown == "up":
            scale = self._np.uniform(1, rng_range[1])
        elif updown == "down":
            scale = self._np.uniform(rng_range[0], 1)
        else:
            scale = 1.0
        mode = self._py.choice(["area", "bilinear", "bicubic"])
        return scale, mode

    def _plan(self, b: int) -> Dict[str, Any]:
        """Every host draw of one call, in the order JAX's transform makes them."""
        p: Dict[str, Any] = {}
        p["scale1"], p["mode1"] = self._rand_resize_params(self.resize_prob, self.resize_range)
        p["gauss1"] = self._np.uniform() < self.gaussian_noise_prob
        p["q1"] = self._np.uniform(*self.jpeg_range, size=(b,)).astype(np.float32)
        p["blur2"] = self._np.uniform() < self.second_blur_prob
        if isinstance(self.stage2_scale, (list, tuple)):
            p["stage2_scale"] = self._np.uniform(*self.stage2_scale)
        else:
            p["stage2_scale"] = float(self.stage2_scale)
        p["scale2"], p["mode2"] = self._rand_resize_params(self.resize_prob2, self.resize_range2)
        p["gauss2"] = self._np.uniform() < self.gaussian_noise_prob2
        p["q2"] = self._np.uniform(*self.jpeg_range2, size=(b,)).astype(np.float32)
        p["mode3"] = self._py.choice(["area", "bilinear", "bicubic"])
        p["jpeg_last"] = not self._np.uniform() < 0.5
        p["perm"] = (self._np.permutation(self.queue_size)
                     if self.queue_size > 0 and self.queue and self.queue_ptr == self.queue_size
                     else None)
        return p

    def _copy_in(self, x) -> torch.Tensor:
        """``x`` as fp32 on the device; from the host through pinned memory,
        so the copy does not stall the host."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        t = t.to(torch.float32)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_device(self, batch: Dict[str, Any], plan: Dict[str, Any]):
        """The kernel stacks, qualities and permutation in one host buffer and
        one copy; the images in another unless they are on the device."""
        hq = self._copy_in(batch[self.hq_key])
        parts = [np.asarray(batch[k], np.float32) for k in ("kernel1", "kernel2", "sinc_kernel")]
        parts += [plan["q1"], plan["q2"]]
        if plan["perm"] is not None:
            parts.append(plan["perm"].astype(np.float32))
        flat = self._copy_in(np.concatenate([p.ravel() for p in parts]))
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.size].view(p.shape))
            at += p.size
        perm = out[5].long() if plan["perm"] is not None else None
        return hq, out[0], out[1], out[2], out[3], out[4], perm

    def _noise(self, out, gaussian: bool, noise_range, poisson_range, gray_prob):
        if gaussian:
            draws = self.noise_draws("gaussian", out.shape, noise_range)
            return random_add_gaussian_noise_pt(out, noise_range, gray_prob, draws=draws)
        draws = self.noise_draws("poisson", out.shape, poisson_range)
        return random_add_poisson_noise_pt(out, poisson_range, gray_prob, draws=draws)

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """``batch``: ``hq`` (B, H, W, 3) in [0, 1] and the (B, 21, 21)
        ``kernel1``, ``kernel2``, ``sinc_kernel``; -> ``{"GT", "LQ"}``
        (B, H, W, 3) on the device, and the ``extra_keys``."""
        b = len(batch[self.hq_key])
        plan = self._plan(b)
        hq, kernel1, kernel2, sinc_kernel, q1, q2, perm = self._to_device(batch, plan)
        hq = hq.permute(0, 3, 1, 2)
        if self.use_sharpener:
            hq = self.usm(hq)
        ori_h, ori_w = hq.shape[-2:]

        # ---- stage 1 ----------------------------------------------------------
        out = filter2d(hq, kernel1)
        scale = plan["scale1"]
        out = resize(out, _quantize_size(ori_h * scale), _quantize_size(ori_w * scale),
                     plan["mode1"])
        out = self._noise(out, plan["gauss1"], self.noise_range, self.poisson_scale_range,
                          self.gray_noise_prob)
        out = diff_jpeg(torch.clamp(out, 0, 1), q1)

        # ---- stage 2 ----------------------------------------------------------
        if plan["blur2"]:
            out = filter2d(out, kernel2)
        stage2_scale = plan["stage2_scale"]
        stage2_h = _quantize_size(ori_h / stage2_scale)
        stage2_w = _quantize_size(ori_w / stage2_scale)
        scale = plan["scale2"]
        out = resize(out, _quantize_size(stage2_h * scale), _quantize_size(stage2_w * scale),
                     plan["mode2"])
        out = self._noise(out, plan["gauss2"], self.noise_range2, self.poisson_scale_range2,
                          self.gray_noise_prob2)
        if not plan["jpeg_last"]:
            out = resize(out, stage2_h, stage2_w, plan["mode3"])
            out = filter2d(out, sinc_kernel)
            out = diff_jpeg(torch.clamp(out, 0, 1), q2)
        else:
            out = diff_jpeg(torch.clamp(out, 0, 1), q2)
            out = resize(out, stage2_h, stage2_w, plan["mode3"])
            out = filter2d(out, sinc_kernel)
        if stage2_scale != 1 and self.resize_back:
            out = resize(out, ori_h, ori_w, "bicubic")
        lq = torch.clamp(torch.round(out * 255.0), 0, 255) / 255.0

        result = {"GT": hq.permute(0, 2, 3, 1), "LQ": lq.permute(0, 2, 3, 1)}
        for k in self.extra_keys:
            result[k] = batch[k]
        if self.queue_size > 0:
            result = self._dequeue_and_enqueue(result, perm, plan["perm"])
        return result

    def _dequeue_and_enqueue(self, values: Dict[str, Any], perm: Optional[torch.Tensor],
                             perm_host: Optional[np.ndarray]) -> Dict[str, Any]:
        """JAX's shuffle pool on the device: filled batch by batch, then each
        call returns the first ``b`` of the permuted pool and puts the new
        batch in their place (the numpy Generator's permutation, ``perm`` on
        the device and ``perm_host``)."""
        if not self.queue:
            for k, v in values.items():
                if isinstance(v, torch.Tensor):
                    self.queue[k] = torch.zeros((self.queue_size,) + tuple(v.shape[1:]),
                                                dtype=torch.float32, device=v.device)
                else:
                    self.queue[k] = [None] * self.queue_size
            self.queue_ptr = 0

        b = len(values[self.hq_key]) if self.hq_key in values else len(values["GT"])
        if self.queue_size % b != 0:
            raise ValueError(f"queue size {self.queue_size} must divide by batch {b}")

        results: Dict[str, Any] = {}
        if self.queue_ptr == self.queue_size:
            for k, qv in self.queue.items():
                v = values[k]
                if isinstance(qv, torch.Tensor):
                    q_shuf = qv[perm]
                    results[k] = q_shuf[:b].clone()
                    q_shuf[:b] = v
                    self.queue[k] = q_shuf
                else:
                    q_shuf = [qv[i] for i in perm_host]
                    results[k] = q_shuf[:b]
                    for i in range(b):
                        q_shuf[i] = v[i]
                    self.queue[k] = q_shuf
        else:
            for k, qv in self.queue.items():
                v = values[k]
                if isinstance(qv, torch.Tensor):
                    qv[self.queue_ptr: self.queue_ptr + b] = v
                else:
                    for i in range(b):
                        qv[self.queue_ptr + i] = v[i]
            results = dict(values)
            self.queue_ptr += b
        return results
