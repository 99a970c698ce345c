"""Spaced DDPM posterior walk, as a K-step Python loop.

Counterpart of ``edtr_tpu/diffusion/sampler.py``: ``make_spaced_schedule``
re-spaces the full process onto the used timesteps in float64 numpy and
freezes the posterior tables as fp32 tensors; :func:`sample_loop` takes the
place of ``sample_scan``'s ``lax.scan``: the timesteps walk in reverse
(e.g. 200, 150, 100, 50) and the step at index 0 adds no noise. The step
noise is a tensor argument (one slice per step, in walk order) or is drawn
from a ``torch.Generator``. Classifier-free guidance makes a second
forward only when ``uncond`` is given and ``cfg_scale`` is not 1, as JAX's
static branch does. :class:`SpacedSampler` is JAX's class surface: the
schedule cache, ``sample`` from pure noise and
``manual_sample_with_timesteps``. Latents are NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from edtr_torch.device import resolve_device
from edtr_torch.diffusion.schedule import extract, space_timesteps

ModelFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


@dataclass(frozen=True)
class SpacedSchedule:
    timesteps: np.ndarray  # ascending int, (num_steps,)
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def predict_xstart_from_eps(self, x_t, index, eps):
        nd = x_t.ndim
        return (extract(self.sqrt_recip_alphas_cumprod, index, nd) * x_t
                - extract(self.sqrt_recipm1_alphas_cumprod, index, nd) * eps)

    def q_posterior_mean_variance(self, x_start, x_t, index):
        """(mean, variance, log variance) of q(x_{t-1} | x_t, x_0)."""
        nd = x_t.ndim
        mean = (extract(self.posterior_mean_coef1, index, nd) * x_start
                + extract(self.posterior_mean_coef2, index, nd) * x_t)
        return (mean, extract(self.posterior_variance, index, nd),
                extract(self.posterior_log_variance_clipped, index, nd))


def make_spaced_schedule(original_betas: np.ndarray, num_steps: int,
                         used_timesteps: Optional[Sequence[int]] = None,
                         device: torch.device | str = "cpu") -> SpacedSchedule:
    """Posterior tables restricted to ``used_timesteps`` (float64 math),
    JAX's signature: without ``used_timesteps``, the ``num_steps`` steps
    :func:`space_timesteps` spreads over the process; asserts that
    ``num_steps`` steps are used. The tables lie on ``device``."""
    original_ac = np.cumprod(1.0 - np.asarray(original_betas, np.float64))
    if used_timesteps is None:
        used_timesteps = space_timesteps(len(original_betas), str(num_steps))
    used = set(int(t) for t in used_timesteps)
    betas = []
    last = 1.0
    for i, ac in enumerate(original_ac):
        if i in used:
            betas.append(1 - ac / last)
            last = ac
    assert len(betas) == num_steps, (len(betas), num_steps)
    betas = np.array(betas, dtype=np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    variance = betas * (1.0 - ac_prev) / (1.0 - ac)
    log_variance = (np.array([-10.0]) if num_steps == 1
                    else np.log(np.append(variance[1], variance[1:])))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return SpacedSchedule(
        timesteps=np.array(sorted(used), dtype=np.int64),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
        posterior_variance=f32(variance),
        posterior_log_variance_clipped=f32(log_variance),
        posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
    )


def p_sample(model_fn: ModelFn, schedule: SpacedSchedule, x: torch.Tensor,
             t: torch.Tensor, index: torch.Tensor, cond: Dict[str, torch.Tensor],
             noise: torch.Tensor, uncond: Optional[Dict[str, torch.Tensor]] = None,
             cfg_scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One posterior step -> ``(x_prev, pred_x0)``; with ``uncond`` and a
    ``cfg_scale`` other than 1, eps is ``eps_u + cfg_scale * (eps_c -
    eps_u)``."""
    if uncond is None or cfg_scale == 1.0:
        eps = model_fn(x, t, cond)
    else:
        eps_c = model_fn(x, t, cond)
        eps_u = model_fn(x, t, uncond)
        eps = eps_u + cfg_scale * (eps_c - eps_u)
    pred_x0 = schedule.predict_xstart_from_eps(x, index, eps)
    mean, variance, _ = schedule.q_posterior_mean_variance(pred_x0, x, index)
    nonzero = (index != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return mean + nonzero * torch.sqrt(variance) * noise, pred_x0


def sample_loop(model_fn: ModelFn, schedule: SpacedSchedule, x_T: torch.Tensor,
                cond: Dict[str, torch.Tensor], step_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                uncond: Optional[Dict[str, torch.Tensor]] = None, cfg_scale: float = 1.0,
                return_intermediates: bool = False):
    """Walk the spaced timesteps in reverse. ``step_noise``: (K,) + x_T.shape,
    slice k for the k-th step taken; else drawn from ``generator``. With
    ``return_intermediates``, returns ``(x_0, pred_x0s)``, the second each
    step's pred_x0 stacked in walk order, (K,) + x_T.shape (``sample_scan``'s
    scan outputs)."""
    n = schedule.num_steps
    batch = x_T.shape[0]
    x = x_T
    inter = []
    for k, (t_val, idx) in enumerate(zip(schedule.timesteps[::-1], range(n - 1, -1, -1))):
        t = torch.full((batch,), int(t_val), dtype=torch.long, device=x.device)
        index = torch.full((batch,), idx, dtype=torch.long, device=x.device)
        if step_noise is not None:
            noise = step_noise[k]
        else:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
        x, pred_x0 = p_sample(model_fn, schedule, x, t, index, cond, noise, uncond, cfg_scale)
        if return_intermediates:
            inter.append(pred_x0)
    return (x, torch.stack(inter)) if return_intermediates else x


class SpacedSampler:
    """JAX's ``SpacedSampler``: the full process's betas (float64, host),
    schedules made on ``device`` (the card unless named) and cached by
    ``(num_steps, sorted used_timesteps or None)``, and the two walks of the
    reference class."""

    def __init__(self, betas: np.ndarray, device: Optional[torch.device | str] = None):
        self.original_betas = np.asarray(betas, dtype=np.float64)
        self.num_timesteps = len(betas)
        self.device = resolve_device(device)
        self._cache: Dict[Tuple, SpacedSchedule] = {}

    def make_schedule(self, num_steps: int,
                      used_timesteps: Optional[Sequence[int]] = None) -> SpacedSchedule:
        key = (num_steps, tuple(sorted(used_timesteps)) if used_timesteps else None)
        if key not in self._cache:
            self._cache[key] = make_spaced_schedule(self.original_betas, num_steps,
                                                    used_timesteps, self.device)
        return self._cache[key]

    def sample(self, model_fn: ModelFn, steps: int, x_size: Sequence[int],
               cond: Dict[str, torch.Tensor], batch_size: int = 1,
               x_T: Optional[torch.Tensor] = None, uncond=None, cfg_scale: float = 1.0,
               return_intermediates: bool = False, step_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """The ``steps``-step walk from pure noise: ``x_T`` (batch_size,) +
        ``x_size`` (C, h, w), fp32, drawn from ``generator`` when not
        given, then :func:`sample_loop`."""
        schedule = self.make_schedule(steps)
        if x_T is None:
            x_T = torch.randn((batch_size,) + tuple(x_size), generator=generator,
                              device=self.device, dtype=torch.float32)
        return sample_loop(model_fn, schedule, x_T, cond, step_noise, generator, uncond,
                           cfg_scale, return_intermediates)

    def manual_sample_with_timesteps(self, model_fn: ModelFn, x_T: torch.Tensor, steps: int,
                                     used_timesteps: Sequence[int],
                                     cond: Dict[str, torch.Tensor], uncond=None,
                                     cfg_scale: float = 1.0, return_intermediates: bool = False,
                                     step_noise: Optional[torch.Tensor] = None,
                                     generator: Optional[torch.Generator] = None):
        """The walk over ``used_timesteps`` from a given (partly noised)
        ``x_T``."""
        schedule = self.make_schedule(steps, used_timesteps)
        return sample_loop(model_fn, schedule, x_T, cond, step_noise, generator, uncond,
                           cfg_scale, return_intermediates)
