"""Gaussian diffusion tables: the forward process and the training
objectives.

Counterpart of ``edtr_tpu/diffusion/schedule.py``: the beta schedule
(linear, cosine, sqrt_linear or sqrt) is computed once in float64 numpy
and frozen into fp32 tensors on the target device; :func:`space_timesteps`
respaces the process (IDDPM's rule, as JAX's); ``q_sample``, ``get_v`` and ``predict_xstart_from_eps``
gather one coefficient per sample. ``p_losses`` (the eps/x0/v objective)
and ``reverse`` (EDTR's one-step noising and denoising) take their noise as
a tensor, or draw it from a ``torch.Generator``: JAX's keys give other
numbers, so parity tests hand both sides the same noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Set, Union

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """The betas of ``schedule`` in float64, as JAX's (every EDTR config
    uses ``linear``)."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], a_min=0, a_max=0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """IDDPM's timestep respacing, as JAX's: ``"ddimN"`` (the integer stride
    that takes exactly N steps), or section counts (a comma-separated
    string or a sequence), each taking its count of evenly spaced steps
    from its equal share of the process."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {num_timesteps} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-sample coefficient ``table[t]`` broadcast to an ``ndim`` tensor."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


@dataclass(frozen=True)
class Diffusion:
    """Frozen fp32 coefficient tables of the full 1000-step process."""

    betas: np.ndarray  # float64, host side (the sampler re-spaces it)
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    parameterization: str = "eps"
    loss_type: str = "l2"

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               loss_type: str = "l2", linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, parameterization: str = "eps",
               device: torch.device | str = "cpu") -> "Diffusion":
        """JAX's ``Diffusion.create`` (its arguments in its order), the
        tables on ``device``."""
        if parameterization not in ("eps", "x0", "v"):
            raise ValueError(f"parameterization must be eps, x0 or v, got {parameterization!r}")
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start, linear_end, cosine_s)
        ac = np.cumprod(1.0 - betas, axis=0)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return cls(
            betas=betas,
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
            parameterization=parameterization,
            loss_type=loss_type,
        )

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        nd = x_start.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def predict_xstart_from_eps(self, x_t: torch.Tensor, t: torch.Tensor,
                                eps: torch.Tensor) -> torch.Tensor:
        nd = x_t.ndim
        return (extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps)

    def get_v(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        nd = x.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * noise
                - extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * x)

    def get_loss(self, pred: torch.Tensor, target: torch.Tensor,
                 mean: bool = True) -> torch.Tensor:
        if self.loss_type == "l1":
            loss = (target - pred).abs()
        elif self.loss_type == "l2":
            loss = (target - pred) ** 2
        else:
            raise NotImplementedError(f"unknown loss type '{self.loss_type}'")
        return loss.mean() if mean else loss

    def p_losses(self, model_fn: ModelFn, x_start: torch.Tensor, t: torch.Tensor,
                 cond: Dict[str, torch.Tensor], noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 return_predicted_x_start: bool = False):
        """The eps/x0/v objective (``model/gaussian_diffusion.py:113-133``);
        ``noise`` drawn from ``generator`` when not given."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x_noisy = self.q_sample(x_start, t, noise)
        model_output = model_fn(x_noisy, t, cond)
        if self.parameterization == "x0":
            target = x_start
        elif self.parameterization == "eps":
            target = noise
        else:
            target = self.get_v(x_start, noise, t)
        loss_simple = self.get_loss(model_output, target, mean=False).mean()
        if return_predicted_x_start:
            return loss_simple, self.predict_xstart_from_eps(x_noisy, t, model_output)
        return loss_simple

    def reverse(self, model_fn: ModelFn, t: torch.Tensor, x0: torch.Tensor,
                cond: Dict[str, torch.Tensor], noise: Optional[torch.Tensor] = None,
                x_noisy: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """EDTR's one-step noising and denoising of the HLF loss
        (``model/gaussian_diffusion.py:153-169``): q_sample to ``t``, one eps
        prediction, the closed-form x0. ``noise`` drawn from ``generator``
        when neither it nor ``x_noisy`` is given."""
        if self.parameterization != "eps":
            raise ValueError("reverse needs the eps parameterization")
        if x_noisy is None:
            if noise is None:
                noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                                    dtype=x0.dtype)
            x_noisy = self.q_sample(x0, t, noise)
        model_output = model_fn(x_noisy, t, cond)
        return dict(x_noisy=x_noisy,
                    x_pred=self.predict_xstart_from_eps(x_noisy, t, model_output),
                    model_output=model_output)


def create_diffusion(device: torch.device | str = "cpu", **kwargs) -> Diffusion:
    """The configs' factory (``target: model.gaussian_diffusion.Diffusion``):
    :meth:`Diffusion.create` with the config's ``params``."""
    return Diffusion.create(device=device, **kwargs)
