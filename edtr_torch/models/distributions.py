"""Diagonal Gaussian posterior of the KL-VAE.

Counterpart of ``edtr_tpu/models/distributions.py``. Channels are axis 1
(NCHW). :meth:`sample` takes its noise as a tensor (JAX's takes a key);
``std`` and ``var`` are computed when read, so the restore, which reads
only :meth:`mode`, launches nothing for them. ``kl`` and ``nll`` sum over
every axis but the batch's, as JAX's do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class DiagonalGaussianDistribution:
    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = torch.chunk(parameters, 2, dim=1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.deterministic = deterministic

    @property
    def std(self) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(self.logvar)

    def _axes(self) -> tuple:
        return tuple(range(1, self.mean.ndim))

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """``mean + std * noise``; ``noise`` is standard normal, NCHW like
        the mean."""
        return self.mean + self.std * noise.to(self.mean.dtype)

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None) -> torch.Tensor:
        """KL to the standard normal, or to ``other``, per sample."""
        if self.deterministic:
            return torch.zeros(1, device=self.mean.device)
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar,
                                   dim=self._axes())
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=self._axes())

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """Negative log-likelihood of ``sample``, per sample."""
        if self.deterministic:
            return torch.zeros(1, device=self.mean.device)
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=self._axes())

    def mode(self) -> torch.Tensor:
        return self.mean
