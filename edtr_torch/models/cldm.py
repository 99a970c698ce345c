"""ControlLDM: the UNet + VAE + ControlNet bundle of the restore path.

Counterpart of ``edtr_tpu/models/cldm.py`` without the CLIP text tower
(the restore path takes its text embedding ``c_txt`` precomputed). Tensors
are NCHW: images in [-1, 1], latents scaled by ``latent_scale_factor``.
``forward(x_noisy, t, cond)`` is the eps prediction: the ControlNet's 13
residuals times ``control_scales``, then the controlled UNet.

``state_dict`` keys are ``unet.*``, ``controlnet.*`` and ``vae.*``, each the
reference state dict of that model.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from edtr_torch.models.controlnet import ControlNet
from edtr_torch.models.unet import UNetModel
from edtr_torch.models.vae import AutoencoderKL

class ControlLDM(nn.Module):
    """``unet_cfg``/``controlnet_cfg``: keyword arguments of
    :class:`UNetModel`/:class:`ControlNet`; ``vae_cfg``: ``ddconfig``,
    ``embed_dim`` and ``train_decoder`` of :class:`AutoencoderKL`."""

    def __init__(self, unet_cfg: Dict[str, Any], vae_cfg: Dict[str, Any],
                 controlnet_cfg: Dict[str, Any], latent_scale_factor: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale_factor = float(latent_scale_factor)
        self.control_scales: List[float] = [1.0] * 13
        self.unet = UNetModel(dtype=dtype, **unet_cfg)
        self.controlnet = ControlNet(dtype=dtype, **controlnet_cfg)
        self.vae = AutoencoderKL(ddconfig=vae_cfg.get("ddconfig", {}),
                                 embed_dim=vae_cfg.get("embed_dim", 4),
                                 train_decoder=vae_cfg.get("train_decoder", False), dtype=dtype)

    def vae_encode(self, image: torch.Tensor) -> torch.Tensor:
        """Scaled posterior mode of ``image`` (NCHW in [-1, 1]), fp32."""
        return self.vae.encode(image).mode() * self.scale_factor

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Decode a scaled latent -> NCHW fp32 in about [-1, 1]."""
        return self.vae.decode(z / self.scale_factor)

    def forward(self, x_noisy: torch.Tensor, t: torch.Tensor,
                cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        control = self.controlnet(x_noisy, cond["c_img"], t, cond["c_txt"])
        control = [c * s for c, s in zip(control, self.control_scales)]
        return self.unet(x_noisy, t, cond["c_txt"], control=control)
