"""ControlLDM: the UNet + VAE + CLIP + ControlNet bundle of the restore path.

Counterpart of ``edtr_tpu/models/cldm.py``. Tensors are NCHW: images in
[-1, 1], latents scaled by ``latent_scale_factor``. ``forward(x_noisy, t,
cond)`` is the eps prediction: the ControlNet's 13 residuals times
``control_scales``, then the controlled UNet. ``encode_text(prompts)`` is
the CLIP text tower on the tokenized prompts (``models/clip.py``), built
from ``clip_cfg`` as JAX builds it; ``prepare_condition`` makes the
``cond`` dict of a pre-restored image.

``state_dict`` keys are ``unet.*``, ``controlnet.*``, ``vae.*`` and
``clip.*``, each the reference state dict of that model (``clip.*``: the
OpenCLIP text keys, ``cond_stage_model.model.*`` in an SD2.1 checkpoint).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from edtr_torch.models.clip import CLIPTextEncoder
from edtr_torch.models.controlnet import ControlNet
from edtr_torch.models.unet import UNetModel
from edtr_torch.models.vae import AutoencoderKL
from edtr_torch.utils.tiling import tiled_vae_decode, tiled_vae_encode

def clip_from_cfg(clip_cfg: Dict[str, Any],
                  dtype: Optional[torch.dtype] = None) -> CLIPTextEncoder:
    """The text tower of a reference ``clip_cfg`` (``layer`` and
    ``text_cfg``), with JAX's defaults: OpenCLIP ViT-H, penultimate."""
    text = dict(clip_cfg.get("text_cfg", {}))
    return CLIPTextEncoder(vocab_size=text.get("vocab_size", 49408),
                           width=text.get("width", 1024), heads=text.get("heads", 16),
                           layers=text.get("layers", 24),
                           context_length=text.get("context_length", 77),
                           penultimate=clip_cfg.get("layer", "penultimate") == "penultimate",
                           dtype=dtype)


class ControlLDM(nn.Module):
    """``unet_cfg``/``controlnet_cfg``: keyword arguments of
    :class:`UNetModel`/:class:`ControlNet`; ``vae_cfg``: ``ddconfig``,
    ``embed_dim`` and ``train_decoder`` of :class:`AutoencoderKL`;
    ``clip_cfg``: ``layer`` and ``text_cfg`` (:func:`clip_from_cfg`)."""

    def __init__(self, unet_cfg: Dict[str, Any], vae_cfg: Dict[str, Any],
                 controlnet_cfg: Dict[str, Any], latent_scale_factor: float,
                 dtype: Optional[torch.dtype] = None, *, clip_cfg: Dict[str, Any]):
        super().__init__()
        self.scale_factor = float(latent_scale_factor)
        self.control_scales: List[float] = [1.0] * 13
        self.unet = UNetModel(dtype=dtype, **unet_cfg)
        self.controlnet = ControlNet(dtype=dtype, **controlnet_cfg)
        self.vae = AutoencoderKL(ddconfig=vae_cfg.get("ddconfig", {}),
                                 embed_dim=vae_cfg.get("embed_dim", 4),
                                 train_decoder=vae_cfg.get("train_decoder", False), dtype=dtype)
        self.clip = clip_from_cfg(clip_cfg, dtype)

    def vae_encode(self, image: torch.Tensor, sample: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   tiled: bool = False, tile_size: int = -1) -> torch.Tensor:
        """Scaled latent of ``image`` (NCHW in [-1, 1]), fp32: the
        posterior's mode, or with ``sample`` its sample ``mean + std *
        noise`` (``noise`` NCHW like the latent, drawn from ``generator``
        when not given). JAX's ``vae_encode`` samples by default; the port
        keeps the mode by default, which every restore reads, and the
        DiffBIR recipe asks for the sample. ``tiled``: the posterior from
        GroupNorm-synced tiles of ``tile_size`` pixels
        (``utils/tiling.py:tiled_vae_encode``; 512 when <= 0)."""
        if tiled:
            posterior = tiled_vae_encode(self.vae, image, tile_size)
        else:
            posterior = self.vae.encode(image)
        if not sample:
            return posterior.mode() * self.scale_factor
        if noise is None:
            noise = torch.randn(posterior.mean.shape, generator=generator,
                                device=posterior.mean.device)
        return posterior.sample(noise) * self.scale_factor

    def vae_decode(self, z: torch.Tensor, tiled: bool = False,
                   tile_size: int = -1) -> torch.Tensor:
        """Decode a scaled latent -> NCHW fp32 in about [-1, 1]; ``tiled``:
        from GroupNorm-synced latent tiles of ``tile_size``
        (``utils/tiling.py:tiled_vae_decode``; 64 when <= 0)."""
        if tiled:
            return tiled_vae_decode(self.vae, z / self.scale_factor, tile_size)
        return self.vae.decode(z / self.scale_factor)

    def encode_text(self, prompt: Sequence[str]) -> torch.Tensor:
        """(len(prompt), 77, width) fp32 embedding of the prompts."""
        return self.clip.encode(prompt)

    def prepare_condition(self, clean: torch.Tensor, prompt: Optional[Sequence[str]] = None
                          ) -> Dict[str, torch.Tensor]:
        """``cond`` of a pre-restored NCHW image in [0, 1]: the prompts'
        text embedding (the empty prompt for each image when None) and the
        scaled posterior mode of the image."""
        if prompt is None:
            prompt = [""] * clean.shape[0]
        return dict(c_txt=self.encode_text(prompt), c_img=self.vae_encode(clean * 2 - 1))

    def forward(self, x_noisy: torch.Tensor, t: torch.Tensor,
                cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        control = self.controlnet(x_noisy, cond["c_img"], t, cond["c_txt"])
        control = [c * s for c, s in zip(control, self.control_scales)]
        return self.unet(x_noisy, t, cond["c_txt"], control=control)
