"""EDTR restore pipeline of the port: the flagship inference path.

Counterpart of ``edtr_tpu/pipeline.py`` (``EDTRPipeline.restore``) and of
``__graft_entry__._flagship_pipeline``:

    pre_res  = swinir(lq)                              # pre-restoration
    z_pre    = vae_encode(pre_res*2-1)                 # posterior mode, scaled
    c_txt    = clip("") unless the caller gives it     # empty-prompt embedding
    z_T      = q_sample(z_pre, t=start_timestep, noise)
    z_0      = K spaced posterior steps, each ControlNet + UNet
    restored = wavelet_reconstruction((vae_decode(z_0)+1)/2, pre_res)

``restore`` keeps the JAX layout: NHWC images in [0, 1], NHWC latents and
noise. The stage methods (``pre_restore``, ``encode``, ``text``,
``denoise``, ``decode``) are NCHW, and each takes the real-world demo's
tiling (``utils/tiling.py``): SwinIR on Gaussian-blended tiles, the VAE on
GroupNorm-synced tiles, the walk on latent tiles (``restore``'s
``tiled_diffusion``). The pipeline runs on CUDA unless it is built with
``device="cpu"``; with no card and no explicit device it raises.

The pipeline (and :func:`build_flagship`) takes ``fused_conv``, the conv
configuration it runs its stages in (``models.layers.fused_conv``): True
runs every ResBlock half (GroupNorm affine + SiLU + conv3x3 +
bias/emb/residual) and every nearest-2x + conv3x3 (UNet, VAE, SwinIR tail)
through the port's conv kernels (``edtr_torch/ops/gn_conv.py``), the JAX
package's configuration ``EDTR_GNCONV_FUSED=force EDTR_UPSCONV_FUSED=force
EDTR_UPS_SUBPIX=0``; False runs them as stock PyTorch ops, as JAX's default
leaves them to XLA. It also takes ``fused_proj``, the projection
configuration (``models.layers.fused_proj``): True runs the transformer
blocks' LN+q/k/v, LN+query, LN+GEGLU and GroupNorm-affine+``proj_in`` at
256 tokens and more through the port's projection kernels
(``edtr_torch/ops/{ln_matmul,geglu}.py``), JAX's ``EDTR_GEGLU_FUSED=force
EDTR_LNMM_FUSED=force``; False runs them as stock PyTorch ops, as JAX's
default does. And it takes ``fused_swin``, the Swin configuration
(``models.layers.fused_swin``): True runs every SwinIR transformer block as
the port's three Swin kernels in rolled token space
(``edtr_torch/ops/{swin_block,window_attention}.py``), JAX's SwinIR with
``swin_block._FORCE_KERNEL`` and ``EDTR_WINDOW_ATTN=pallas``; False runs
the module path. The modules are the same in every configuration, so all
load the same state dicts. ``EDTRPipeline.configuration()`` enters all
three around any other call, as the training step does around its forward
and its backward.

``EDTRPipeline.sampler`` is the ``SpacedSampler`` of the pipeline's
diffusion (JAX's ``pipe.sampler``); ``schedule`` is its cached schedule of
the EDTR timesteps. :func:`swinir_from_config` builds a config's SwinIR
alone (the SwinIR recipes).

``build_flagship(train=True)`` is the model of
``__graft_entry__._flagship_pipeline(train=True)``: UNet and ControlNet
ResBlocks and transformers, and the VAE decoder's ResnetBlocks, recompute
their activations in the backward (``use_checkpoint``). The training step
is ``edtr_torch.train.edtr_step``.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from edtr_torch.device import resolve_device
from edtr_torch.diffusion.sampler import SpacedSampler, sample_loop
from edtr_torch.diffusion.schedule import Diffusion
from edtr_torch.config import NotPortedError
from edtr_torch.models.cldm import ControlLDM
from edtr_torch.models.controlnet import ControlNet
from edtr_torch.models.layers import fused_conv as conv_config
from edtr_torch.models.layers import fused_proj as proj_config
from edtr_torch.models.layers import fused_swin as swin_config
from edtr_torch.models.swinir import SwinIR
from edtr_torch.models.unet import UNetModel
from edtr_torch.utils.image import wavelet_reconstruction
from edtr_torch.utils.tiling import make_tiled_fn, tiled_model_fn

# the conv configuration chip_smoke.py measured faster end to end on the
# card (interleaved restores: a clear majority of pairs and a win beyond
# the ~5% drift; PERF.md); chip_smoke.py reports whether its run agrees
FUSED_CONV_DEFAULT = True
# the projection configuration, by the same rule on the fused-conv vs
# fused-conv+proj pairs (chip_smoke.py, PERF.md)
FUSED_PROJ_DEFAULT = False
# the Swin configuration, by the same rule on the SwinIR stage's pairs of
# fused vs fused+swin, the only stage it changes (chip_smoke.py, PERF.md)
FUSED_SWIN_DEFAULT = True


def edtr_used_timesteps(start_timestep: int, num_timesteps: int) -> List[int]:
    """K evenly spaced steps ending at ``start_timestep`` ([50..200] for s4)."""
    return [int(start_timestep / num_timesteps * i) for i in range(1, num_timesteps + 1)]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _in_config(stage):
    """Runs a pipeline stage in the pipeline's conv, projection and Swin
    configurations."""
    @functools.wraps(stage)
    def run(self, *args, **kwargs):
        with self.configuration():
            return stage(self, *args, **kwargs)
    return run


class EDTRPipeline(nn.Module):
    """SwinIR (or None: no pre-restoration) + ControlLDM + diffusion
    tables, on one device, run in the conv configuration ``fused_conv``,
    the projection configuration ``fused_proj`` and the Swin configuration
    ``fused_swin`` (module docstring)."""

    def __init__(self, swinir: Optional[SwinIR], cldm: ControlLDM, diffusion: Diffusion,
                 start_timestep: int = 200, num_timesteps: int = 4,
                 device: Optional[torch.device | str] = None,
                 fused_conv: bool = FUSED_CONV_DEFAULT,
                 fused_proj: bool = FUSED_PROJ_DEFAULT,
                 fused_swin: bool = FUSED_SWIN_DEFAULT):
        super().__init__()
        self.device = resolve_device(device)
        self.fused_conv = bool(fused_conv)
        self.fused_proj = bool(fused_proj)
        self.fused_swin = bool(fused_swin)
        self.swinir = None if swinir is None else swinir.to(self.device)
        self.cldm = cldm.to(self.device)
        self.diffusion = diffusion
        self.start_timestep = int(start_timestep)
        self.num_timesteps = int(num_timesteps)
        self.used_timesteps = edtr_used_timesteps(start_timestep, num_timesteps)
        self.sampler = SpacedSampler(diffusion.betas, self.device)
        self.schedule = self.sampler.make_schedule(self.num_timesteps, self.used_timesteps)

    @contextlib.contextmanager
    def configuration(self) -> Iterator[None]:
        """Every call inside the block runs in the pipeline's conv,
        projection and Swin configurations (module docstring)."""
        with (conv_config(self.fused_conv), proj_config(self.fused_proj),
              swin_config(self.fused_swin)):
            yield

    @torch.no_grad()
    @_in_config
    def pre_restore(self, lq: torch.Tensor,
                    tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """SwinIR's pre-restoration, the identity for a pipeline without
        one (a config that disables it); ``tile``: (size, stride) pixels of
        Gaussian-blended SwinIR tiles."""
        if self.swinir is None:
            return lq
        return self.swinir(lq) if tile is None else make_tiled_fn(self.swinir, *tile)(lq)

    @torch.no_grad()
    @_in_config
    def encode(self, pre_res: torch.Tensor, tiled: bool = False,
               tile_size: int = -1) -> torch.Tensor:
        """The scaled posterior mode; ``tiled``: from GroupNorm-synced tiles
        of ``tile_size`` pixels."""
        return self.cldm.vae_encode(pre_res * 2 - 1, tiled=tiled, tile_size=tile_size)

    @torch.no_grad()
    @_in_config
    def text(self, batch: int) -> torch.Tensor:
        """The empty prompt's embedding for each of ``batch`` images, (batch,
        77, context_dim) fp32 (JAX's ``cldm.encode_text([""] * B)``)."""
        return self.cldm.encode_text([""] * batch)

    @torch.no_grad()
    @_in_config
    def denoise(self, z_pre: torch.Tensor, c_txt: torch.Tensor, noise: torch.Tensor,
                step_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """q_sample to ``start_timestep``, then the spaced walk; ``tile``:
        (size, stride) of latent tiles for each eps forward
        (:func:`~edtr_torch.utils.tiling.tiled_model_fn`)."""
        t = torch.full((z_pre.shape[0],), self.start_timestep, dtype=torch.long,
                       device=z_pre.device)
        z_t = self.diffusion.q_sample(z_pre, t, noise)
        cond = dict(c_txt=c_txt, c_img=z_pre)
        model_fn = self.cldm if tile is None else tiled_model_fn(self.cldm, *tile)
        return sample_loop(model_fn, self.schedule, z_t, cond, step_noise, generator)

    @torch.no_grad()
    @_in_config
    def decode(self, z: torch.Tensor, pre_res: torch.Tensor, tiled: bool = False,
               tile_size: int = -1) -> torch.Tensor:
        """Decode, then the wavelet fix; ``tiled``: from GroupNorm-synced
        latent tiles of ``tile_size``."""
        decoded = self.cldm.vae_decode(z, tiled=tiled, tile_size=tile_size)
        return wavelet_reconstruction((decoded + 1) / 2, pre_res)

    @torch.no_grad()
    def restore(self, lq: torch.Tensor, c_txt: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                step_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, tiled_diffusion: bool = False,
                tile_size: int = -1, tile_stride: int = -1) -> Dict[str, torch.Tensor]:
        """Restore an NHWC [0, 1] batch.

        ``c_txt``: (B, 77, context_dim) text embedding; None computes the
        empty prompt's (:meth:`text`), as JAX's ``restore`` does. ``noise``: the
        q_sample draw, NHWC latent shape; ``step_noise``: (K,) + that shape,
        one per posterior step in walk order. Draws missing noise from
        ``generator``. ``tiled_diffusion``: every eps forward on latent
        tiles of ``tile_size`` at ``tile_stride`` (latent pixels); a size
        or stride <= 0 raises ``ValueError`` (JAX's defaults, -1, give no
        tile there and a NaN image). Returns NHWC ``restored``,
        ``pre_restored`` and ``z``.
        """
        tile = (tile_size, tile_stride) if tiled_diffusion else None
        dev = self.device
        pre = self.pre_restore(_nchw(lq.to(dev, torch.float32)))
        z_pre = self.encode(pre)
        c_txt = self.text(lq.shape[0]) if c_txt is None else c_txt.to(dev, torch.float32)
        if noise is None:
            noise = torch.randn(z_pre.shape, generator=generator, device=dev,
                                dtype=z_pre.dtype)
        else:
            noise = _nchw(noise.to(dev, z_pre.dtype))
        if step_noise is not None:
            step_noise = step_noise.to(dev, z_pre.dtype).permute(0, 1, 4, 2, 3)
        z = self.denoise(z_pre, c_txt, noise, step_noise, generator, tile)
        restored = self.decode(z, pre)
        return dict(restored=_nhwc(restored), pre_restored=_nhwc(pre), z=_nhwc(z))


def flagship_configs(tiny: bool = False, train: bool = False) -> Dict[str, Any]:
    """Model configs of ``__graft_entry__._flagship_pipeline``: SD2.1 /
    EDTR-s4 dims, or the toy dims of its ``tiny=True``, the text tower's
    ``clip`` among them. SwinIR unpadded.
    At full width, as there, the VAE decoder is trainable and ``train``
    turns on ``use_checkpoint`` (UNet, ControlNet, VAE decoder); the toy
    dims set neither."""
    if tiny:
        unet = dict(in_channels=4, out_channels=4, model_channels=32,
                    attention_resolutions=(1,), num_res_blocks=1, channel_mult=(1, 2),
                    num_head_channels=16, transformer_depth=1, context_dim=64,
                    use_linear_in_transformer=True)
        vae = dict(embed_dim=4, ddconfig=dict(double_z=True, z_channels=4, in_channels=3,
                                              out_ch=3, ch=32, ch_mult=[1, 2, 2, 2],
                                              num_res_blocks=1))
        swinir = dict(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4,
                      mlp_ratio=2, sf=8)
    else:
        unet = dict(in_channels=4, out_channels=4, model_channels=320,
                    attention_resolutions=(4, 2, 1), num_res_blocks=2,
                    channel_mult=(1, 2, 4, 4), num_head_channels=64,
                    transformer_depth=1, context_dim=1024,
                    use_linear_in_transformer=True, use_checkpoint=train)
        vae = dict(embed_dim=4, train_decoder=True,
                   ddconfig=dict(double_z=True, z_channels=4, in_channels=3, out_ch=3,
                                 ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2,
                                 use_checkpoint=train))
        swinir = dict(embed_dim=180, depths=(6,) * 8, num_heads=(6,) * 8,
                      window_size=8, mlp_ratio=2, sf=8)
    # __graft_entry__'s clip_cfg: OpenCLIP ViT-H's text tower, or the toy one
    text = (dict(context_length=77, vocab_size=512, width=64, heads=4, layers=2) if tiny
            else dict(context_length=77, vocab_size=49408, width=1024, heads=16, layers=24))
    clip = dict(layer="penultimate", text_cfg=text)
    controlnet = {k: v for k, v in unet.items() if k != "out_channels"}
    controlnet["hint_channels"] = 4
    return dict(unet=unet, controlnet=controlnet, vae=vae, swinir=swinir, clip=clip)


def build_flagship(tiny: bool = False, dtype: Optional[torch.dtype] = torch.bfloat16,
                   device: Optional[torch.device | str] = None,
                   fused_conv: bool = FUSED_CONV_DEFAULT,
                   fused_proj: bool = FUSED_PROJ_DEFAULT,
                   fused_swin: bool = FUSED_SWIN_DEFAULT, train: bool = False) -> EDTRPipeline:
    """The EDTR-s4 restore pipeline (start t=200, 4 steps), weights as
    initialised by the constructors: load a state dict or randomise them.
    ``fused_conv``, ``fused_proj``, ``fused_swin``: the configurations
    (module docstring); ``train``: the training model
    (:func:`flagship_configs`)."""
    device = resolve_device(device)
    cfg = flagship_configs(tiny, train)
    with torch.device(device):
        swinir = SwinIR(dtype=dtype, **cfg["swinir"])
        cldm = ControlLDM(cfg["unet"], cfg["vae"], cfg["controlnet"],
                          latent_scale_factor=0.18215, dtype=dtype, clip_cfg=cfg["clip"])
    diffusion = Diffusion.create(1000, linear_start=0.00085, linear_end=0.0120,
                                 device=device)
    return EDTRPipeline(swinir, cldm, diffusion, start_timestep=200, num_timesteps=4,
                        device=device, fused_conv=fused_conv, fused_proj=fused_proj,
                        fused_swin=fused_swin)


# the SwinIR variant the port builds (``models/swinir.py``); a config
# asking for another raises
_SWINIR_FIXED = dict(in_chans=3, img_range=1.0, upsampler="nearest+conv",
                     resi_connection="1conv", unshuffle=True)
_SWINIR_ARGS = ("embed_dim", "depths", "num_heads", "window_size", "mlp_ratio", "sf")


def _swinir_from_config(params: Dict[str, Any], dtype: Optional[torch.dtype]) -> SwinIR:
    for key, want in _SWINIR_FIXED.items():
        if params.get(key, want) != want:
            raise NotPortedError(f"SwinIR {key}={params[key]!r}: the port builds {key}={want!r}")
    if params.get("unshuffle_scale", params.get("sf")) != params.get("sf"):
        raise NotPortedError("SwinIR: the port unshuffles by sf")
    return SwinIR(dtype=dtype, **{k: tuple(params[k]) if isinstance(params[k], list)
                                  else params[k] for k in _SWINIR_ARGS if k in params})


def swinir_from_config(node, dtype: Optional[torch.dtype] = None,
                       device: Optional[torch.device | str] = None) -> SwinIR:
    """The SwinIR of a config's ``model.swinir`` node (the recipes' configs:
    pre-training, SR4IR, the frozen pre-restore), weights as the
    constructor initialises them, on ``device`` (the card unless named)."""
    from edtr_torch.config import Config

    params = node["params"]
    params = dict(params.to_dict() if isinstance(params, Config) else params)
    with torch.device(resolve_device(device)):
        return _swinir_from_config(params, dtype)


def _args_of(cls, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The entries of ``cfg`` that ``cls.__init__`` takes (JAX's ``_filter``
    of the UNet and ControlNet configs: ``image_size``, ``legacy`` and
    ``use_spatial_transformer`` are the reference's, inert here)."""
    names = inspect.signature(cls.__init__).parameters
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()
            if k in names and v is not None}


def build_pipeline_from_config(cfg, dtype: Optional[torch.dtype] = None,
                               device: Optional[torch.device | str] = None,
                               fused_conv: bool = FUSED_CONV_DEFAULT,
                               fused_proj: bool = FUSED_PROJ_DEFAULT,
                               fused_swin: bool = FUSED_SWIN_DEFAULT) -> EDTRPipeline:
    """JAX's ``build_pipeline_from_config``: the pipeline a reference-style
    config (:func:`edtr_torch.config.load_config`) describes, weights as
    the constructors initialise them, on ``device`` (the card unless the
    caller names another; ``"meta"`` builds the shapes alone). SwinIR only
    when ``model.pre_restoration`` (default true) and a ``swinir`` node
    say so, else the identity pre-restore; unpadded (JAX pads its lanes, a
    TPU choice). A config with ``train`` whose VAE trains its decoder
    recomputes the decoder's activations in the backward
    (``use_checkpoint``, unless the ddconfig sets it); the UNet and
    ControlNet take ``use_checkpoint`` from the config. ``start_timestep``
    and ``num_timesteps`` come from ``train`` or else ``test`` (200 and 4
    by default). ``dtype=None`` builds fp32, which the card runs on the
    plain versions."""
    from edtr_torch.config import Config, instantiate_from_config

    def plain(node):
        return dict(node.to_dict() if isinstance(node, Config) else node or {})

    device = resolve_device(device)
    model = cfg["model"] if "model" in cfg else cfg
    cp = model["cldm"]["params"]
    vae = plain(cp["vae_cfg"])
    if "train" in cfg and vae.get("train_decoder", False):
        vae["ddconfig"] = {"use_checkpoint": True, **plain(vae.get("ddconfig"))}
    with torch.device(device):
        swinir = (_swinir_from_config(plain(model["swinir"]["params"]), dtype)
                  if model.get("pre_restoration", True) and "swinir" in model else None)
        cldm = ControlLDM(_args_of(UNetModel, plain(cp["unet_cfg"])), vae,
                          _args_of(ControlNet, plain(cp["controlnet_cfg"])),
                          latent_scale_factor=cp["latent_scale_factor"], dtype=dtype,
                          clip_cfg=plain(cp["clip_cfg"]))
    diffusion = instantiate_from_config(model["diffusion"], device=device)
    steps = plain(cfg.get("train", None) or cfg.get("test", None))
    return EDTRPipeline(swinir, cldm, diffusion, steps.get("start_timestep", 200),
                        steps.get("num_timesteps", 4), device=device, fused_conv=fused_conv,
                        fused_proj=fused_proj, fused_swin=fused_swin)
