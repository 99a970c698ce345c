"""Spatial tiling: Gaussian-blended tiles, latent-tiled diffusion and the
GroupNorm-synced tiled VAE (NCHW).

Counterpart of ``edtr_tpu/utils/tiling.py``:

* :func:`gaussian_weights` and :func:`sliding_windows`: the blend mask
  (the reference's quirk kept: ``midpoint_x = (W - 1) / 2`` but
  ``midpoint_y = H / 2``) and the window coordinates;
* :func:`make_tiled_fn`: ``fn`` on Gaussian-blended tiles, oversized tiles
  shrunk to the input, accumulated in fp32, ``out / count``; the tile's
  coordinates passed as keyword arguments when ``fn`` takes other
  arguments;
* :func:`tiled_model_fn`: the eps function on latent tiles, each tile with
  its slice of ``c_img``;
* :func:`tiled_vae_encode` / :func:`tiled_vae_decode`: the VAE on tiles
  with global GroupNorm statistics (:func:`_gn_synced_tiles`): pass 1 runs
  the tiles at stride ``size`` and records every GroupNorm's per-tile
  ``(count, sum, sumsq)`` (:func:`gn_sync`), :func:`_aggregate_gn_stats`
  pools them into moments, pass 2 runs the tiles at stride ``3 * size //
  4`` with those moments injected and blends them.

A tile size or stride <= 0 raises ``ValueError`` in :func:`make_tiled_fn`
and :func:`tiled_model_fn` (JAX's ``sliding_windows`` gives no window
there and its tiled restore divides 0 by 0); the tiled VAE maps it to
JAX's defaults, 512 pixels to encode and 64 latent pixels to decode.
The functions take and return NCHW tensors, as the modules they wrap.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from edtr_torch.models.distributions import DiagonalGaussianDistribution
from edtr_torch.models.layers import GroupNorm32

Moments = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@functools.lru_cache(maxsize=32)
def gaussian_weights(tile_width: int, tile_height: int) -> np.ndarray:
    """(H, W) fp32 Gaussian contribution mask of a tile."""
    var = 0.01
    midpoint_x = (tile_width - 1) / 2
    x_probs = [math.exp(-(x - midpoint_x) ** 2 / (tile_width ** 2) / (2 * var))
               / math.sqrt(2 * math.pi * var) for x in range(tile_width)]
    midpoint_y = tile_height / 2
    y_probs = [math.exp(-(y - midpoint_y) ** 2 / (tile_height ** 2) / (2 * var))
               / math.sqrt(2 * math.pi * var) for y in range(tile_height)]
    return np.outer(y_probs, x_probs).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _weights_on(size: int, device: torch.device, gaussian: bool) -> torch.Tensor:
    # one copy per tile size and device: made once, not on every call
    w = gaussian_weights(size, size) if gaussian else np.ones((size, size), np.float32)
    return torch.from_numpy(w).to(device)


def sliding_windows(h: int, w: int, tile_size: int, tile_stride: int
                    ) -> List[Tuple[int, int, int, int]]:
    """``(hi, hi_end, wi, wi_end)`` of each tile, rows outer, the last row
    and column of tiles flush with the edge."""
    hi_list = list(range(0, h - tile_size + 1, tile_stride))
    if (h - tile_size) % tile_stride != 0:
        hi_list.append(h - tile_size)
    wi_list = list(range(0, w - tile_size + 1, tile_stride))
    if (w - tile_size) % tile_stride != 0:
        wi_list.append(w - tile_size)
    return [(hi, hi + tile_size, wi, wi + tile_size) for hi in hi_list for wi in wi_list]


def _positive(size: int, stride: int, what: str) -> None:
    if size <= 0 or stride <= 0:
        raise ValueError(f"{what}: tile size {size} and stride {stride} must be positive")


def _fit(size: int, stride: int, h: int, w: int) -> Tuple[int, int]:
    """A tile larger than the input shrunk to it, its stride to at most 3/4
    of it (the reference's VAEHook rule)."""
    if size > min(h, w):
        size = min(h, w)
        stride = max(min(stride, size * 3 // 4), 1)
    return size, stride


def tile_plan(h: int, w: int, size: int, stride: int) -> List[Tuple[int, int, int, int]]:
    """The windows :func:`make_tiled_fn` visits on an (h, w) input."""
    _positive(size, stride, "tile_plan")
    return sliding_windows(h, w, *_fit(size, stride, h, w))


def _blend(run: Callable[[torch.Tensor, Tuple[int, int, int, int]], torch.Tensor],
           x: torch.Tensor, windows, size: int, num: int, den: int, out_c: int,
           gaussian: bool = True) -> torch.Tensor:
    """``run(tile, window)`` on each window's tile of ``x``, each output
    (spatially ``num / den`` of its tile) weighted, summed in fp32 and
    divided by the summed weights."""
    b, _, h, w = x.shape
    sc = lambda v: v * num // den  # noqa: E731
    out = torch.zeros((b, out_c, sc(h), sc(w)), dtype=torch.float32, device=x.device)
    count = torch.zeros((1, 1, sc(h), sc(w)), dtype=torch.float32, device=x.device)
    ws = sc(size)
    weights = _weights_on(ws, x.device, gaussian)
    for win in windows:
        hi, _, wi, _ = win
        y = run(x[:, :, hi:hi + size, wi:wi + size], win).float() * weights
        oh, ow = sc(hi), sc(wi)
        out[:, :, oh:oh + ws, ow:ow + ws] += y
        count[:, :, oh:oh + ws, ow:ow + ws] += weights
    return out / count


def make_tiled_fn(fn: Callable[..., torch.Tensor], size: int, stride: int, scale: int = 1,
                  channel: Optional[int] = None, weight: str = "gaussian"
                  ) -> Callable[..., torch.Tensor]:
    """``fn`` on Gaussian-blended tiles of an NCHW input: ``fn(x_tile,
    *args, hi=, hi_end=, wi=, wi_end=, **kwargs)`` (the coordinates only
    when other arguments are given), its output ``scale`` times the tile's
    size with ``channel`` channels (the input's by default); the result is
    fp32. ``weight``: "gaussian" or a plain average."""
    _positive(size, stride, "make_tiled_fn")

    def tiled_fn(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        h, w = x.shape[-2:]
        t_size, t_stride = _fit(size, stride, h, w)

        def run(tile, win):
            if args or kwargs:
                kwargs.update(zip(("hi", "hi_end", "wi", "wi_end"), win))
            return fn(tile, *args, **kwargs)

        return _blend(run, x, sliding_windows(h, w, t_size, t_stride), t_size, scale, 1,
                      channel or x.shape[1], weight == "gaussian")

    return tiled_fn


def tiled_model_fn(model_fn: Callable, tile_size: int, tile_stride: int) -> Callable:
    """The eps function ``model_fn(x, t, cond)`` on latent tiles: each tile
    runs with its slice of ``cond["c_img"]`` and the whole ``c_txt``."""
    _positive(tile_size, tile_stride, "tiled_model_fn")

    def fn(x: torch.Tensor, t: torch.Tensor, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        def tile_call(x_tile, t, cond, hi, hi_end, wi, wi_end):
            c_img = cond["c_img"][:, :, hi:hi_end, wi:wi_end]
            return model_fn(x_tile, t, {"c_txt": cond["c_txt"], "c_img": c_img})

        return make_tiled_fn(tile_call, tile_size, tile_stride)(x, t, cond)

    return fn


# -- the tiled VAE with GroupNorm statistics synced across tiles ---------------

@contextlib.contextmanager
def gn_sync(module: torch.nn.Module, moments: Optional[Moments] = None,
            record: bool = False) -> Iterator[Dict[str, tuple]]:
    """Inside the block every :class:`GroupNorm32` of ``module`` normalises
    with ``moments[name]`` (its module name) when given, and with
    ``record`` keeps its last call's ``(count, sum, sumsq)``; the dict the
    block yields holds those, by name, after the block."""
    norms = {n: m for n, m in module.named_modules() if isinstance(m, GroupNorm32)}
    recorded: Dict[str, tuple] = {}
    for name, m in norms.items():
        m.record, m.recorded = record, None
        m.moments = None if moments is None else moments[name]
    try:
        yield recorded
    finally:
        for name, m in norms.items():
            if m.recorded is not None:
                recorded[name] = m.recorded
            m.record, m.recorded, m.moments = False, None, None


def _aggregate_gn_stats(tile_stats: List[Dict[str, tuple]]) -> Moments:
    """Per GroupNorm, the tiles' ``(count, sum, sumsq)`` summed into
    ``(mean, var)``, ``var = E[x^2] - mean^2`` clamped at 0."""
    out = {}
    for name in tile_stats[0]:
        count = sum(s[name][0] for s in tile_stats)
        total = sum(s[name][1] for s in tile_stats)
        total_sq = sum(s[name][2] for s in tile_stats)
        mean = total / count
        out[name] = (mean, (total_sq / count - mean * mean).clamp(min=0.0))
    return out


def _gn_synced_tiles(module: torch.nn.Module, apply: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor, tile_size: int, stride: int, num: int, den: int,
                     out_channels: int, gn_sync_iters: int = 1) -> torch.Tensor:
    """``apply`` (which runs ``module``) on GroupNorm-synced tiles of an
    NCHW input, its output ``num / den`` of the tile's size: pass 1 (run
    ``gn_sync_iters`` times) on the tiles at stride ``tile_size``, the
    moments of the last iteration injected into the next; pass 2 on the
    tiles at ``stride``, blended. Oversized tiles shrink as in
    :func:`make_tiled_fn`."""
    h, w = x.shape[-2:]
    tile_size, stride = _fit(tile_size, stride, h, w)
    moments = None
    for _ in range(max(gn_sync_iters, 0)):
        stats = []
        for hi, _, wi, _ in sliding_windows(h, w, tile_size, tile_size):
            with gn_sync(module, moments, record=True) as rec:
                apply(x[:, :, hi:hi + tile_size, wi:wi + tile_size])
            stats.append(rec)
        moments = _aggregate_gn_stats(stats)

    def run(tile, win):
        with gn_sync(module, moments):
            return apply(tile)

    return _blend(run, x, sliding_windows(h, w, tile_size, stride), tile_size, num, den,
                  out_channels)


def tiled_vae_encode(vae: torch.nn.Module, image: torch.Tensor, tile_size: int,
                     gn_sync_iters: int = 1) -> DiagonalGaussianDistribution:
    """The posterior of an NCHW image in [-1, 1] from GroupNorm-synced
    tiles of ``tile_size`` pixels (512 when <= 0), the VAE encoder and its
    ``quant_conv``."""
    if tile_size <= 0:
        tile_size = 512
    moments = _gn_synced_tiles(vae.encoder, lambda t: vae.quant_conv(vae.encoder(t)), image,
                               tile_size, tile_size * 3 // 4, 1, 8,
                               vae.quant_conv.weight.shape[0], gn_sync_iters)
    return DiagonalGaussianDistribution(moments)


def tiled_vae_decode(vae: torch.nn.Module, z: torch.Tensor, tile_size: int,
                     gn_sync_iters: int = 1) -> torch.Tensor:
    """The decoded NCHW fp32 image of an unscaled latent from
    GroupNorm-synced latent tiles of ``tile_size`` (64 when <= 0)."""
    if tile_size <= 0:
        tile_size = 64
    return _gn_synced_tiles(vae.decoder, vae.decode, z, tile_size, tile_size * 3 // 4, 8, 1,
                            vae.decoder.conv_out.weight.shape[0], gn_sync_iters)
