"""The port's tiling (``edtr_torch.utils.tiling``, the tiled VAE's
GroupNorm sync in ``models/layers.py``, the tiled restore) against
``edtr_tpu.utils.tiling`` on the CPU, on the same numpy inputs:

* ``gaussian_weights`` at 1e-7 (odd and even sizes, H != W, the reference's
  asymmetric midpoints); ``sliding_windows`` exactly at the demo's shapes
  and the edge cases;
* ``make_tiled_fn`` with the auto-shrink of oversized tiles, ``scale`` and
  ``channel``, and the tile coordinates passed to ``fn``, at 1e-6;
  ``tiled_model_fn``'s ``c_img`` slicing at 1e-6;
* the GroupNorm-synced ``tiled_vae_encode`` / ``tiled_vae_decode`` on the
  tiny flagship's VAE (one numpy-drawn tree on both sides) at 3e-3 of the
  largest value, also without the sync pass; the recorded statistics come
  from the raw tiles while moments are injected;
* the tiled defaults: JAX's ``restore(tiled_diffusion=True)`` passes -1 to
  ``tiled_model_fn``, which visits no tile and returns NaN; the port
  raises ``ValueError`` there, and maps a VAE tile <= 0 to JAX's 512 / 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.utils import tiling as JT
from edtr_torch.models.layers import GroupNorm32
from edtr_torch.utils import tiling as TT
from torch_port_helpers import IMAGE, jax_tiny, nchw, nhwc, port_tiny, t2n

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes need one thread; the suite runs several test processes on
    a few cores, and torch's own pool in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("w,h", [(64, 64), (63, 63), (96, 64), (33, 48), (1, 7)])
def test_gaussian_weights(w, h):
    got = TT.gaussian_weights(w, h)
    want = JT.gaussian_weights(w, h)
    assert got.shape == want.shape == (h, w) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    if h % 2 == 0 and h > 1:  # midpoint_y = H / 2: row H/2 peaks, unlike the columns
        assert got[h // 2].max() == got.max()


@pytest.mark.parametrize("h,w,size,stride", [
    (768, 1024, 512, 256),   # SwinIR tiles, the detector's tiles
    (96, 128, 64, 32),       # latent tiles
    (768, 1024, 256, 256),   # the encoder's pass 1
    (768, 1024, 256, 192),   # and pass 2
    (96, 128, 96, 96),       # the decoder's shrunk tiles
    (96, 128, 96, 72),
    (64, 64, 64, 32),        # one tile
    (70, 64, 64, 64),        # the last row flush with the edge
    (64, 64, 80, 16),        # a tile larger than the input
    (100, 37, 10, 7),
])
def test_sliding_windows_exact(h, w, size, stride):
    assert TT.sliding_windows(h, w, size, stride) == JT.sliding_windows(h, w, size, stride)


def _tile_fns(rng, cin, cout, scale):
    """The same position-dependent nonlinear tile function on both sides:
    tanh of a channel mix plus the tile's slice of a bias map, repeated
    ``scale`` times along each axis."""
    mix = rng.standard_normal((cin, cout)).astype(np.float32)
    bias = rng.standard_normal((1, 200, 200, cout)).astype(np.float32)

    def fn_j(x, b, hi, hi_end, wi, wi_end):
        y = jnp.tanh(x @ mix) + b[:, hi:hi_end, wi:wi_end]
        return jnp.repeat(jnp.repeat(y, scale, 1), scale, 2)

    def fn_t(x, b, hi, hi_end, wi, wi_end):
        y = torch.tanh(torch.einsum("bchw,cd->bdhw", x, torch.from_numpy(mix)))
        y = y + b[:, :, hi:hi_end, wi:wi_end]
        return y.repeat_interleave(scale, 2).repeat_interleave(scale, 3)

    return fn_j, fn_t, bias


@pytest.mark.parametrize("hw,size,stride,scale,cout", [
    ((40, 56), 16, 12, 1, 5),    # overlapping tiles, channel changes
    ((40, 56), 16, 12, 2, 3),    # scale 2
    ((24, 40), 32, 16, 1, 3),    # oversized: shrunk to 24, stride min(16, 18)
    ((20, 20), 64, 64, 2, 4),    # shrunk to the input, stride 15
])
def test_make_tiled_fn(hw, size, stride, scale, cout):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    fn_j, fn_t, bias = _tile_fns(rng, 3, cout, scale)
    want = JT.make_tiled_fn(fn_j, size, stride, scale=scale, channel=cout)(jnp.asarray(x), bias)
    got = TT.make_tiled_fn(fn_t, size, stride, scale=scale, channel=cout)(nchw(x), nchw(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_make_tiled_fn_plain_average_and_no_coordinates():
    """``weight`` other than gaussian averages; with no other argument the
    function gets no coordinates."""
    x = np.random.default_rng(32).standard_normal((1, 30, 30, 2)).astype(np.float32)
    want = JT.make_tiled_fn(lambda t: t * t, 12, 9, weight="mean")(jnp.asarray(x))
    got = TT.make_tiled_fn(lambda t: t * t, 12, 9, weight="mean")(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(nhwc(got), x * x, rtol=TOL, atol=TOL)


def test_tiled_model_fn_slices_c_img():
    """Each latent tile's eps call sees its own slice of ``c_img`` and the
    whole ``c_txt``."""
    rng = np.random.default_rng(33)
    x = rng.standard_normal((1, 12, 20, 4)).astype(np.float32)
    c_img = rng.standard_normal((1, 12, 20, 4)).astype(np.float32)
    c_txt = rng.standard_normal((1, 5, 6)).astype(np.float32)
    t = np.array([7], np.int32)

    def model_j(x, t, cond):
        return jnp.sin(x * t[:, None, None, None] * 0.1) * cond["c_img"] + cond["c_txt"].sum()

    def model_t(x, t, cond):
        return torch.sin(x * t[:, None, None, None] * 0.1) * cond["c_img"] + cond["c_txt"].sum()

    want = JT.tiled_model_fn(model_j, 8, 6)(jnp.asarray(x), jnp.asarray(t),
                                            dict(c_img=jnp.asarray(c_img), c_txt=c_txt))
    got = TT.tiled_model_fn(model_t, 8, 6)(nchw(x), torch.from_numpy(t),
                                           dict(c_img=nchw(c_img), c_txt=torch.from_numpy(c_txt)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)


# -- the tiled VAE ---------------------------------------------------------------

def _vae_pair():
    pipe, params = jax_tiny()
    return pipe.cldm, params, port_tiny().cldm.vae


@pytest.mark.parametrize("iters", [1, 0], ids=["gn_synced", "per_tile"])
def test_tiled_vae_encode_matches_jax(iters):
    cldm, params, vae = _vae_pair()
    img = np.random.default_rng(34).uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
    # 48-pixel tiles: 2 x 2 at stride 48, then 2 x 3 at 36 (overlapping)
    want = JT.tiled_vae_encode(cldm, params, jnp.asarray(img), 48, gn_sync_iters=iters)
    with torch.no_grad():
        got = TT.tiled_vae_encode(vae, nchw(img), 48, gn_sync_iters=iters)
    for name in ("mean", "logvar"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(nhwc(getattr(got, name)), w, rtol=3e-3,
                                   atol=3e-3 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("iters", [1, 0], ids=["gn_synced", "per_tile"])
def test_tiled_vae_decode_matches_jax(iters):
    cldm, params, vae = _vae_pair()
    z = np.random.default_rng(35).standard_normal((1, 8, 12, 4)).astype(np.float32)
    # 6-latent tiles: 2 x 2 at stride 6, then 2 x 3 at 4 (overlapping)
    want = np.asarray(JT.tiled_vae_decode(cldm, params, jnp.asarray(z), 6, gn_sync_iters=iters))
    with torch.no_grad():
        got = TT.tiled_vae_decode(vae, nchw(z), 6, gn_sync_iters=iters)
    assert tuple(got.shape) == (1, 3, 64, 96)
    np.testing.assert_allclose(nhwc(got), want, rtol=3e-3, atol=3e-3 * np.abs(want).max())


def test_gn_sync_records_raw_tiles_while_injecting():
    """Recorded (count, sum, sumsq) are the tile's own, also with moments
    injected (JAX sows the raw tile's statistics), the last call's when a
    norm runs twice; injected moments normalise in place of the tile's;
    outside the block the norm is plain again."""
    torch.manual_seed(0)
    norm = GroupNorm32(8, num_groups=2)
    box = torch.nn.ModuleDict(dict(n=norm))
    x, x2 = torch.randn(1, 8, 3, 5) * 3 + 1, torch.randn(1, 8, 3, 5)
    mean = torch.tensor([[0.5, -1.0]])
    var = torch.tensor([[4.0, 0.25]])
    with TT.gn_sync(box, {"n": (mean, var)}, record=True) as rec:
        y = norm(x)
        norm(x2)
    count, total, total_sq = rec["n"]
    xg = x2.reshape(1, 2, -1).double()
    assert count == 4 * 15
    np.testing.assert_allclose(total.numpy(), xg.sum(-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(total_sq.numpy(), xg.square().sum(-1).numpy(), rtol=1e-5)
    want = (x.reshape(1, 2, -1) - mean[..., None]) / torch.sqrt(var[..., None] + norm.eps)
    np.testing.assert_allclose(t2n(y), want.reshape(x.shape).numpy(), rtol=1e-5, atol=1e-5)
    assert norm.moments is None and not norm.record and norm.recorded is None
    stats = TT._aggregate_gn_stats([rec, rec])
    np.testing.assert_allclose(stats["n"][0].numpy(), xg.mean(-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(stats["n"][1].numpy(), xg.var(-1, unbiased=False).numpy(),
                               rtol=1e-4)


# -- the tiled defaults -------------------------------------------------------------

def test_tiled_defaults_nan_in_jax_raise_in_the_port():
    """JAX's ``restore(tiled_diffusion=True)`` hands its defaults (-1, -1)
    to ``tiled_model_fn``: no window, 0 / 0. The port raises instead."""
    cldm, params, _ = _vae_pair()
    z = jnp.asarray(np.random.default_rng(36).standard_normal((1, 8, 8, 4)), jnp.float32)
    cond = dict(c_img=z, c_txt=jnp.zeros((1, 77, 64)))
    assert JT.sliding_windows(8, 8, -1, -1) == []
    eps = JT.tiled_model_fn(cldm.model_fn(params), -1, -1)(z, jnp.array([200]), cond)
    assert np.isnan(np.asarray(eps)).all()

    with pytest.raises(ValueError, match="positive"):
        TT.tiled_model_fn(lambda x, t, c: x, -1, -1)
    for size, stride in ((0, 8), (8, 0), (-1, -1)):
        with pytest.raises(ValueError, match="positive"):
            TT.make_tiled_fn(lambda x: x, size, stride)
    port = port_tiny()
    lq = torch.rand(1, IMAGE, IMAGE, 3)
    with pytest.raises(ValueError, match="positive"):
        port.restore(lq, torch.zeros(1, 77, 64), tiled_diffusion=True)


def test_tiled_vae_maps_nonpositive_tiles_to_jax_defaults():
    """A tile <= 0 is 512 pixels to encode and 64 latent pixels to decode;
    on square inputs smaller than that, one tile shrunk to the input: the
    untiled VAE, its statistics pooled as E[x^2] - mean^2."""
    vae = port_tiny().cldm.vae
    g = torch.Generator().manual_seed(37)
    img, z = torch.rand(1, 3, 32, 32, generator=g) * 2 - 1, torch.randn(1, 4, 4, 4, generator=g)
    tol = dict(rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(TT.tiled_vae_encode(vae, img, -1).mean,
                                   TT.tiled_vae_encode(vae, img, 512).mean)
        torch.testing.assert_close(TT.tiled_vae_encode(vae, img, -1).mean,
                                   vae.encode(img).mean, **tol)
        torch.testing.assert_close(TT.tiled_vae_decode(vae, z, 0),
                                   TT.tiled_vae_decode(vae, z, 64))
        torch.testing.assert_close(TT.tiled_vae_decode(vae, z, 0), vae.decode(z), **tol)
