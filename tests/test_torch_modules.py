"""edtr_torch modules against their edtr_tpu counterparts, on the CPU in
fp32, on the same weights (the JAX tree carried over by the bridge) and the
same numpy inputs. rtol = atol = 3e-3, the tolerance of the JAX package's
own torch goldens (tests/test_unet_golden.py); both sides compute in fp32,
so the gap is summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CTX, IMAGE, jax_tiny, nchw, nhwc, port_tiny, t2n

TOL = dict(rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm32(eps):
    from edtr_tpu.models.layers import GroupNorm32 as JGN

    from edtr_torch.models.layers import GroupNorm32

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 8, 64)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    y_j = JGN(epsilon=eps).apply({"params": {"scale": scale, "bias": bias}}, x)
    gn = GroupNorm32(64, eps=eps)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(nhwc(gn(nchw(x))), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    from edtr_tpu.models.layers import timestep_embedding as jte

    from edtr_torch.models.layers import timestep_embedding

    t = np.array([0, 50, 200, 999], np.int32)
    np.testing.assert_allclose(t2n(timestep_embedding(torch.from_numpy(t), dim)),
                               np.asarray(jte(jnp.asarray(t), dim)), **TOL)


def test_schedule_tables_and_p_sample():
    from edtr_tpu.diffusion import sampler as JS
    from edtr_tpu.diffusion.schedule import Diffusion as JD

    from edtr_torch.diffusion.sampler import make_spaced_schedule, p_sample
    from edtr_torch.diffusion.schedule import Diffusion

    jd = JD.create(timesteps=1000, linear_start=0.00085, linear_end=0.0120)
    d = Diffusion.create(1000, linear_start=0.00085, linear_end=0.0120)
    np.testing.assert_allclose(d.betas, np.asarray(jd.betas), rtol=1e-6)
    for f in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
              "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_allclose(t2n(getattr(d, f)), np.asarray(getattr(jd, f)),
                                   rtol=1e-6, err_msg=f)
    used = [50, 100, 150, 200]
    js = JS.make_spaced_schedule(np.asarray(d.betas), 4, used)
    s = make_spaced_schedule(d.betas, 4, used)
    for f in ("sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
              "posterior_variance", "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_allclose(t2n(getattr(s, f)), np.asarray(getattr(js, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(s.timesteps, np.asarray(js.timesteps))

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    c = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([150, 150], np.int32)
    for index in (2, 0):  # index 0 adds no noise
        idx = np.array([index, index], np.int32)
        key = jax.random.PRNGKey(index)
        x_j, x0_j = JS.p_sample(lambda x_, t_, cond: 0.3 * x_ + cond["c"], js,
                                jnp.asarray(x), jnp.asarray(t), jnp.asarray(idx),
                                {"c": jnp.asarray(c)}, key)
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        x_t, x0_t = p_sample(lambda x_, t_, cond: 0.3 * x_ + cond["c"], s, nchw(x),
                             torch.from_numpy(t).long(), torch.from_numpy(idx).long(),
                             {"c": nchw(c)}, nchw(noise))
        np.testing.assert_allclose(nhwc(x_t), np.asarray(x_j), **TOL)
        np.testing.assert_allclose(nhwc(x0_t), np.asarray(x0_j), **TOL)
    z0 = nchw(x)
    tt = torch.tensor([200, 7])
    np.testing.assert_allclose(
        nhwc(d.q_sample(z0, tt, nchw(c))),
        np.asarray(jd.q_sample(jnp.asarray(x), jnp.asarray(tt.numpy()), jnp.asarray(c))),
        **TOL)
    np.testing.assert_allclose(
        nhwc(d.predict_xstart_from_eps(z0, tt, nchw(c))),
        np.asarray(jd.predict_xstart_from_eps(jnp.asarray(x), jnp.asarray(tt.numpy()),
                                              jnp.asarray(c))), **TOL)


def _latent_inputs(seed):
    rng = np.random.default_rng(seed)
    hw = IMAGE // 8
    x = rng.standard_normal((1, hw, hw, 4)).astype(np.float32)
    hint = rng.standard_normal((1, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((1,) + CTX).astype(np.float32)
    return x, hint, ctx, np.array([150], np.int32)


def test_controlnet():
    pipe, params = jax_tiny()
    port = port_tiny()
    x, hint, ctx, t = _latent_inputs(2)
    outs_j = pipe.cldm.controlnet.apply({"params": params["controlnet"]}, x, hint, t, ctx)
    with torch.no_grad():
        outs_t = port.cldm.controlnet(nchw(x), nchw(hint), torch.from_numpy(t).long(),
                                      torch.from_numpy(ctx))
    # one per input block plus the middle block (13 at SD2.1 width)
    assert len(outs_t) == len(outs_j) == len(port.cldm.controlnet.input_blocks) + 1
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), err_msg=f"control {i}", **TOL)


@pytest.mark.parametrize("subpix", [None, "0"])
def test_unet_with_control(subpix, monkeypatch):
    # JAX's UNet upsample is the phase-folded subpixel conv by default and
    # the nearest-2x conv with EDTR_UPS_SUBPIX=0: the port matches both
    if subpix is not None:
        monkeypatch.setenv("EDTR_UPS_SUBPIX", subpix)
    pipe, params = jax_tiny()
    port = port_tiny()
    x, _, ctx, t = _latent_inputs(3)
    with torch.no_grad():
        shapes = [c.shape for c in port.cldm.controlnet(
            nchw(x), nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))]
    rng = np.random.default_rng(4)
    control = [rng.standard_normal((s[0], s[2], s[3], s[1])).astype(np.float32)
               for s in shapes]
    eps_j = pipe.cldm.unet.apply({"params": params["unet"]}, x, t, ctx,
                                 control=[jnp.asarray(c) for c in control])
    with torch.no_grad():
        eps_t = port.cldm.unet(nchw(x), torch.from_numpy(t).long(),
                               torch.from_numpy(ctx), control=[nchw(c) for c in control])
    np.testing.assert_allclose(nhwc(eps_t), np.asarray(eps_j), **TOL)


def test_vae_encode_mode_and_decode():
    pipe, params = jax_tiny()
    port = port_tiny()
    rng = np.random.default_rng(6)
    img = (rng.random((1, IMAGE, IMAGE, 3)) * 2 - 1).astype(np.float32)
    z_j = pipe.cldm.vae_encode(params, jnp.asarray(img), sample=False)
    with torch.no_grad():
        z_t = port.cldm.vae_encode(nchw(img))
    np.testing.assert_allclose(nhwc(z_t), np.asarray(z_j), **TOL)
    z = rng.standard_normal(z_j.shape).astype(np.float32)
    dec_j = pipe.cldm.vae_decode(params, jnp.asarray(z))
    with torch.no_grad():
        dec_t = port.cldm.vae_decode(nchw(z))
    np.testing.assert_allclose(nhwc(dec_t), np.asarray(dec_j), **TOL)


def test_swinir_with_shifted_block():
    pipe, params = jax_tiny()
    port = port_tiny()
    # the tiny net's second block is shifted: 8x8 tokens > window 4
    assert port.swinir.layers[0].residual_group.blocks[1].shift == 2
    lq = np.random.default_rng(7).random((1, IMAGE, IMAGE, 3)).astype(np.float32)
    out_j = pipe.swinir.apply({"params": params["swinir"]}, jnp.asarray(lq))
    with torch.no_grad():
        out_t = port.swinir(nchw(lq))
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), **TOL)


def test_wavelet_reconstruction():
    from edtr_tpu.utils.image import wavelet_reconstruction as jwr

    from edtr_torch.utils.image import wavelet_reconstruction

    rng = np.random.default_rng(8)
    a = rng.random((2, 64, 64, 3)).astype(np.float32)
    b = rng.random((2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(nhwc(wavelet_reconstruction(nchw(a), nchw(b))),
                               np.asarray(jwr(jnp.asarray(a), jnp.asarray(b))), **TOL)
