"""The port's sampler and posterior against ``edtr_tpu`` on the CPU.

* ``space_timesteps``: the same sets for counts, sections and ``ddimN``,
  and both of JAX's ``ValueError``s.
* ``make_spaced_schedule`` under JAX's signature, with and without
  ``used_timesteps`` (``num_steps`` 1 included): every table within 1e-7.
* The VAE posterior (``models/distributions.py``): ``sample`` on replayed
  noise, ``kl`` (also to another posterior), ``nll``, deterministic: 1e-6.
* ``p_sample`` with classifier-free guidance on a toy ``model_fn`` (a fixed
  linear map of x, t and the condition): 2e-5.
* ``SpacedSampler.sample`` from pure noise (10 steps) and
  ``manual_sample_with_timesteps`` with ``return_intermediates``, x_T and
  the step noises replayed from JAX's key splits (``sample_scan``'s): 2e-5;
  the schedule cache's identity.
* ``vae_encode(sample=True)`` on the tiny VAE: 3e-3.
* ``make_edtr_sample_fn`` against JAX's on the tiny pipeline, the noise
  replayed: 1e-2, the tiny restore's tolerance. ``SpacedSampler`` takes the
  card unless a device is named.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.diffusion import sampler as JS
from edtr_tpu.diffusion import schedule as JSch
from edtr_tpu.models.distributions import DiagonalGaussianDistribution as JDist
from edtr_tpu.train import edtr_step as JE
from edtr_torch.diffusion import sampler as TS
from edtr_torch.diffusion.schedule import Diffusion, space_timesteps
from edtr_torch.models.distributions import DiagonalGaussianDistribution
from edtr_torch.train.edtr_step import make_edtr_sample_fn
from test_torch_pipeline import _replay_noise
from torch_port_helpers import CTX, IMAGE, jax_tiny, nchw, nhwc, port_tiny, t2n

TOL_WALK = dict(rtol=2e-5, atol=2e-5)
TABLES = ("sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _betas():
    return Diffusion.create(1000, linear_start=0.00085, linear_end=0.0120).betas


@pytest.mark.parametrize("counts", ["1", "4", "10", "50", "ddim50", "10,15,20", [3, 5]])
def test_space_timesteps_equal(counts):
    assert space_timesteps(1000, counts) == JSch.space_timesteps(1000, counts)


@pytest.mark.parametrize("n,counts", [(1000, "ddim1001"), (10, "11"), (10, "3,6")])
def test_space_timesteps_errors(n, counts):
    with pytest.raises(ValueError) as want:
        JSch.space_timesteps(n, counts)
    with pytest.raises(ValueError) as got:
        space_timesteps(n, counts)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("num_steps,used", [(4, [50, 100, 150, 200]), (4, None), (50, None),
                                            (1, None), (1, [200]), (3, [999, 0, 500])])
def test_spaced_schedule_tables(num_steps, used):
    betas = _betas()
    want = JS.make_spaced_schedule(betas, num_steps, used)
    got = TS.make_spaced_schedule(betas, num_steps, used)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    for f in TABLES:
        np.testing.assert_allclose(t2n(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=1e-7, atol=0, err_msg=f)
    if num_steps == 1:
        assert t2n(got.posterior_log_variance_clipped).tolist() == [-10.0]
    with pytest.raises(AssertionError):
        TS.make_spaced_schedule(betas, num_steps + 1, used or sorted(got.timesteps))


def test_q_posterior_mean_variance_has_the_log_variance():
    betas = _betas()
    want = JS.make_spaced_schedule(betas, 4, [50, 100, 150, 200])
    got = TS.make_spaced_schedule(betas, 4, [50, 100, 150, 200])
    rng = np.random.default_rng(3)
    x0, xt = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    idx = np.array([0, 2, 3], np.int32)
    outs_j = want.q_posterior_mean_variance(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(idx))
    outs_t = got.q_posterior_mean_variance(nchw(x0), nchw(xt), torch.from_numpy(idx).long())
    assert len(outs_t) == len(outs_j) == 3
    np.testing.assert_allclose(nhwc(outs_t[0]), np.asarray(outs_j[0]), rtol=1e-6, atol=1e-6)
    for a, b in zip(outs_t[1:], outs_j[1:]):
        np.testing.assert_allclose(t2n(a).reshape(-1), np.asarray(b).reshape(-1), rtol=1e-6)


def _params(seed, shape=(2, 5, 5, 8)):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    p[..., shape[-1] // 2:] *= 3  # log-variances past the clamp at both ends
    p[0, 0, 0, -1], p[1, 0, 0, -1] = 40.0, -40.0
    return p


@pytest.mark.parametrize("deterministic", [False, True])
def test_posterior_sample_kl_nll(deterministic):
    p, q = _params(4), _params(5)
    jd, jo = JDist(jnp.asarray(p), deterministic), JDist(jnp.asarray(q))
    td, to = DiagonalGaussianDistribution(nchw(p), deterministic), DiagonalGaussianDistribution(
        nchw(q))
    tol = dict(rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(6)
    noise = np.asarray(jax.random.normal(key, jd.mean.shape, jnp.float32))
    np.testing.assert_allclose(nhwc(td.sample(nchw(noise))), np.asarray(jd.sample(key)), **tol)
    np.testing.assert_allclose(nhwc(td.std), np.asarray(jd.std), **tol)
    np.testing.assert_allclose(nhwc(td.var), np.asarray(jd.var), **tol)
    np.testing.assert_allclose(nhwc(td.mode()), np.asarray(jd.mode()), **tol)
    np.testing.assert_allclose(t2n(td.kl()), np.asarray(jd.kl()), rtol=1e-6)
    np.testing.assert_allclose(t2n(td.kl(to)), np.asarray(jd.kl(jo)), rtol=1e-6)
    sample = (np.asarray(jd.mean) + 0.5).astype(np.float32)
    np.testing.assert_allclose(t2n(td.nll(nchw(sample))), np.asarray(jd.nll(jnp.asarray(sample))),
                               rtol=1e-6)


def _toy(seed=7, c=4):
    """A fixed linear map of x, t and the condition (NHWC on JAX's side,
    NCHW on the port's)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((c, c)) / c).astype(np.float32)
    u = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def model_j(x, t, cond):
        tt = (t.astype(jnp.float32) / 1000.0)[:, None, None, None]
        return x @ w + tt * u + 0.5 * cond["c"]

    def model_t(x, t, cond):
        tt = (t.float() / 1000.0)[:, None, None, None]
        y = torch.einsum("bchw,cd->bdhw", x, torch.from_numpy(w))
        return y + tt * torch.from_numpy(u)[None, :, None, None] + 0.5 * cond["c"]

    return model_j, model_t


def _conds(seed=8, shape=(2, 6, 6, 4)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("cfg_scale", [1.0, 3.5])
@pytest.mark.parametrize("index", [2, 0])
def test_p_sample_cfg(index, cfg_scale):
    betas = _betas()
    js = JS.make_spaced_schedule(betas, 4, [50, 100, 150, 200])
    ts = TS.make_spaced_schedule(betas, 4, [50, 100, 150, 200])
    model_j, model_t = _toy()
    x, c, u = _conds()
    t, idx = np.array([150, 150], np.int32), np.array([index, index], np.int32)
    key = jax.random.PRNGKey(index)
    x_j, x0_j = JS.p_sample(model_j, js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(idx),
                            {"c": jnp.asarray(c)}, key, {"c": jnp.asarray(u)}, cfg_scale)
    calls = []

    def counted(x_, t_, cond):
        calls.append(1)
        return model_t(x_, t_, cond)

    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    x_t, x0_t = TS.p_sample(counted, ts, nchw(x), torch.from_numpy(t).long(),
                            torch.from_numpy(idx).long(), {"c": nchw(c)}, nchw(noise),
                            {"c": nchw(u)}, cfg_scale)
    np.testing.assert_allclose(nhwc(x_t), np.asarray(x_j), **TOL_WALK)
    np.testing.assert_allclose(nhwc(x0_t), np.asarray(x0_j), **TOL_WALK)
    assert len(calls) == (1 if cfg_scale == 1.0 else 2)


def _scan_noises(key, shape, steps):
    """sample_scan's step noises: ``key, sub = split(key)`` each step."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out).transpose(0, 1, 4, 2, 3).copy())


def test_spaced_sampler_from_pure_noise():
    betas = _betas()
    model_j, model_t = _toy(9)
    x, c, u = _conds(10)
    jsam, tsam = JS.SpacedSampler(betas), TS.SpacedSampler(betas, "cpu")
    rng = jax.random.PRNGKey(11)
    want = jsam.sample(model_j, 10, x.shape[1:], {"c": jnp.asarray(c)}, rng,
                       batch_size=2, uncond={"c": jnp.asarray(u)}, cfg_scale=2.0)
    rest, sub = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(sub, x.shape, jnp.float32))
    got = tsam.sample(model_t, 10, (4, 6, 6), {"c": nchw(c)}, batch_size=2, x_T=nchw(x_T),
                      uncond={"c": nchw(u)}, cfg_scale=2.0,
                      step_noise=_scan_noises(rest, x.shape, 10))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL_WALK)
    assert tsam.make_schedule(10) is tsam.make_schedule(10)
    assert tsam.make_schedule(4, [200, 50, 150, 100]) is tsam.make_schedule(4, [50, 100, 150,
                                                                                 200])
    assert tsam.make_schedule(4) is not tsam.make_schedule(4, [50, 100, 150, 200])
    # drawn from a generator: the same generator state gives the same walk
    a = tsam.sample(model_t, 10, (4, 6, 6), {"c": nchw(c)}, batch_size=2,
                    generator=torch.Generator().manual_seed(3))
    b = tsam.sample(model_t, 10, (4, 6, 6), {"c": nchw(c)}, batch_size=2,
                    generator=torch.Generator().manual_seed(3))
    assert a.shape == (2, 4, 6, 6) and torch.equal(a, b)


def test_manual_sample_with_intermediates():
    betas = _betas()
    model_j, model_t = _toy(12)
    x, c, _ = _conds(13)
    used = [50, 100, 150, 200]
    rng = jax.random.PRNGKey(14)
    want, want_inter = JS.SpacedSampler(betas).manual_sample_with_timesteps(
        model_j, jnp.asarray(x), 4, used, {"c": jnp.asarray(c)}, rng,
        return_intermediates=True)
    got, inter = TS.SpacedSampler(betas, "cpu").manual_sample_with_timesteps(
        model_t, nchw(x), 4, used, {"c": nchw(c)}, return_intermediates=True,
        step_noise=_scan_noises(rng, x.shape, 4))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL_WALK)
    assert inter.shape == (4,) + tuple(nchw(x).shape)
    np.testing.assert_allclose(t2n(inter).transpose(0, 1, 3, 4, 2), np.asarray(want_inter),
                               **TOL_WALK)


def test_vae_encode_sample_matches_jax():
    pipe_j, params = jax_tiny()
    port = port_tiny()
    img = np.random.default_rng(15).uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(16)
    want = pipe_j.cldm.vae_encode(params, jnp.asarray(img), sample=True, rng=key)
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    with torch.no_grad():
        got = port.cldm.vae_encode(nchw(img), sample=True, noise=nchw(noise))
        mode = port.cldm.vae_encode(nchw(img))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=3e-3, atol=3e-3)
    assert float((got - mode).abs().max()) > 1e-3  # the sample is not the mode


def test_spaced_sampler_runs_on_the_card_unless_named(monkeypatch):
    """With no device named, the sampler takes the card, and raises where
    there is none rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.SpacedSampler(_betas())
    assert TS.SpacedSampler(_betas(), "cpu").make_schedule(4).timesteps.tolist() == [
        0, 333, 666, 999]


def test_edtr_sample_fn_matches_jax():
    """The port's sample fn against JAX's ``make_edtr_sample_fn`` (one
    graph) on the tiny pipeline, the q_sample and step noise replayed from
    JAX's key splits; the tolerance of ``test_tiny_restore_matches_jax``."""
    pipe_j, params = jax_tiny()
    port = port_tiny()
    rng = np.random.default_rng(17)
    lq = rng.random((2, IMAGE, IMAGE, 3)).astype(np.float32)
    c_txt = rng.standard_normal((2,) + CTX).astype(np.float32)
    key = jax.random.PRNGKey(18)
    want = JE.make_edtr_sample_fn(pipe_j, jit=True, staged=False)(
        params, jnp.asarray(lq), jnp.asarray(c_txt), key)
    lat = IMAGE // 8
    noise, step_noise = _replay_noise(key, (2, lat, lat, 4), len(pipe_j.used_timesteps))
    got = make_edtr_sample_fn(port)(torch.from_numpy(lq), torch.from_numpy(c_txt),
                                    torch.from_numpy(noise), torch.from_numpy(step_noise))
    assert got.shape == (2, IMAGE, IMAGE, 3)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-2, atol=1e-2)
    assert port.sampler.make_schedule(4, port.used_timesteps) is port.schedule
    assert port.num_timesteps == 4
