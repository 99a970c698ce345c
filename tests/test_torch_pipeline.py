"""The port's whole tiny EDTR restore against ``edtr_tpu``'s
``EDTRPipeline.restore`` on the same weights, input and noise, on the CPU
in fp32. The noise the JAX graph draws is replayed from its key splits
(``pipeline.py``: rng -> (q_sample, sampler); ``sampler.py``: one split of
the carried key per step) and handed to the port. Tolerances are those of
the JAX package's full-chain golden (tests/test_fullchain_golden.py):
pre_restored 2e-3, z 5e-3, restored 1e-2. The default configuration and
the stock one (``torch_port_helpers.stock_restore``, which the fused
configurations' tiny restores are held to) are both held."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CTX, IMAGE, jax_tiny, port_tiny, stock_restore, t2n


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replay_noise(rng, latent_shape, steps):
    rng_noise, rng_sample = jax.random.split(rng)
    noise = jax.random.normal(rng_noise, latent_shape, jnp.float32)
    key, step_noise = rng_sample, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        step_noise.append(jax.random.normal(sub, latent_shape, jnp.float32))
    return np.array(noise), np.stack([np.asarray(n) for n in step_noise])


RESTORE_KEY = 231


def restore_inputs():
    """The tiny restore's (lq, c_txt), numpy-seeded."""
    g = np.random.default_rng(21)
    return (g.random((1, IMAGE, IMAGE, 3)).astype(np.float32),
            g.standard_normal((1,) + CTX).astype(np.float32))


def test_tiny_restore_matches_jax():
    pipe, params = jax_tiny()
    port = port_tiny()
    assert port.used_timesteps == pipe.used_timesteps == [50, 100, 150, 200]
    lq, c_txt = restore_inputs()
    rng = jax.random.PRNGKey(RESTORE_KEY)

    out_j = jax.jit(lambda p, x, r, c: pipe.restore(p, x, r, c_txt=c))(
        params, jnp.asarray(lq), rng, jnp.asarray(c_txt))
    hw = IMAGE // 8
    noise, step_noise = _replay_noise(rng, (1, hw, hw, 4), len(pipe.used_timesteps))
    out_t = port.restore(torch.from_numpy(lq), torch.from_numpy(c_txt),
                         noise=torch.from_numpy(noise),
                         step_noise=torch.from_numpy(step_noise))

    stock = stock_restore()[1]  # the stock configuration, the others' reference
    for name, tol in (("pre_restored", 2e-3), ("z", 5e-3), ("restored", 1e-2)):
        for a, b in ((t2n(out_t[name]), np.asarray(out_j[name])),
                     (stock[name], np.asarray(out_j[name]))):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
