"""The port's image utilities and LPIPS (``edtr_torch.utils.image``,
``edtr_torch.models.lpips``) against ``edtr_tpu`` on the CPU:

* LPIPS with the AlexNet and the VGG16 tower, random weights (a JAX tree
  drawn from numpy, carried over by ``from_jax(tree, "lpips"[-vgg])``),
  fp32: distances at 1e-5 relative;
  ``calculate_lpips`` from an ``lpips`` package state dict written to
  ``tmp_path`` (its ``scaling_layer`` and ``lins.*`` entries as the
  package saves them) against JAX's, read from the same file; no weights
  raises ``NotImplementedError`` on both sides;
* ``calculate_psnr`` (fp32, fp64, cropped, on the luma) and
  ``rgb2ycbcr_y`` at 1e-6; ``pad_if_smaller`` and ``pad_to_multiples_of``
  exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.models import lpips as JL
from edtr_tpu.utils import image as JI
from edtr_torch.models import lpips as TL
from edtr_torch.utils import image as TI
from edtr_torch.utils.convert import from_jax
from torch_port_helpers import nchw, nhwc, t2n


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes need one thread; the suite runs several test processes on
    a few cores, and torch's own pool in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZES = {"alex": 72, "vgg": 32}


def _lpips_pair(net: str, seed: int = 40):
    """(JAX module, its numpy tree, the port's module with that tree):
    conv kernels ~ N(0, 2/fan_in), biases N(0, 0.1^2), heads |N(0, 0.1^2)|."""
    side = SIZES[net]
    jm = JL.LPIPS(net=net)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)),
                            jnp.zeros((1, side, side, 3)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [p.key for p in path]
        if names[0].startswith("lin"):
            return np.abs(rng.standard_normal(s.shape)) * 0.1
        if names[-1] == "kernel":
            return rng.standard_normal(s.shape) * (2.0 / np.prod(s.shape[:-1])) ** 0.5
        return rng.standard_normal(s.shape) * 0.1

    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.tree_util.tree_map_with_path(leaf, shapes))
    port = TL.LPIPS(net)
    port.load_state_dict(from_jax(tree, "lpips" if net == "alex" else "lpips-vgg"), strict=True)
    return jm, tree, port.eval()


def _images(side, seed=41):
    g = np.random.default_rng(seed)
    return [g.uniform(-1, 1, (2, side, side + 8, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(net):
    jm, tree, port = _lpips_pair(net)
    x, y = _images(SIZES[net])
    want = np.asarray(jm.apply({"params": tree}, x, y))
    with torch.no_grad():
        got = t2n(port(nchw(x), nchw(y)))
    assert got.shape == want.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_calculate_lpips_from_a_state_dict_file(tmp_path, monkeypatch):
    """The port's file, as the ``lpips`` package writes a state dict (its
    scaling layer's constants and the heads' second ``lins.*`` names
    included), read by both sides; 8-pixel border crop, [0, 1] inputs."""
    _, tree, port = _lpips_pair("alex", seed=42)
    sd = dict(port.state_dict())
    sd["scaling_layer.shift"] = torch.tensor(TL.SHIFT)[None, :, None, None]
    sd["scaling_layer.scale"] = torch.tensor(TL.SCALE)[None, :, None, None]
    sd.update({f"lins.{i}.model.1.weight": sd[f"lin{i}.model.1.weight"] for i in range(5)})
    path = str(tmp_path / "alex.pth")
    torch.save(sd, path)
    x, y = ((a + 1) / 2 for a in _images(SIZES["alex"] + 16, seed=43))
    want = np.asarray(JI.calculate_lpips(jnp.asarray(x), jnp.asarray(y), weights_path=path))
    got = TI.calculate_lpips(nchw(x), nchw(y), weights_path=path)
    np.testing.assert_allclose(t2n(got), want, rtol=1e-5)
    monkeypatch.setenv("EDTR_LPIPS_WEIGHTS", path)
    np.testing.assert_allclose(t2n(TI.calculate_lpips(nchw(x), nchw(y))), want, rtol=1e-5)
    bad = dict(sd, **{"scaling_layer.shift": torch.zeros(1, 3, 1, 1)})
    torch.save(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(ValueError, match="scaling_layer"):
        TL.load_lpips(str(tmp_path / "bad.pth"), device="cpu")
    monkeypatch.delenv("EDTR_LPIPS_WEIGHTS")
    with pytest.raises(NotImplementedError):
        TI.calculate_lpips(nchw(x), nchw(y))
    with pytest.raises(NotImplementedError):
        JI.calculate_lpips(jnp.asarray(x), jnp.asarray(y))


@pytest.mark.parametrize("crop,y_channel,dtype", [(0, False, np.float32), (4, False, np.float32),
                                                  (4, True, np.float32), (0, True, np.float64)])
def test_psnr_and_luma(crop, y_channel, dtype):
    g = np.random.default_rng(44)
    a = g.random((3, 20, 24, 3)).astype(dtype)
    b = np.clip(a + g.normal(0, 0.05, a.shape), 0, 1).astype(dtype)
    want = np.asarray(JI.calculate_psnr(jnp.asarray(a), jnp.asarray(b), crop, y_channel))
    got = TI.calculate_psnr(nchw(a), nchw(b), crop, y_channel)
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(nhwc(TI.rgb2ycbcr_y(nchw(a).float())),
                               np.asarray(JI.rgb2ycbcr_y(jnp.asarray(a, jnp.float32))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw,size,multiple", [((30, 50), 40, 64), ((512, 700), 512, 64),
                                              ((64, 64), 32, 64), ((100, 37), 128, 8)])
def test_pads_exact(hw, size, multiple):
    x = np.random.default_rng(45).random((1, *hw, 3)).astype(np.float32)
    want = JI.pad_to_multiples_of(JI.pad_if_smaller(jnp.asarray(x), size), multiple)
    got = TI.pad_to_multiples_of(TI.pad_if_smaller(nchw(x), size), multiple)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(nhwc(TI.pad_if_smaller(nchw(x), size)),
                                  np.asarray(JI.pad_if_smaller(jnp.asarray(x), size)))
