"""The restoration nets no config trains (RRDBNet, EDSR, SCUNet, SKUNet),
SwinIR's other forms and the ``nsampler`` encoder against ``edtr_tpu`` on
the CPU in fp32: every leaf of JAX's tree drawn with numpy, carried into the
port by ``edtr_torch.utils.convert.from_jax`` (a strict load), the same
numpy input through both. The dims are those of JAX's own
``tests/test_restoration_nets.py``; rtol = atol = 3e-3, the module
tolerance (PERF.md §2). Each JAX tree is also carried back through JAX's
reference-checkpoint converter (``convert_*``), so the port's keys are the
reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_torch.utils.convert import from_jax
from torch_port_helpers import cheap_jit, nchw, nhwc, random_tree

TOL = dict(rtol=3e-3, atol=3e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(net, x, seed, **kw):
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.asarray(x), **kw), jax.random.PRNGKey(0))
    tree = random_tree(shapes, seed)
    if "batch_stats" in tree:  # running variances positive
        rng = np.random.default_rng(seed + 1)
        tree["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.random(a.shape) * 0.5 + 0.5).astype(np.float32)
            if p[-1].key == "var" else a, tree["batch_stats"])
    return tree


def _check(jax_net, port_net, kind, x, seed, params_only=True, **kw):
    """JAX's ``jax_net`` and ``port_net`` on one numpy NHWC ``x`` with the
    same random tree; returns the state dict the port loaded."""
    tree = _variables(jax_net, x, seed, **kw)
    y_j = cheap_jit(lambda v, a: jax_net.apply(v, a, **kw))(
        tree if not params_only else {"params": tree["params"]}, jnp.asarray(x))
    sd = from_jax(tree if not params_only else tree["params"], kind)
    port_net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y_t = port_net.eval()(nchw(x), **kw)
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), **TOL)
    return tree, sd


def _input(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _ref_keys(convert, tree_params, sd, **kw):
    """JAX's converter from reference keys reads the port's state dict and
    gives back JAX's tree."""
    back = convert({k: v.numpy() for k, v in sd.items()}, **kw)
    back = back["params"] if "params" in back else back
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree_params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]), err_msg=str(path))


@pytest.mark.parametrize("unshuffle", [False, True])
def test_rrdbnet_matches_jax(unshuffle):
    from edtr_tpu.models.bsrnet import RRDBNet as J
    from edtr_tpu.utils.convert import convert_rrdbnet

    from edtr_torch.models.bsrnet import RRDBNet

    kw = (dict(nf=32, nb=2, gc=16, sf=4, unshuffle=True, unshuffle_scale=8) if unshuffle
          else dict(nf=16, nb=2, gc=8, sf=4))
    x = _input((1, 32 if unshuffle else 16, 32 if unshuffle else 16, 3))
    tree, sd = _check(J(**kw), RRDBNet(**kw), "rrdbnet", x, 3)
    assert ("conv_first.1.weight" in sd) == unshuffle
    _ref_keys(convert_rrdbnet, tree["params"], sd)


@pytest.mark.parametrize("unshuffle", [False, True])
def test_edsr_matches_jax(unshuffle):
    from edtr_tpu.models.edsr import EDSR as J
    from edtr_tpu.utils.convert import convert_edsr

    from edtr_torch.models.edsr import EDSR

    kw = (dict(n_resblocks=2, n_feats=16, scale=4, res_scale=0.1, unshuffle=True,
               unshuffle_scale=8) if unshuffle else dict(n_resblocks=2, n_feats=16, scale=2))
    x = _input((1, 32 if unshuffle else 8, 32 if unshuffle else 8, 3))
    tree, sd = _check(J(**kw), EDSR(**kw), "edsr-unshuffle" if unshuffle else "edsr", x, 5)
    _ref_keys(convert_edsr, tree["params"], sd, n_resblocks=2, unshuffle=unshuffle)


@pytest.mark.parametrize("config", [(1,) * 7, (2,) * 7], ids=["W", "W+SW"])
def test_scunet_matches_jax(config):
    from edtr_tpu.models.scunet import SCUNet as J
    from edtr_tpu.utils.convert import convert_scunet

    from edtr_torch.models.scunet import SCUNet

    x = _input((1, 48, 56, 3), 1)  # edge-padded to 64 x 64 and cropped back
    tree, sd = _check(J(dim=64, config=config, input_resolution=64),
                      SCUNet(dim=64, config=config, input_resolution=64), "scunet", x, 11)
    _ref_keys(convert_scunet, tree["params"], sd)


def test_skunet_matches_jax():
    from edtr_tpu.models.skunet import SKUNet as J
    from edtr_tpu.utils.convert import convert_skunet

    from edtr_torch.models.skunet import SKUNet

    x = _input((2, 32, 32, 3), 2)
    tree, sd = _check(J(), SKUNet(), "skunet", x, 13, params_only=False, normalize=True)
    back = convert_skunet({k: v.numpy() for k, v in sd.items()})
    for col in ("params", "batch_stats"):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back[col]),
                                    jax.tree_util.tree_leaves_with_path(tree[col])):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))


def test_skunet_train_mode_matches_jax():
    """Batch statistics in train mode, and the running ones they update
    (torch's momentum 0.1, Bessel's correction: flax's 0.9 on the same
    unbiased variance as JAX's module computes it)."""
    from edtr_tpu.models.skunet import SKUNet as J

    from edtr_torch.models.skunet import SKUNet

    x = _input((2, 32, 32, 3), 4)
    net_j = J()
    tree = _variables(net_j, x, 17)
    y_j, upd = cheap_jit(lambda v, a: net_j.apply(v, a, train=True, mutable=["batch_stats"]))(
        tree, jnp.asarray(x))
    net = SKUNet()
    net.load_state_dict(from_jax(tree, "skunet"), strict=True)
    y_t = net(nchw(x), train=True)
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), **TOL)
    got = from_jax(dict(tree, batch_stats=upd["batch_stats"]), "skunet")
    for key in ("down2.maxpool_conv.1.BN.running_mean", "up2.conv.BN.running_var"):
        np.testing.assert_allclose(net.state_dict()[key].numpy(), got[key].numpy(), **TOL)


SWINIR_SMALL = dict(embed_dim=16, depths=(1,), num_heads=(2,), window_size=4, mlp_ratio=2)


@pytest.mark.parametrize("form", [
    dict(sf=2, upsampler="pixelshuffle", unshuffle=False),
    dict(sf=4, upsampler="pixelshuffle", unshuffle=False, img_range=255.0),
    dict(sf=1, upsampler="", unshuffle=False),
    dict(sf=1, upsampler="", unshuffle=False, in_chans=1),
    dict(sf=2, upsampler="nearest+conv", unshuffle=False),
], ids=["pixelshuffle-x2", "pixelshuffle-x4-range255", "denoise", "denoise-gray",
        "nearest-conv-no-unshuffle"])
def test_swinir_forms_match_jax(form):
    """SwinIR's forms beside EDTR's: the classical ``pixelshuffle`` tail,
    the residual denoise form (RGB and one channel, no mean), the
    ``nearest+conv`` tail without the unshuffle; the input 18 x 14 pads to
    the window by reflection and the output crops to ``sf`` times it."""
    from edtr_tpu.models.swinir import SwinIR as J
    from edtr_tpu.utils.convert import convert_swinir

    from edtr_torch.models.swinir import SwinIR

    c = form.get("in_chans", 3)
    x = _input((1, 18, 14, c), 7)
    tree, sd = _check(J(**SWINIR_SMALL, **form, fused=False), SwinIR(**SWINIR_SMALL, **form),
                      "swinir", x, 19)
    if form["upsampler"] in ("nearest+conv", "pixelshuffle"):
        _ref_keys(convert_swinir, tree["params"], sd, depths=(1,), unshuffle=False,
                  upsampler=form["upsampler"], sf=form["sf"])


def test_swinir_config_forms_build():
    """``swinir_from_config`` takes every form JAX's SwinIR takes; JAX's
    ``resi_connection`` assertion stays a refusal."""
    from edtr_torch.pipeline import swinir_from_config

    node = dict(params=dict(SWINIR_SMALL, depths=[1], num_heads=[2], sf=2, img_size=64,
                            upsampler="pixelshuffle", unshuffle=False, in_chans=3,
                            img_range=1.0, resi_connection="1conv", patch_size=1))
    net = swinir_from_config(node, device="cpu")
    assert "upsample.2.weight" not in net.state_dict() and "upsample.0.weight" in net.state_dict()
    with pytest.raises(NotImplementedError, match="1conv"):
        swinir_from_config(dict(params=dict(node["params"], resi_connection="3conv")),
                           device="cpu")


def test_nsampler_encoder_matches_jax():
    """The cls test config's ``nsampler`` node (``model.vae.Encoder``) through
    ``instantiate_from_config``: JAX's ``create_encoder`` fields only."""
    from edtr_tpu.models.vae import create_encoder as jcreate

    from edtr_torch.config import instantiate_from_config, load_config
    from edtr_torch.models.vae import Encoder

    node = load_config("configs/cls/cub200/test/007_edtr-s4.yaml")["model"]["nsampler"]
    net = instantiate_from_config(node, device="cpu")
    assert isinstance(net, Encoder)
    params = node.to_dict()["params"]
    x = _input((1, 32, 32, 3), 9)
    _check(jcreate(**params), net, "encoder", x, 23, params_only=True)


@pytest.mark.parametrize("target,params,cls", [
    ("model.bsrnet.RRDBNet", dict(nf=8, nb=1, gc=4), "RRDBNet"),
    ("model.edsr.EDSR", dict(n_resblocks=1, n_feats=8), "EDSR"),
    ("model.scunet.SCUNet", dict(dim=64, config=[1] * 7), "SCUNet"),
    ("model.skunet.SKUNet", dict(), "SKUNet"),
    ("model.vae.Encoder", dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=4,
                               double_z=False, resolution=256, dropout=0.0), "Encoder"),
], ids=lambda v: v if isinstance(v, str) and v.startswith("model.") else None)
def test_instantiate_builds_the_port(target, params, cls):
    from edtr_torch.config import REGISTRY, instantiate_from_config

    extra = dict(device="cpu") if target == "model.vae.Encoder" else {}
    with torch.device("cpu"):
        net = instantiate_from_config(dict(target=target, params=params), **extra)
    assert type(net).__name__ == cls and type(net).__module__.startswith("edtr_torch.models.")
    assert None not in REGISTRY.values()
