"""The port's classification and segmentation task nets
(``edtr_torch.models.{resnet,deeplabv3,mobilenetv3}``) and their losses
(``edtr_torch.train.recipes``) against ``edtr_tpu`` on the CPU in fp32, on
the same numpy inputs and weights (the JAX variables carried over by
``from_jax``): full-width ResNet-18 and ResNet-50, DeepLabV3 on a dilated
MobileNetV3-Large and on ResNet-50, and MobileNetV3's classifier, at
64-256² inputs. Eval mode (logits, feature taps) and one train-mode call
(outputs and the updated running statistics) hold to 3e-3 of each
output's largest value; the resize (antialiased when shrinking) and the
losses, ignored pixels included, to 1e-5. The JAX side is one ``jax.jit``
per network, built once per module; torch runs on one thread.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.models import deeplabv3 as JD
from edtr_tpu.models import mobilenetv3 as JM
from edtr_tpu.models import resnet as JR
from edtr_tpu.train import recipes as JT
from edtr_torch.models import deeplabv3 as TD
from edtr_torch.models import mobilenetv3 as TM
from edtr_torch.models import resnet as TR
from edtr_torch.train import recipes as TT
from edtr_torch.utils.convert import from_jax
from torch_port_helpers import cheap_jit, nchw, nhwc, t2n

TOL = 3e-3
OP_TOL = 1e-5
BATCH = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(shapes, seed: int):
    """Seeded numpy leaves for a flax variables tree: kernels ~ N(0,
    1/fan_in), norm scales 1 + N(0, 0.1²), running variances 1 + |N(0,
    0.2²)|, running means and biases small."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        r = rng.standard_normal(s.shape)
        if name == "kernel":
            r = r / math.sqrt(math.prod(s.shape[:-1]))
        elif name == "scale":
            r = 1 + 0.1 * r
        elif name == "var":
            r = 1 + 0.2 * np.abs(r)
        else:
            r = 0.1 * r if name == "mean" else 0.05 * r
        return r.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _stats(sd):
    return {n: v for n, v in sd.items() if n.endswith(("running_mean", "running_var"))}


# the networks: (JAX module, the port's factory, from_jax's kind, input side)
NETS = {
    "resnet18": (lambda: JR.ResNet(type=18, num_classes=200),
                 lambda: TR.resnet(type=18, num_classes=200, device="cpu"), "resnet", 64),
    "resnet50_resize": (lambda: JR.ResNet(type=50, num_classes=10, resize=True),
                        lambda: TR.resnet(type=50, num_classes=10, resize=True, device="cpu"),
                        "resnet", 256),
    "deeplab_mobilenet": (lambda: JD.deeplabv3_mobilenet_v3_large(num_classes=21),
                          lambda: TD.deeplabv3_mobilenet_v3_large(num_classes=21,
                                                                  device="cpu"),
                          "deeplabv3", 96),
    "deeplab_resnet50": (lambda: JD.deeplabv3_resnet50(num_classes=21, aux_loss=True),
                         lambda: TD.deeplabv3_resnet50(num_classes=21, aux_loss=True,
                                                       device="cpu"),
                         "deeplabv3", 64),
    "mobilenet_cls": (lambda: JM.mobilenet_v3_large(num_classes=100),
                      lambda: TM.mobilenet_v3_large(num_classes=100, device="cpu"),
                      "mobilenetv3", 64),
}


@functools.lru_cache(maxsize=None)
def _jax_side(name: str):
    """(input NHWC, variables, the jitted JAX outputs): eval, eval with the
    feature taps, train (with its updated batch_stats) and, for ResNet,
    the stage outputs and the 2x-upsampled eval."""
    make, _, _, side = NETS[name]
    net = make()
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.random((BATCH, side, side, 3)).astype(np.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    variables = random_variables(shapes, seed=len(name))
    resnet, mobilenet = isinstance(net, JR.ResNet), isinstance(net, JM.MobileNetV3)

    def run(v, x):
        out = dict(eval=net.apply(v, x), train=net.apply(v, x, train=True,
                                                         mutable=["batch_stats"]))
        if mobilenet:
            return out
        kw = dict(normalize=True) if resnet else {}
        out["feat"] = net.apply(v, x, return_feat=True, **kw)[1]
        if resnet:
            out["stages"] = net.apply(v, x, features=True)
            out["up2"] = net.apply(v, x, upsample=2)
        return out

    return x, variables, jax.tree.map(np.asarray, cheap_jit(run)(variables, x))


def _port(name: str, variables):
    _, factory, kind, _ = NETS[name]
    net = factory()
    net.load_state_dict(from_jax(variables, kind), strict=True)
    return net


@pytest.mark.parametrize("name", list(NETS))
def test_tasknet_matches_jax(name):
    x, variables, want = _jax_side(name)
    net = _port(name, variables)
    xt = nchw(x)
    with torch.no_grad():
        if name.startswith("deeplab"):
            got, taps = net(xt, return_feat=True)
            assert set(got) == set(want["eval"]) == {"out", "aux"}
            for k in got:
                _close(nhwc(got[k]), want["eval"][k], what=f"{name} {k}")
            assert set(want["feat"]) <= set(taps)
            for k, v in want["feat"].items():
                _close(nhwc(taps[k]), v, what=f"{name} tap {k}")
        elif name.startswith("resnet"):
            logits, feat = net(xt, return_feat=True)
            _close(t2n(logits), want["eval"], what=f"{name} logits")
            _close(nhwc(feat), want["feat"], what=f"{name} layer4")
            for i, (a, b) in enumerate(zip(net(xt, features=True), want["stages"])):
                _close(nhwc(a), b, what=f"{name} C{i + 2}")
            _close(t2n(net(xt, upsample=2)), want["up2"], what=f"{name} upsample 2")
        else:
            _close(t2n(net(xt, features=False)), want["eval"], what=f"{name} logits")
        # one train-mode call: batch statistics, the running ones updated
        out = net(xt, train=True) if not name.startswith("mobilenet") else net(
            xt, train=True, features=False)
    want_out, want_vars = want["train"]
    if isinstance(out, dict):
        for k in out:
            _close(nhwc(out[k]), want_out[k], what=f"{name} train {k}")
    else:
        _close(t2n(out), want_out, what=f"{name} train logits")
    got_stats = _stats(net.state_dict())
    want_stats = _stats(from_jax(dict(variables, batch_stats=want_vars["batch_stats"]),
                                 NETS[name][2]))
    assert set(got_stats) == set(want_stats)
    for n, v in want_stats.items():
        _close(t2n(got_stats[n]), t2n(v), what=f"{name} {n}")


@pytest.mark.parametrize("src,dst", [((96, 96), (56, 40)), ((256, 256), (224, 224)),
                                     ((8, 12), (64, 40))])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(3).random((2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *dst, 3), "bilinear"))
    _close(nhwc(TR.resize_bilinear(nchw(x), dst)), want, tol=OP_TOL)


def test_losses_match_jax():
    g = np.random.default_rng(4)
    logits = (g.standard_normal((5, 200)) * 3).astype(np.float32)
    labels = g.integers(0, 200, 5).astype(np.int32)
    np.testing.assert_allclose(
        float(TT.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(JT.cross_entropy(logits, labels)), rtol=OP_TOL)
    seg = (g.standard_normal((2, 12, 10, 21)) * 3).astype(np.float32)
    mask = g.integers(0, 21, (2, 12, 10)).astype(np.int32)
    mask[:, :2] = 255  # VOC's border
    mask[0, 5:, 3] = 255
    want = float(JT.seg_cross_entropy(seg, mask))
    got = float(TT.seg_cross_entropy(torch.from_numpy(seg), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=OP_TOL)
    # every pixel ignored: 0, as JAX's (the count clamps at 1)
    none = np.full_like(mask, 255)
    assert float(TT.seg_cross_entropy(torch.from_numpy(seg), torch.from_numpy(none))) == 0.0
    assert float(JT.seg_cross_entropy(seg, none)) == 0.0


def test_mobilenet_knobs_match_jax():
    """The tables of ``width_mult``, ``reduced_tail`` and ``dilated``, and
    the stage taps DeepLabV3 reads, as JAX's."""
    for kw in (dict(), dict(width_mult=0.75), dict(reduced_tail=True), dict(dilated=True)):
        want = JM.mobilenet_v3_large_conf(**kw)
        got = TM.mobilenet_v3_large_conf(**kw)
        assert [tuple(c) for c in got[0]] == [tuple(c) for c in want[0]] and got[1] == want[1]
        tnet, jnet = TM.MobileNetV3(**kw), JM.MobileNetV3(**kw)
        assert tnet.stage_indices() == jnet.stage_indices()
        assert tnet.stage_channels() == jnet.stage_channels()


@pytest.mark.parametrize("task", ["seg", "cls"])
def test_calibrated_random_nets_move_with_their_input(task):
    """``calibrate_unit_rms_`` on seeded random weights (``randomize_``):
    every conv and linear layer then puts out unit RMS on the calibration
    images, and the logits move with the input (by 1e-2 or more for noise
    of 0.1), which the random DeepLabV3-MobileNetV3's do not, its biases
    setting its output."""
    from edtr_torch.models.layers import Conv2d, Linear, calibrate_unit_rms_, randomize_

    net = (TD.deeplabv3_mobilenet_v3_large(num_classes=21, device="cpu") if task == "seg"
           else TR.resnet(type=18, num_classes=200, device="cpu"))
    randomize_(net, torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(3)
    x = torch.rand((BATCH, 3, 64, 64), generator=g)
    noisy = (x + 0.1 * torch.randn(x.shape, generator=g)).clamp(0, 1)

    def logits(img):
        out = net(img)
        return out["out"] if task == "seg" else out

    def moved():
        with torch.no_grad():
            a, b = logits(noisy), logits(x)
        return float((a - b).norm() / b.norm())

    if task == "seg":
        assert moved() < 1e-2
    layers = [m for m in net.modules() if isinstance(m, (Conv2d, Linear))]
    calibrate_unit_rms_(layers, lambda: logits(x))
    rms = []
    hooks = [m.register_forward_hook(lambda m, a, out: rms.append(float(out.square().mean())))
             for m in layers]
    with torch.no_grad():
        logits(x)
    for h in hooks:
        h.remove()
    assert len(rms) >= len(layers)
    np.testing.assert_allclose(rms, 1.0, rtol=1e-4)
    assert moved() >= 1e-2
