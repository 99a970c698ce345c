"""The weight bridge (``edtr_torch.utils.convert``), the lane-padded SwinIR
strip, the port's import hygiene and its device rule."""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.models.swinir import SwinIR as JSwinIR
from edtr_tpu.utils import convert as C
from edtr_torch.models.swinir import SwinIR
from edtr_torch.pipeline import flagship_configs
from edtr_torch.utils.convert import from_jax, strip_swinir_lanes
from torch_port_helpers import IMAGE, jax_tiny, nchw, nhwc, port_tiny, random_tree


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent

UNET_ARCH = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
                 attention_resolutions=(1,), transformer_depth=1,
                 use_linear_in_transformer=True)
# the JAX package's own converters, torch state dict -> JAX tree
CONVERTERS = {
    "unet": lambda sd: C.convert_ldm_unet(sd, **UNET_ARCH),
    "controlnet": lambda sd: C.convert_controlnet(sd, **UNET_ARCH),
    "vae": lambda sd: C.convert_autoencoder_kl(sd, ch=32, ch_mult=(1, 2, 2, 2),
                                               num_res_blocks=1),
    "swinir": lambda sd: C.convert_swinir(sd, depths=(2,)),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("model", sorted(CONVERTERS))
def test_bridge_round_trips_through_reference_keys(model):
    """JAX tree -> bridge -> the port's module (strict load) -> its
    state_dict -> edtr_tpu's checkpoint converter -> the same JAX tree:
    the port's parameter names are the SD/LDM checkpoint keys."""
    _, params = jax_tiny()
    port = port_tiny()  # loads every model with strict=True
    module = port.swinir if model == "swinir" else getattr(port.cldm, model)
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    assert set(sd) == set(from_jax(params[model], model))
    back, orig = _flat(CONVERTERS[model](sd)), _flat(params[model])
    assert set(back) == set(orig)
    for key in orig:
        np.testing.assert_array_equal(back[key], orig[key], err_msg=key)


def _detector_variables(model):
    """Random full variables of the tiny detector (full widths, 6 classes)
    or of its MobileNetV3 body, and the port's module for them."""
    import __graft_entry__ as G
    import jax

    from edtr_tpu.models.mobilenetv3 import MobileNetV3 as JMobileNetV3
    from edtr_torch.models.faster_rcnn import fasterrcnn_mobilenet_v3_large_fpn
    from edtr_torch.models.mobilenetv3 import MobileNetV3

    x = jnp.zeros((1, 64, 64, 3))
    if model == "fasterrcnn":
        net = G._tiny_detnet(64)
        shapes = jax.eval_shape(lambda k: net.init({"params": k}, x), jax.random.PRNGKey(0))
        port = fasterrcnn_mobilenet_v3_large_fpn(num_classes=6, device="cpu")
    else:
        net = JMobileNetV3()
        shapes = jax.eval_shape(lambda k: net.init(k, x, features=True), jax.random.PRNGKey(0))
        port = MobileNetV3()
    return random_tree(shapes, seed=21), port


@pytest.mark.parametrize("model", ["fasterrcnn", "mobilenetv3"])
def test_detector_bridge_round_trips_through_torchvision_keys(model):
    """JAX variables -> bridge -> the port (strict load) -> its state_dict
    -> ``convert_fasterrcnn_mobilenet`` / ``convert_mobilenetv3`` -> the
    same variables, BatchNorm statistics and fc6's row order included: the
    port's names are torchvision's."""
    variables, port = _detector_variables(model)
    sd = from_jax(variables, model)
    port.load_state_dict(sd, strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    if model == "fasterrcnn":
        assert "backbone.body.features.4.block.2.fc1.weight" in sd  # the SE layer
        assert sd["backbone.body.features.4.block.1.0.weight"].shape == (72, 1, 5, 5)
        assert sd["backbone.body.features.16.1.running_var"].shape == (960,)
        back = C.convert_fasterrcnn_mobilenet(sd)
    else:
        back = C.convert_mobilenetv3(sd, with_classifier=False)
    back, orig = _flat(back), _flat(variables)
    assert set(back) == set(orig)
    for key in orig:
        np.testing.assert_array_equal(back[key], orig[key], err_msg=key)


def _tiny_swinir(lane_pad):
    return JSwinIR(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4, mlp_ratio=2,
                   sf=8, upsampler="nearest+conv", unshuffle=True, unshuffle_scale=8,
                   lane_pad=lane_pad)


def test_strip_undoes_pad_swinir_lanes():
    _, params = jax_tiny()
    p = params["swinir"]
    stripped = _flat(strip_swinir_lanes(C.pad_swinir_lanes(p, lane_pad=4, heads=2),
                                        lane_pad=4, heads=2))
    orig = _flat(p)
    assert set(stripped) == set(orig)
    for key in orig:
        np.testing.assert_array_equal(stripped[key], orig[key], err_msg=key)


def test_stripped_tree_restores_like_the_padded_jax_net():
    _, params = jax_tiny()
    padded = C.pad_swinir_lanes(params["swinir"], lane_pad=4, heads=2)
    lq = np.random.default_rng(9).random((1, IMAGE, IMAGE, 3)).astype(np.float32)
    out_j = _tiny_swinir(4).apply({"params": padded}, jnp.asarray(lq))
    port = SwinIR(**flagship_configs(tiny=True)["swinir"])
    port.load_state_dict(from_jax(strip_swinir_lanes(padded, 4, 2), "swinir"), strict=True)
    with torch.no_grad():
        out_t = port(nchw(lq))
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), rtol=3e-3, atol=3e-3)


def test_port_imports_no_jax():
    """edtr_torch (every module) and chip_smoke.py load no jax, flax, optax
    or edtr_tpu: the port runs on a card host without them."""
    banned = ("jax", "flax", "optax", "edtr_tpu")
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in banned], names
    code = (
        "import importlib, pkgutil, sys\n"
        "import edtr_torch\n"
        "for m in pkgutil.walk_packages(edtr_torch.__path__, 'edtr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]\n"
        "print(sorted(m for m in sys.modules if m.startswith('edtr_torch.')))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    for mod in ("edtr_torch.pipeline", "edtr_torch.models.unet", "edtr_torch.models.swinir",
                "edtr_torch.ops.flash_attention", "edtr_torch.ops.gn_conv",
                "edtr_torch.ops.ln_matmul", "edtr_torch.ops.geglu",
                "edtr_torch.ops.window_attention", "edtr_torch.ops.swin_block",
                "edtr_torch.train.edtr_step", "edtr_torch.utils.convert",
                "edtr_torch.ops.boxes", "edtr_torch.ops.roi_align",
                "edtr_torch.data.tokenizer", "edtr_torch.models.clip",
                "edtr_torch.models.mobilenetv3", "edtr_torch.models.faster_rcnn",
                "edtr_torch.device", "edtr_torch.models.resnet",
                "edtr_torch.models.deeplabv3", "edtr_torch.train.recipes",
                "edtr_torch.train.tasks", "edtr_torch.config",
                "edtr_torch.diffusion.schedule", "edtr_torch.demo", "edtr_torch.models.lpips",
                "edtr_torch.utils.tiling", "edtr_torch.utils.checkpoint",
                "edtr_torch.utils.image", "edtr_torch.data.file_backend",
                "edtr_torch.data.augment", "edtr_torch.data.degradation",
                "edtr_torch.data.diffjpeg", "edtr_torch.data.realesrgan",
                "edtr_torch.data.voc", "edtr_torch.data.coco_mask", "edtr_torch.data.coco",
                "edtr_torch.data.classification", "edtr_torch.data.segmentation",
                "edtr_torch.data.detection", "edtr_torch.data.detection_coco",
                "edtr_torch.data.detection_cocov2", "edtr_torch.data.val_data_generation",
                "edtr_torch.data.synthetic", "edtr_torch.utils.metrics",
                "edtr_torch.utils.coco_eval", "edtr_torch.train.harness",
                "edtr_torch.train.runner", "edtr_torch.train.valhooks", "edtr_torch.cli",
                "edtr_torch.utils.logging_utils", "edtr_torch.utils.profiling",
                "edtr_torch.utils.benchtime", "edtr_torch.data.preprocess"):
        assert mod in res.stdout


def test_no_card_and_no_device_raises(monkeypatch):
    from edtr_torch.pipeline import EDTRPipeline, build_flagship

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flagship(tiny=True)
    port = port_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EDTRPipeline(port.swinir, port.cldm, port.diffusion)
