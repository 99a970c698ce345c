"""Building the port from the repo's configs (``edtr_torch.config``,
``edtr_torch.pipeline.build_pipeline_from_config``) and the diffusion
tables under JAX's signature (``edtr_torch.diffusion.schedule``), on the
CPU:

* every YAML of ``configs/**`` loads (``yaml.safe_load``, as JAX's
  ``load_config``) into the same tree as JAX's;
* every ``007_edtr-s4`` config builds, on ``torch.device("meta")`` (full
  width, no memory), the parameter names and shapes of
  ``build_flagship(train=)``, the EDTR-s4 timesteps, and in the train
  configs the decoder's and the UNet's recompute;
* a config without SwinIR pre-restores as the identity (the tiny
  flagship's dims on the CPU);
* the cls/seg task nets and the ResNet50-FPN-v2 detector (the demo and
  the COCO train configs) instantiate through ``REGISTRY`` with JAX's
  parameter set (by ``from_jax`` of JAX's tree); a target the port lacks
  raises ``NotPortedError`` naming it, and no path reaches ``edtr_tpu``;
* ``make_beta_schedule`` (four schedules) and the configs' diffusion
  tables equal JAX's.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edtr_tpu import config as JC
from edtr_tpu.diffusion import schedule as JSched
from edtr_torch import config as TC
from edtr_torch.diffusion import schedule as TSched
from edtr_torch.models.deeplabv3 import DeepLabV3MobileNet
from edtr_torch.models.faster_rcnn import FasterRCNN
from edtr_torch.models.resnet import ResNet
from edtr_torch.pipeline import build_flagship, build_pipeline_from_config, flagship_configs
from edtr_torch.utils.convert import from_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("configs/**/*.yaml"))
EDTR_S4 = [c for c in CONFIGS if c.endswith("007_edtr-s4.yaml")]


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_loads(path):
    cfg = TC.load_config(str(ROOT / path))
    want = yaml.safe_load((ROOT / path).read_text())
    assert cfg.to_dict() == want == JC.load_config(str(ROOT / path)).to_dict()
    assert isinstance(cfg.model if "model" in cfg else cfg, TC.Config)


def _names_shapes(module) -> dict:
    return {n: tuple(t.shape) for n, t in module.state_dict().items()}


@pytest.fixture(scope="module")
def flagship_shapes():
    return {train: _names_shapes(build_flagship(device="meta", train=train))
            for train in (False, True)}


@pytest.mark.parametrize("path", EDTR_S4)
def test_edtr_s4_config_builds_the_flagship(path, flagship_shapes):
    cfg = TC.load_config(str(ROOT / path))
    train = "train" in cfg
    pipe = build_pipeline_from_config(cfg, dtype=torch.bfloat16, device="meta")
    assert _names_shapes(pipe) == flagship_shapes[train]
    assert pipe.device.type == "meta" and pipe.swinir is not None
    assert pipe.start_timestep == 200 and pipe.used_timesteps == [50, 100, 150, 200]
    assert pipe.cldm.unet.use_checkpoint and pipe.cldm.controlnet.use_checkpoint
    assert pipe.cldm.vae.decoder.mid.use_checkpoint == train
    assert pipe.cldm.vae.train_decoder


def _tiny_config(swinir: bool) -> dict:
    c = flagship_configs(tiny=True)
    model = dict(pre_restoration=swinir,
                 cldm=dict(target="model.cldm.ControlLDM", params=dict(
                     latent_scale_factor=0.18215, unet_cfg=c["unet"], vae_cfg=c["vae"],
                     clip_cfg=c["clip"], controlnet_cfg=c["controlnet"])),
                 diffusion=dict(target="model.gaussian_diffusion.Diffusion",
                                params=dict(linear_start=0.00085, linear_end=0.012,
                                            timesteps=1000)))
    model["swinir"] = dict(target="model.swinir.SwinIR", params=dict(
        c["swinir"], upsampler="nearest+conv", unshuffle=True, unshuffle_scale=8))
    return dict(model=model, test=dict(start_timestep=100, num_timesteps=2))


def test_config_without_swinir_pre_restores_as_identity():
    torch.manual_seed(0)
    pipe = build_pipeline_from_config(TC.Config(_tiny_config(swinir=False)), device="cpu")
    assert pipe.swinir is None and not any(n.startswith("swinir.") for n in pipe.state_dict())
    assert pipe.used_timesteps == [50, 100]
    with_swinir = build_pipeline_from_config(TC.Config(_tiny_config(swinir=True)),
                                             device="cpu")
    assert set(_names_shapes(with_swinir)) - set(_names_shapes(pipe)) == {
        n for n in with_swinir.state_dict() if n.startswith("swinir.")}
    g = torch.Generator().manual_seed(1)
    lq = torch.rand((1, 64, 64, 3), generator=g)
    out = pipe.restore(lq, torch.randn((1, 77, 64), generator=g), generator=g)
    assert torch.equal(out["pre_restored"], lq)
    assert out["restored"].shape == lq.shape and bool(torch.isfinite(out["restored"]).all())


def _jax_names_shapes(net, kind: str, side: int = 64) -> dict:
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return {n: tuple(v.shape) for n, v in from_jax(zeros, kind).items()}


@pytest.mark.parametrize("path,node,cls,kind", [
    ("configs/cls/cub200/train/007_edtr-s4.yaml", "clsnet", ResNet, "resnet"),
    ("configs/cls/cub200/train/007_edtr-s4.yaml", "teacher_clsnet", ResNet, "resnet"),
    ("configs/seg/voc2012/train/007_edtr-s4.yaml", "segnet", DeepLabV3MobileNet, "deeplabv3"),
    ("configs/seg/voc2012/test/007_edtr-s4.yaml", "segnet", DeepLabV3MobileNet, "deeplabv3"),
])
def test_tasknets_instantiate_through_the_registry(path, node, cls, kind):
    cfg = TC.load_config(str(ROOT / path))
    net = TC.instantiate_from_config(cfg.model[node], dtype=torch.bfloat16, device="meta")
    assert isinstance(net, cls) and net.dtype == torch.bfloat16
    want = _jax_names_shapes(JC.instantiate_from_config(cfg.model[node]), kind)
    assert _names_shapes(net) == want


@functools.lru_cache(maxsize=1)
def _jax_v2_names_shapes() -> dict:
    """The parameter names and shapes of JAX's v2 detector from the demo
    config, under the bridge's names (its transform shrunk: the shapes do
    not depend on it)."""
    cfg = JC.load_config(str(ROOT / "configs/det/demo.yaml"))
    det = JC.instantiate_from_config(cfg.model.detnet).clone(min_size=64, max_size=128)
    shapes = jax.eval_shape(lambda k: det.init({"params": k}, jnp.zeros((1, 64, 64, 3))),
                            jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return {n: tuple(v.shape) for n, v in from_jax(zeros, "fasterrcnn").items()}


@pytest.mark.parametrize("path,node", [
    ("configs/det/demo.yaml", "detnet"),
    ("configs/det/coco/train/001_edtr-s4-r50.yaml", "detnet"),
    ("configs/det/coco/train/001_edtr-s4-r50.yaml", "teacher_detnet"),
    ("configs/det/coco/train/101_edtr-s4-r50v2.yaml", "detnet"),
    ("configs/det/coco/train/101_edtr-s4-r50v2.yaml", "teacher_detnet"),
])
def test_v2_detector_instantiates_through_the_registry(path, node):
    """Every config naming ``fasterrcnn_resnet50_fpn_v2`` builds it (its
    ``weights_backbone`` accepted, 91 classes, norms not frozen) with JAX's
    parameter set."""
    cfg = TC.load_config(str(ROOT / path))
    assert cfg.model[node].target == "model.faster_rcnn.fasterrcnn_resnet50_fpn_v2"
    net = TC.instantiate_from_config(cfg.model[node], dtype=torch.bfloat16, device="meta")
    assert isinstance(net, FasterRCNN) and net.backbone_type == "resnet50_fpn_v2"
    assert net.num_classes == 91 and not net.norm_frozen and net.dtype == torch.bfloat16
    assert _names_shapes(net) == _jax_v2_names_shapes()


@pytest.mark.parametrize("target", [
    "model.bsrnet.RRDBNet",
    "model.skunet.SKUNet",
    "model.edsr.EDSR",
    "model.scunet.SCUNet",
    "edtr_tpu.models.resnet.ResNet",
])
def test_targets_the_port_lacks_raise(target):
    with pytest.raises(TC.NotPortedError, match=target.replace(".", r"\.")):
        TC.instantiate_from_config(dict(target=target, params={}))


def test_every_config_target_is_registered_or_not_ported():
    """Each target the configs name maps to an importable port object or
    is marked not ported; those that map resolve inside edtr_torch."""
    targets = set()
    for path in CONFIGS:
        def walk(node):
            if isinstance(node, dict):
                if "target" in node:
                    targets.add(node["target"])
                for v in node.values():
                    walk(v)
        walk(yaml.safe_load((ROOT / path).read_text()))
    assert targets <= set(TC.REGISTRY)
    for target in sorted(targets):
        if TC.REGISTRY[target] is None:
            with pytest.raises(TC.NotPortedError):
                TC.get_obj_from_str(target)
        else:
            assert TC.get_obj_from_str(target).__module__.startswith("edtr_torch."), target


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_match_jax(schedule):
    kw = dict(linear_start=0.00085, linear_end=0.012)
    np.testing.assert_array_equal(TSched.make_beta_schedule(schedule, 1000, **kw),
                                  JSched.make_beta_schedule(schedule, 1000, **kw))
    got = TSched.Diffusion.create(1000, beta_schedule=schedule, **kw)
    want = JSched.Diffusion.create(1000, beta_schedule=schedule, **kw)
    for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert len(got.betas) == want.num_timesteps == 1000


def test_config_diffusion_matches_jax():
    cfg = TC.load_config(str(ROOT / EDTR_S4[0]))
    got = TC.instantiate_from_config(cfg.model.diffusion, device="cpu")
    want = JC.instantiate_from_config(JC.load_config(str(ROOT / EDTR_S4[0])).model.diffusion)
    np.testing.assert_array_equal(got.betas.astype(np.float32), np.asarray(want.betas))
    np.testing.assert_array_equal(got.sqrt_alphas_cumprod.numpy(),
                                  np.asarray(want.sqrt_alphas_cumprod))
    assert got.parameterization == want.parameterization == "eps"


def _data_nodes():
    """(config, node) of every dataset, transform and backend target the
    configs name."""
    out = []
    for path in CONFIGS:
        def walk(node):
            if isinstance(node, dict):
                if str(node.get("target", "")).startswith("datasets."):
                    out.append((path, node))
                for v in node.values():
                    walk(v)
        walk(yaml.safe_load((ROOT / path).read_text()))
    return out


DATA_TARGETS = sorted({n["target"] for _, n in _data_nodes()})


@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    """Synthetic stand-ins for the configs' roots."""
    from edtr_torch.data import synthetic as S

    base = tmp_path_factory.mktemp("roots")
    coco = str(base / "COCO")
    S.write_coco_tree(coco, n=3, split="train", seed=1)
    S.write_coco_tree(coco, n=3, split="val", seed=2)
    roots = {"datasets/source/VOC": S.write_voc_tree(str(base / "VOC"), n=3, seed=3),
             "datasets/source/COCO": coco,
             "datasets/source/CUB200/train": S.write_image_folder(str(base / "CUB"), seed=4),
             "datasets/source/CUB200/val-deg": str(base / "CUBval"),
             None: str(base / "real")}
    for sub in ("gt", "lq"):
        S.write_image_folder(str(base / "CUBval" / sub), seed=5)
    S.write_image_folder(str(base / "realtmp"), n_classes=1, seed=6)
    (base / "realtmp" / "000.class_0").rename(base / "real")
    return roots


@pytest.mark.parametrize("target", DATA_TARGETS)
def test_data_targets_build_the_port_on_a_synthetic_root(target, data_roots):
    """Every dataset, transform and backend node of ``configs/**`` builds the
    port's class through ``REGISTRY`` with its params (the root replaced by
    a synthetic tree); each dataset target's first node loads an item."""
    nodes = [n for _, n in _data_nodes() if n["target"] == target]
    assert nodes and TC.REGISTRY[target].startswith("edtr_torch.data.")
    for i, node in enumerate(nodes):
        params = dict(node.get("params") or {})
        if "root" in params:
            params["root"] = data_roots[params["root"]]
        extra = {"device": "cpu"} if target.endswith("BatchTransform") else {}
        obj = TC.instantiate_from_config(dict(target=target, params=params), **extra)
        assert type(obj).__module__ == TC.REGISTRY[target].rsplit(".", 1)[0]
        assert type(obj).__name__ == target.rsplit(".", 1)[1]
        if i == 0 and ("Degraded" in target or "Realworld" in target):
            item = obj[0]
            assert isinstance(item[0], np.ndarray) and item[0].dtype == np.float32
