"""The port's entry points and runner against ``edtr_tpu``'s: the 30
``main/`` scripts and ``script.sh`` through ``python -m edtr_torch.cli``,
the loops' schedule and batches, building the models from a config and an
SD2.1 checkpoint, each runner function once in ``--debug`` on the CPU, and
the JAX faults the port does not copy (ROADMAP Queue 3)."""

import glob
import importlib.util
import os
import re
import shlex
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import edtr_tpu.train.runner as JR
from edtr_torch import cli
from edtr_torch.data import synthetic
from edtr_torch.train import runner as PR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER_FNS = ("task_eval", "diffbir_eval", "edtr_eval_task", "swinir_eval", "task_train",
              "diffbir_train", "edtr_train_task", "edtr_eval", "edtr_train")
SCRIPTS = sorted((p.split(os.sep)[-2], os.path.basename(p)[:-3])
                 for p in glob.glob(os.path.join(ROOT, "main", "*", "*.py")))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the scripts and script.sh ----------------------------------------------------------

def _record(monkeypatch, module, calls):
    for fn in RUNNER_FNS:
        monkeypatch.setattr(module, fn, lambda *a, _fn=fn, **k: calls.append((_fn, a, k)))


def _run_jax_script(task, name, args, monkeypatch):
    """(exit code, calls) of JAX's ``main/{task}/{name}.py`` with ``args``,
    its runner functions recording."""
    calls = []
    _record(monkeypatch, JR, calls)
    path = os.path.join(ROOT, "main", task, name + ".py")
    spec = importlib.util.spec_from_file_location(f"_main_{task}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path] + list(args))
    try:
        mod.main()
        code = 0
    except SystemExit as e:
        code = e.code
    return code, calls


def _run_port(task, name, args, monkeypatch):
    calls = []
    _record(monkeypatch, PR, calls)
    try:
        cli.main([task, name] + list(args))
        code = 0
    except SystemExit as e:
        code = e.code
    return code, calls


def test_the_cli_has_every_script():
    assert len(SCRIPTS) == 30
    assert sorted((t, n) for t, scripts in cli.SCRIPTS.items() for n in scripts) == SCRIPTS


@pytest.mark.parametrize("task,name", SCRIPTS)
def test_script_calls_the_runner_as_jax(task, name, monkeypatch, capsys):
    """JAX's script and ``python -m edtr_torch.cli {task} {name}`` call the
    same runner function with the same arguments, with and without
    ``--debug``, ``--seed 0`` (JAX's ``seed or 231``) and each extra flag;
    a flag the script lacks exits 2 on both sides."""
    flags = [a for a in ("--save-img", "--calc-fd")
             if a in _read(os.path.join(ROOT, "main", task, name + ".py"))]
    assert flags == list(cli.SCRIPTS[task][name].flags)
    for args in (["--config", "c.yaml"], ["--config", "c.yaml", "--debug", "--seed", "0"],
                 ["--config", "c.yaml", "--seed", "5"] + flags, ["--config", "c.yaml", "--bogus"]):
        jax_out = _run_jax_script(task, name, args, monkeypatch)
        port_out = _run_port(task, name, args, monkeypatch)
        assert port_out == jax_out, args
        assert jax_out[0] == (2 if "--bogus" in args else 0)
    capsys.readouterr()


def _script_sh():
    lines = []
    for line in _read(os.path.join(ROOT, "script.sh")).splitlines():
        line = line.split("#")[0].strip()
        if line.startswith("python main/"):
            words = shlex.split(line)
            task, name = words[1].split("/")[1], os.path.basename(words[1])[:-3]
            lines.append((task, name, tuple(words[2:])))
    return lines


SCRIPT_SH = _script_sh()


@pytest.mark.parametrize("task,name,args", SCRIPT_SH,
                         ids=[f"{t}-{n}-{a[1].split('/')[-1]}" for t, n, a in SCRIPT_SH])
def test_script_sh_parses_as_in_jax(task, name, args, monkeypatch, capsys):
    """Each ``script.sh`` line runs (or exits 2) in the port as in JAX:
    ``main/cls/test_edtr.py`` has no ``--save-img``, so that line exits 2 on
    both sides (ROADMAP Queue 3)."""
    jax_out = _run_jax_script(task, name, args, monkeypatch)
    assert _run_port(task, name, args, monkeypatch) == jax_out
    fault = (task, name) == ("cls", "test_edtr") and "--save-img" in args
    assert jax_out[0] == (2 if fault else 0)
    capsys.readouterr()


# -- tiny configs ------------------------------------------------------------------------

TINY_UNET = dict(use_checkpoint=False, in_channels=4, out_channels=4, model_channels=32,
                 attention_resolutions=[1], num_res_blocks=1, channel_mult=[1, 2],
                 num_head_channels=16, transformer_depth=1, context_dim=64,
                 use_linear_in_transformer=True)
TINY_DET = dict(num_classes=21, min_size=64, max_size=128, rpn_pre_nms_top_n_train=64,
                rpn_post_nms_top_n_train=32, rpn_pre_nms_top_n_test=64,
                rpn_post_nms_top_n_test=32, rpn_batch_size_per_image=32,
                box_batch_size_per_image=16, box_detections_per_img=8)
SIZE = 64


def shrink(cfg: dict, size: int = SIZE) -> dict:
    """A config (a dict) at the tiny flagship's widths (a 49408-token text
    tower, so the empty prompt encodes), small detectors and 3-class
    classifiers, its datasets' images at ``size``; in place, idempotent."""
    m = cfg["model"]
    if "swinir" in m:
        m["swinir"]["params"].update(embed_dim=32, depths=[2], num_heads=[2], window_size=4)
    if "cldm" in m:
        p = m["cldm"]["params"]
        p["unet_cfg"] = dict(TINY_UNET)
        p["controlnet_cfg"] = dict({k: v for k, v in TINY_UNET.items() if k != "out_channels"},
                                   hint_channels=4)
        p["vae_cfg"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2], num_res_blocks=1)
        p["clip_cfg"]["text_cfg"] = dict(context_length=77, vocab_size=49408, width=64, heads=4,
                                         layers=2)
    for key in ("detnet", "teacher_detnet"):
        if key in m:
            m[key]["params"].update(TINY_DET)
    for key in ("clsnet", "teacher_clsnet"):
        if key in m:
            m[key]["params"].update(num_classes=3)
    for node in cfg["dataset"].values():
        if isinstance(node, dict) and "params" in node:
            node["params"].update({k: size for k in ("gt_size", "out_size")
                                   if k in node["params"]})
    return cfg


def tiny_config(path, root, exp, size=SIZE, **train):
    """The repo's config at ``path`` shrunk (:func:`shrink`), its datasets on
    the synthetic tree ``root``, one process with no workers, the batch 2;
    written next to ``exp``, its experiment directory. ``train`` updates
    the train (or test) section."""
    cfg = shrink(yaml.safe_load(_read(os.path.join(ROOT, path))), size)
    for node in cfg["dataset"].values():
        if isinstance(node, dict) and "params" in node:
            sub = node["params"]["root"].split("CUB200")
            node["params"]["root"] = root + (os.path.join("/CUB200", sub[1].strip("/"))
                                             if len(sub) > 1 else "")
    for sec in ("train", "test"):
        if sec in cfg:
            cfg[sec].update(exp_dir=str(exp), batch_size=2, num_workers=0, **train)
    out = str(exp) + ".yaml"
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A 4-image VOC tree with its degraded det and seg val pairs, and a
    3-class CUB-like folder with its train split and paired val set."""
    from edtr_torch.data.val_data_generation import generate

    root = str(tmp_path_factory.mktemp("data"))
    synthetic.write_voc_tree(root, n=4, size_range=(72, 96), seed=3)
    synthetic.write_image_folder(os.path.join(root, "CUB200", "train"), n_classes=3,
                                 per_class=2, size_range=(72, 96), seed=4)
    for path, task in (("configs/det/voc2012/train/002_swinir-pre.yaml", "det"),
                       ("configs/seg/voc2012/train/002_swinir-pre.yaml", "seg")):
        generate(tiny_config(path, root, os.path.join(root, f"gen_{task}")), task, seed=231)
    # the cls pairs by class folder (gt and lq the train images at 64²)
    for d, _, files in os.walk(os.path.join(root, "CUB200", "train")):
        for f in files:
            with Image.open(os.path.join(d, f)) as im:
                img = im.convert("RGB").resize((SIZE, SIZE))
            for sub in ("gt", "lq"):
                out = os.path.join(root, "CUB200", "val-deg", sub, os.path.basename(d))
                os.makedirs(out, exist_ok=True)
                img.save(os.path.join(out, f[:-4] + ".png"))
    return root


# -- the loops' schedule -----------------------------------------------------------------

def _event(events, kind, *rest):
    events.append((kind,) + rest)


class _Logger:
    def __init__(self, events):
        self.events = events

    def __call__(self, msg, level="info"):
        head = msg.split(":")[0]
        if head.startswith(("step ", "val @", "checkpoints saved", "image grid saved")):
            self.events.append(("log", head))


def _env(real, events):
    def prepare(*a, **k):
        exp_dir, ckpt_dir, img_dir, logger, writer = real(*a, **k)
        return exp_dir, ckpt_dir, img_dir, _Logger(events), None
    return prepare


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fake_jax_side(monkeypatch, events):
    """JAX's runner with every model, step, sample, save and validation a
    recorder: the loop, its data and its schedule run as they are."""
    import edtr_tpu.models.faster_rcnn as jfr
    import edtr_tpu.train as jtrain
    import edtr_tpu.train.edtr_step as jstep
    import edtr_tpu.train.recipes  # noqa: F401  (the package attribute the patch replaces)
    from edtr_tpu.train import valhooks as JV

    class State(types.SimpleNamespace):
        def replace(self, **k):
            return State(**{**vars(self), **k})

    pipe = types.SimpleNamespace(
        cldm=types.SimpleNamespace(encode_text=lambda p, prompts: jnp.zeros((1, 77, 4)),
                                   vae=types.SimpleNamespace(train_decoder=True)),
        pre_restore=lambda params, lq: lq)
    params = {"controlnet": 0, "vae": {"decoder": 0}, "swinir": 0}
    monkeypatch.setattr(JR, "prepare_environment", _env(JR.prepare_environment, events))
    monkeypatch.setattr(JR, "build_edtr_models", lambda cfg, dtype=None: (pipe, dict(params)))
    monkeypatch.setattr(JR, "build_detnet", lambda cfg, key, dtype=None: None)
    monkeypatch.setattr(JR, "init_detnet_params", lambda det, rng, image_size=512: 0)
    monkeypatch.setattr(jstep, "cast_frozen_bf16", lambda p, train_decoder: p)
    monkeypatch.setattr(jstep, "EDTRTrainState", types.SimpleNamespace(
        create=lambda pipe, params, **k: State(params=params, step=0, opt_edtr_state=0,
                                               opt_detnet_state=0)))

    def step_fn(state, batch, key):
        target = batch.get("targets", batch.get("target"))
        events.append(("step", _np(batch["gt"]), jax_tree_np(target)))
        return state.replace(step=state.step + 1), {"loss": jnp.float32(0)}

    monkeypatch.setattr(jstep, "make_edtr_train_step", lambda *a, **k: step_fn)
    monkeypatch.setattr(jstep, "make_edtr_sample_fn", lambda pipe: lambda p, lq, c, r: lq)
    monkeypatch.setattr(JR.ckpt, "save_submodules",
                        lambda d, p, step=None: _event(events, "save", step, sorted(p)))
    monkeypatch.setattr(JR.ckpt, "save_checkpoint", lambda path, tree: _event(events, "state"))
    monkeypatch.setattr(JV, "save_image_grid",
                        lambda d, step, rows: _event(events, "grid", step, sorted(rows)))
    monkeypatch.setattr(JV, "validate_detection", lambda *a, **k: _event(events, "val") or {})
    monkeypatch.setattr(JV, "validate_task", lambda *a, **k: _event(events, "val") or {})
    # task_train: the net, its init and the recipes' state and step
    real_inst = JR.instantiate_from_config

    def inst(node, **k):
        if node["target"].startswith("datasets."):
            return real_inst(node, **k)
        return types.SimpleNamespace(init=lambda rngs, x: {"params": {}})

    monkeypatch.setattr(JR, "instantiate_from_config", inst)
    monkeypatch.setattr(JR, "_task_apply_for", lambda task, net: (None, None))
    monkeypatch.setattr(jfr, "mask_detnet_tx", lambda tx, params: tx)
    monkeypatch.setattr(jtrain, "recipes", types.SimpleNamespace(
        SimpleTrainState=types.SimpleNamespace(
            create=lambda v, tx: State(step=0, params=v["params"], variables=v)),
        cosine_tx=lambda *a, **k: None,
        make_task_train_step=lambda *a, **k: step_fn))


def jax_tree_np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else _np(tree)


def _fake_port_side(monkeypatch, events):
    """The port's runner with the same recorders (its own names)."""
    class Module(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

    pipe = types.SimpleNamespace(
        cldm=types.SimpleNamespace(encode_text=lambda prompts: torch.zeros(1, 77, 4),
                                   vae=types.SimpleNamespace(train_decoder=True, decoder=0),
                                   controlnet=0),
        swinir=0, pre_restore=lambda x: x)
    monkeypatch.setattr(PR, "prepare_environment", _env(PR.prepare_environment, events))
    monkeypatch.setattr(PR, "build_edtr_models", lambda cfg, device=None: pipe)
    monkeypatch.setattr(PR, "build_detnet", lambda cfg, key, dtype=None, device=None: Module())
    monkeypatch.setattr(PR, "init_detnet_params", lambda det, seed: det)
    monkeypatch.setattr(PR, "cast_frozen_bf16", lambda *a: None)
    monkeypatch.setattr(PR, "EDTRTrainState", types.SimpleNamespace(
        create=lambda pipe, **k: types.SimpleNamespace(step=0)))

    def step_fn(state, batch, generator=None):
        target = batch.get("targets", batch.get("target"))
        events.append(("step", _np(batch["gt"]), jax_tree_np(target)))
        state.step += 1
        return {"loss": torch.zeros(())}

    monkeypatch.setattr(PR, "make_edtr_train_step", lambda *a, **k: step_fn)
    monkeypatch.setattr(PR, "make_edtr_sample_fn", lambda pipe: lambda lq, c, generator: lq)
    monkeypatch.setattr(PR.ckpt, "save_submodules",
                        lambda d, p, step=None: _event(events, "save", step, sorted(p)))
    monkeypatch.setattr(PR.ckpt, "save_checkpoint", lambda path, state: _event(events, "state"))
    monkeypatch.setattr(PR.V, "save_image_grid",
                        lambda d, step, rows: _event(events, "grid", step, sorted(rows)))
    monkeypatch.setattr(PR.V, "validate_detection", lambda *a, **k: _event(events, "val") or {})
    monkeypatch.setattr(PR.V, "validate_task", lambda *a, **k: _event(events, "val") or {})
    monkeypatch.setattr(PR, "task_apply_for", lambda task: (None, None))
    monkeypatch.setattr(PR, "R", types.SimpleNamespace(
        SimpleTrainState=types.SimpleNamespace(
            create=lambda module, tx: types.SimpleNamespace(step=0, module=module)),
        cosine_tx=lambda *a, **k: None, make_task_train_step=lambda *a, **k: step_fn))


def _same_events(a, b):
    assert [e[0] for e in a] == [e[0] for e in b]
    for x, y in zip(a, b):
        if x[0] == "step":
            np.testing.assert_array_equal(x[1], y[1])
            if isinstance(x[2], dict):
                assert x[2].keys() == y[2].keys()
                for k in x[2]:
                    np.testing.assert_array_equal(x[2][k], y[2][k].astype(x[2][k].dtype))
            else:
                np.testing.assert_array_equal(x[2], y[2])
        else:
            assert x == y


SCHEDULE = dict(log_every=2, ckpt_every=3, image_every=2, train_steps=6)


@pytest.mark.parametrize("debug", [True, False])
@pytest.mark.parametrize("fn,path,kw", [
    ("edtr_train", "configs/det/voc2012/train/007_edtr-s4.yaml", {}),
    ("task_train", "configs/cls/cub200/train/000_oracle.yaml", dict(task="cls", recipe="task")),
], ids=["edtr_train", "task_train"])
def test_loop_schedule_and_batches_equal_jax(fn, path, kw, debug, trees, tmp_path,
                                             monkeypatch):
    """With the models, steps, samples, saves and validations recording on
    both sides, the log / save / train-state / grid / val events come in
    JAX's order, in ``--debug`` and at ``log_every`` 2, ``ckpt_every`` 3,
    ``image_every`` 2, ``val_every`` 3 over 6 steps; every step gets JAX's
    gt and targets (the loader's order, the augmentation's draws). LQ is
    left out: JAX's CodeFormer draw is unseeded (ROADMAP Queue 3)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no event files
    out = {}
    for side, fake, run in (("jax", _fake_jax_side, JR), ("port", _fake_port_side, PR)):
        events = []
        with monkeypatch.context() as m:
            fake(m, events)
            cfg = tiny_config(path, trees, tmp_path / side, **SCHEDULE)
            with open(cfg) as f:
                c = yaml.safe_load(f)
            c["val"] = dict(val_every=3)
            c["train"]["aspect_ratio_group_factor"] = c["train"].get("aspect_ratio_group_factor",
                                                                     -1)
            with open(cfg, "w") as f:
                yaml.safe_dump(c, f)
            getattr(run, fn)(cfg, debug=debug, **kw, **({"device": "cpu"} if run is PR else {}))
        out[side] = events
    assert sum(e[0] == "step" for e in out["jax"]) == (2 if debug else 6)
    assert {e[0] for e in out["jax"]} >= {"log", "save", "grid", "val"}
    _same_events(out["jax"], out["port"])


# -- building the models --------------------------------------------------------------------

def _sd_checkpoint(pipe_t, g):
    """A synthetic SD2.1 state dict over the port's UNet, VAE and CLIP keys
    under SD's prefixes (the tower's last block and its projection too,
    which the penultimate layer leaves), numpy draws as torch tensors."""
    from edtr_torch.utils.checkpoint import SD_MODULE_MAP

    sd = {}
    for part, prefix in SD_MODULE_MAP.items():
        for k, v in getattr(pipe_t.cldm, part).state_dict().items():
            sd[prefix + k] = torch.from_numpy(g.standard_normal(v.shape).astype(np.float32))
    last = max(int(k.split(".")[4]) for k in sd if ".resblocks." in k)
    for k in [k for k in sd if f".resblocks.{last}." in k]:
        sd[k.replace(f".resblocks.{last}.", f".resblocks.{last + 1}.")] = sd[k] + 1
    sd["cond_stage_model.model.text_projection"] = torch.ones(64, 64)
    return sd


def test_build_edtr_models_equals_jax(trees, tmp_path, capsys):
    """From a synthetic SD2.1 ``.ckpt`` (and a SwinIR file), the port's
    ``build_edtr_models`` holds exactly ``from_jax`` of JAX's: the UNet, VAE
    and CLIP tower from SD's keys, the ControlNet from the UNet (the hint's
    input channels and every zero conv zero), the SwinIR; then with
    ``resume_cldm`` a ControlNet file, which both load. ``resume_decoder``:
    the port loads it, JAX's builds ignore it (ROADMAP Queue 3)."""
    from edtr_tpu.config import load_config as jax_load

    from edtr_torch.config import load_config
    from edtr_torch.utils.convert import from_jax

    PR.DTYPE, dtype = None, PR.DTYPE
    try:
        g = np.random.default_rng(11)
        cfg = tiny_config("configs/det/voc2012/test/007_edtr-s4.yaml", trees, tmp_path / "e")
        probe = PR.build_edtr_models(load_config(cfg), device="cpu")
        sd_path, sw_path, dec_path, cn_path = (str(tmp_path / n) for n in (
            "sd.ckpt", "swinir.pt", "decoder_last.pt", "controlnet_last.pt"))
        torch.save({"state_dict": _sd_checkpoint(probe, g)}, sd_path)
        for path, module in ((sw_path, probe.swinir), (dec_path, probe.cldm.vae.decoder),
                             (cn_path, probe.cldm.controlnet)):
            torch.save({k: torch.from_numpy(g.standard_normal(v.shape).astype(np.float32))
                        for k, v in module.state_dict().items()}, path)
        for resume_cldm in (None, cn_path):
            with open(cfg) as f:
                c = yaml.safe_load(f)
            c["test"].update(sd_path=sd_path, resume_swinir=sw_path, resume_decoder=dec_path,
                             resume_cldm=resume_cldm)
            with open(cfg, "w") as f:
                yaml.safe_dump(c, f)
            _, params = JR.build_edtr_models(jax_load(cfg))
            port = PR.build_edtr_models(load_config(cfg), device="cpu")
            for part, module in (("unet", port.cldm.unet), ("clip", port.cldm.clip),
                                 ("controlnet", port.cldm.controlnet), ("swinir", port.swinir)):
                want = from_jax(params[part], part)
                got = module.state_dict()
                assert want.keys() == got.keys(), part
                for k in want:
                    assert torch.equal(got[k], want[k]), (part, k)
            vae = from_jax(params["vae"], "vae")
            for k, v in port.cldm.vae.state_dict().items():
                dec = k.startswith("decoder.")
                assert torch.equal(v, vae[k]) != dec, k  # JAX's decoder is SD's
            loaded = torch.load(dec_path)
            assert all(torch.equal(v, loaded[k]) for k, v in
                       port.cldm.vae.decoder.state_dict().items())
            cn = port.cldm.controlnet.state_dict()
            if resume_cldm is None:
                first = cn["input_blocks.0.0.weight"]
                assert torch.equal(first[:, :4], port.cldm.unet.state_dict()[
                    "input_blocks.0.0.weight"]) and not first[:, 4:].any()
                assert not any(v.any() for k, v in cn.items()
                               if k.startswith(("zero_convs.", "middle_block_out.")))
            else:
                loaded = torch.load(cn_path)
                assert all(torch.equal(v, loaded[k]) for k, v in cn.items())
    finally:
        PR.DTYPE = dtype
    capsys.readouterr()


# -- each runner function once in --debug ------------------------------------------------

@pytest.fixture
def cpu_runner(monkeypatch):
    """The runner at the tiny sizes: fp32, detection padded to the images'
    64."""
    monkeypatch.setattr(PR, "DTYPE", None)
    monkeypatch.setattr(PR, "IMG_SIZE", SIZE)
    # the scalar writer writes TensorBoard only where it imports: not here
    # (importing it loads TensorFlow, ~10 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# edtr_train runs in --debug through the CLI in
# tests/test_torch_chip_smoke.py's rehearsal of the runner phase
RUNS = [
    ("task_train", "configs/det/voc2012/train/004_swinir-sr4ir.yaml",
     dict(task="det", recipe="sr4ir")),
    ("task_train", "configs/seg/voc2012/train/003_swinir.yaml", dict(task="seg", recipe="swinir")),
    ("task_train", "configs/cls/cub200/train/002_swinir-pre.yaml",
     dict(task="cls", recipe="swinir-pre")),
    ("edtr_train_task", "configs/seg/voc2012/train/007_edtr-s4.yaml", dict(task="seg")),
    ("diffbir_train", "configs/cls/cub200/train/005_diffbir.yaml", dict(task="cls")),
    ("task_eval", "configs/seg/voc2012/test/001_lq.yaml", dict(task="seg")),
    ("edtr_eval_task", "configs/cls/cub200/test/007_edtr-s4.yaml", dict(task="cls")),
    ("swinir_eval", "configs/seg/voc2012/test/004_swinir-sr4ir.yaml", dict(task="seg")),
    ("diffbir_eval", "configs/cls/cub200/test/005_diffbir.yaml", dict(task="cls", steps=4)),
    ("edtr_eval", "configs/det/voc2012/test/007_edtr-s4.yaml",
     dict(save_img=True, calc_fd=True)),
]


@pytest.mark.parametrize("fn,path,kw", RUNS, ids=[f"{r[0]}-{os.path.basename(r[1])[:-5]}"
                                                  for r in RUNS])
def test_runner_debug_run(fn, path, kw, trees, tmp_path, cpu_runner, capsys):
    """Each runner function from the repo's config at the tiny widths, on the
    CPU in ``--debug``: the losses finite, the blocks' outputs written (a
    training run's checkpoints, grid and val line; an evaluation's finite
    stats)."""
    cfg = tiny_config(path, trees, tmp_path / "exp", sample_steps=4)
    out = getattr(PR, fn)(cfg, debug=True, device="cpu", **kw)
    exp = tmp_path / "exp"
    if fn.endswith("_train") or fn == "edtr_train_task":
        log = (exp / "run.log").read_text()
        assert "step 2:" in log and "training done" in log and "nan" not in log.lower()
        assert len(list((exp / "images").glob("step_*.png"))) == 2
        ckpts = sorted(os.listdir(exp / "checkpoints"))
        assert ckpts and all(re.match(r".+_(1|2|last)\.pt$", c) for c in ckpts)
        if "val" in yaml.safe_load(_read(cfg))["dataset"]:
            assert "val @ step 2" in log
    else:
        assert np.isfinite(out["psnr"]) and all(np.isfinite(v) for v in out.values())
    if fn == "edtr_eval":
        assert "feature_distance" in out and len(list((exp / "images").glob("0000*.png"))) == 4
    capsys.readouterr()


# -- JAX's faults --------------------------------------------------------------------------

def test_det_eval_of_oracle_configs_raises_keyerror_in_jax_not_ported_in_the_port():
    """``main/det/test_det.py`` passes ``000_oracle`` / ``001_lq`` (no
    ``cldm``) to ``edtr_eval``: JAX raises ``KeyError: 'cldm'``, the port
    ``NotPortedError`` naming the Queue 3 entry."""
    from edtr_torch.config import NotPortedError

    for name in ("000_oracle", "001_lq"):
        cfg = os.path.join(ROOT, "configs/det/voc2012/test", name + ".yaml")
        with pytest.raises(KeyError, match="cldm"):
            JR.edtr_eval(cfg, debug=True)
        with pytest.raises(NotPortedError, match="Queue 3"):
            PR.edtr_eval(cfg, debug=True, device="cpu")


@pytest.mark.parametrize("fn", ["swinir_eval", "diffbir_eval"])
def test_restore_eval_of_det_raises_keyerror_in_jax_not_ported_in_the_port(fn):
    """``main/det/test_swinir.py`` and ``test_diffbir.py`` pass
    ``task="det"`` to the restore-then-task loop, which has no detection
    branch: JAX's ``KeyError: 'det'``, the port's ``NotPortedError``."""
    from edtr_torch.config import NotPortedError

    cfg = os.path.join(ROOT, "configs/det/voc2012/test",
                       ("004_swinir-sr4ir" if fn == "swinir_eval" else "005_diffbir") + ".yaml")
    with pytest.raises(KeyError, match="det"):
        getattr(JR, fn)(cfg, task="det", debug=True)
    with pytest.raises(NotPortedError, match="Queue 3"):
        getattr(PR, fn)(cfg, task="det", debug=True, device="cpu")


def test_config_learning_rates_are_strings_jax_fails_on_them():
    """The configs write learning rates as ``1e-4``, which YAML reads as a
    string: JAX's runner passes it to ``cosine_tx``, which raises
    ``TypeError``; the port's runner reads a float."""
    from edtr_tpu.config import load_config as jax_load
    from edtr_tpu.train.recipes import cosine_tx as jax_cosine_tx

    from edtr_torch.config import load_config
    from edtr_torch.train.recipes import cosine_tx

    path = os.path.join(ROOT, "configs/det/voc2012/train/007_edtr-s4.yaml")
    lr = jax_load(path)["train"]["learning_rate_edtr"]
    assert lr == "1e-4"
    with pytest.raises(TypeError):
        jax_cosine_tx("adamw", lr, 10)
    got = PR._lr(load_config(path)["train"], "learning_rate_edtr", 1.0)
    assert got == 1e-4
    cosine_tx("adamw", got, 10)([torch.nn.Parameter(torch.zeros(1))])


def test_an_empty_epoch_raises(trees, tmp_path, cpu_runner):
    """A dataset smaller than the grouped batch gives no batch: the port
    raises where JAX's loop would spin forever."""
    cfg = tiny_config("configs/det/voc2012/train/000_oracle.yaml", trees, tmp_path / "e")
    with open(cfg) as f:
        c = yaml.safe_load(f)
    c["train"]["batch_size"] = 8
    with open(cfg, "w") as f:
        yaml.safe_dump(c, f)
    with pytest.raises(ValueError, match="no batch"):
        PR.task_train(cfg, task="det", debug=True, device="cpu")


def test_swinir_pre_configs_name_no_task_net_jax_raises(trees, tmp_path, cpu_runner, capsys):
    """The SwinIR-pre configs name no task net: JAX's ``task_train`` builds
    one for every recipe and raises ``KeyError``; the port trains the
    SwinIR alone."""
    for task, path in (("cls", "configs/cls/cub200/train/002_swinir-pre.yaml"),
                       ("det", "configs/det/voc2012/train/002_swinir-pre.yaml")):
        cfg = tiny_config(path, trees, tmp_path / f"jax_{task}")
        with pytest.raises(KeyError, match=PR.NET_KEYS[task]):
            JR.task_train(cfg, task=task, recipe="swinir-pre", debug=True)
    sw_state = PR.task_train(cfg, task="det", recipe="swinir-pre", debug=True, device="cpu")
    assert sw_state.step == 2 and sw_state.module is not None
    capsys.readouterr()
