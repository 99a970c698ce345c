"""The port's infrastructure against ``edtr_tpu``'s: checkpoints (the train
state, file names, key diffs), logging outputs, profiling, the dataset
preprocessing and the validation hooks."""

import os
import sys
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- checkpoints -------------------------------------------------------------------

def _train_state(seed: int):
    """A tiny EDTR train state with both optimizers (a ResNet-18 in the
    task-net slot, its teacher a copy) after two updates from seeded
    gradients, so every optimizer and schedule holds state."""
    import copy

    from edtr_torch.models.layers import randomize_
    from edtr_torch.models.resnet import resnet
    from edtr_torch.pipeline import build_flagship
    from edtr_torch.train.edtr_step import EDTRTrainState

    g = torch.Generator().manual_seed(seed)
    pipe = randomize_(build_flagship(tiny=True, dtype=None, device="cpu"), g)
    net = randomize_(resnet(type=18, num_classes=3, device="cpu"), g)
    state = EDTRTrainState.create(pipe, train_steps=10, detnet=net,
                                  teacher_detnet=copy.deepcopy(net))
    for _ in range(2):
        for opt in (state.tx_edtr, state.tx_detnet):
            for group in opt.param_groups:
                for p in group["params"]:
                    p.grad = torch.randn(p.shape, generator=g)
            opt.step()
        state.schedule.step()
        state.schedule_detnet.step()
        state.step += 1
    return state


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_train_state_round_trips_bit_identical(tmp_path, monkeypatch):
    """``save_checkpoint`` then ``restore_checkpoint`` into a state built
    from other weights gives back every parameter, buffer, optimizer and
    schedule state and the step exactly (``weights_only`` load); a save
    cut off midway leaves the last good file."""
    saved = _train_state(0)
    path = str(tmp_path / "trainstate_last.pt")
    ckpt.save_checkpoint(path, saved)
    fresh = _train_state(1)
    assert not _same(fresh.pipe.state_dict(), saved.pipe.state_dict())
    ckpt.restore_checkpoint(path, fresh)
    assert fresh.step == saved.step == 2
    for name in ("pipe", "detnet", "teacher_detnet", "tx_edtr", "tx_detnet", "schedule",
                 "schedule_detnet"):
        assert _same(getattr(fresh, name).state_dict(), getattr(saved, name).state_dict()), name
    assert fresh.tx_edtr.param_groups[0]["lr"] == saved.tx_edtr.param_groups[0]["lr"]

    def torn(obj, f, *a, **k):
        with open(f, "wb") as out:
            out.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(path, fresh)
    monkeypatch.undo()
    again = _train_state(2)
    ckpt.restore_checkpoint(path, again)
    assert _same(again.pipe.state_dict(), saved.pipe.state_dict())


def test_checkpoint_names_match_jax(tmp_path):
    """``save_submodules`` names each file as JAX names its orbax
    directory, with ``.pt``: ``{name}_{step}`` and ``{name}_last``; the
    files hold the modules' reference-keyed state dicts."""
    from edtr_tpu.utils import checkpoint as jckpt

    tree = {"controlnet": {"w": np.ones((2, 2), np.float32)}, "detnet": {"b": np.zeros(3)}}
    jckpt.save_submodules(str(tmp_path / "jax"), tree, step=7)
    mods = {"controlnet": torch.nn.Linear(2, 2), "detnet": torch.nn.Conv2d(1, 3, 1)}
    paths = ckpt.save_submodules(str(tmp_path / "port"), mods, step=7)
    port = sorted(os.listdir(tmp_path / "port"))
    assert [p[:-3] for p in port] == sorted(os.listdir(tmp_path / "jax"))
    assert all(p.endswith(".pt") for p in port) and len(paths) == 4
    sd = ckpt.load_torch_state_dict(str(tmp_path / "port" / "detnet_last.pt"))
    assert _same(sd, dict(mods["detnet"].state_dict()))


def test_load_network_reports_jax_key_diff(tmp_path, capsys):
    """The key diff in JAX's words, raised when strict and printed when not;
    ``module.`` and ``state_dict`` unwrapped; a directory refused."""
    from edtr_tpu.utils.checkpoint import _report_key_diff

    net = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 1))
    sd = {f"module.{k}": v for k, v in net.state_dict().items() if not k.startswith("1.")}
    sd["module.extra.weight"] = torch.ones(1)
    path = str(tmp_path / "net.pt")
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError) as port_err:
        ckpt.load_network(path, net, strict=True)
    with pytest.raises(ValueError) as jax_err:
        _report_key_diff({k: 0 for k in net.state_dict()},
                         {k[len("module."):]: 0 for k in sd}, strict=True)
    words = lambda msg: msg.split("(e.g.")[0] + msg.split("), ")[1].split("(e.g.")[0]
    assert words(str(port_err.value)) == words(str(jax_err.value))
    assert "2 missing" in str(port_err.value) and "1 unexpected" in str(port_err.value)
    other = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 1))
    ckpt.load_network(path, other, strict=False)
    assert "[load_network] checkpoint key diff: 2 missing" in capsys.readouterr().out
    assert torch.equal(other[0].weight, net[0].weight)
    with pytest.raises(IsADirectoryError):
        ckpt.load_network(str(tmp_path), net)


# -- logging ---------------------------------------------------------------------------

def test_logging_outputs_equal_jax(tmp_path, monkeypatch):
    """``scalars.jsonl`` lines, the archived config (its header too) and the
    experiment directories equal JAX's; the first log line names the
    device where JAX names the TPU."""
    from edtr_tpu.utils import logging_utils as JL

    from edtr_torch.config import load_config
    from edtr_torch.utils import logging_utils as PL

    monkeypatch.setattr(time, "strftime", lambda *a: "20260101_000000")
    monkeypatch.setattr("sys.argv", ["main/det/train_edtr.py", "--config", "c.yaml"])
    # both sides write TensorBoard only where it imports: here neither does
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    outs = {}
    for side, mod in (("jax", JL), ("port", PL)):
        exp = tmp_path / side
        cfg_path = tmp_path / side / "in" / "cfg.yaml"
        cfg_path.parent.mkdir(parents=True)
        cfg_path.write_text(f"train: {{seed: 5, exp_dir: {exp}}}\n")
        exp_dir, ckpt_dir, img_dir, logger, writer = mod.prepare_environment(
            load_config(str(cfg_path)), str(cfg_path))
        assert (ckpt_dir, img_dir) == (str(exp / "checkpoints"), str(exp / "images"))
        for step, v in enumerate((0.5, 1.25, float("inf"))):
            writer.add_scalar("train/loss", v, step)
        writer.close()
        outs[side] = ((exp / "logs" / "scalars.jsonl").read_text(),
                      (exp / "cfg.yaml").read_text().replace(str(exp), "EXP"))
        assert not list((exp / "logs").glob("events.*"))
        assert "experiment dir:" in (exp / "run.log").read_text()
    assert outs["port"] == outs["jax"]
    assert "on the cpu" in (tmp_path / "port" / "run.log").read_text()


def test_prepare_environment_refuses_many_processes(monkeypatch, tmp_path):
    from edtr_torch.config import Config, NotPortedError
    from edtr_torch.utils.logging_utils import prepare_environment

    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(NotPortedError, match="4 processes"):
        prepare_environment(Config({"train": {"exp_dir": str(tmp_path)}}))


# -- profiling ------------------------------------------------------------------------

def test_flops_estimate_equals_xla():
    """``flops_estimate`` of a matmul and an unpadded conv: ``FlopCounterMode``'s
    count equals XLA's cost analysis of the same op in JAX. A padded conv
    counts every tap of every output (XLA's leaves out the padded ones)."""
    from edtr_tpu.utils.profiling import flops_estimate as jax_flops

    from edtr_torch.utils.profiling import flops_estimate

    a, b = np.ones((64, 48), np.float32), np.ones((48, 32), np.float32)
    x, k = np.ones((2, 16, 16, 8), np.float32), np.ones((3, 3, 8, 12), np.float32)

    def jconv(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "VALID",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    tx, tk = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(k).permute(3, 2, 0, 1)
    conv = torch.nn.functional.conv2d
    cases = [(jnp.matmul, (a, b), torch.matmul, (torch.from_numpy(a), torch.from_numpy(b))),
             (jconv, (x, k), conv, (tx, tk))]
    for jfn, jargs, tfn, targs in cases:
        port = flops_estimate(tfn, *targs)
        assert port["flops"] == jax_flops(jfn, *jargs)["flops"]
        assert port["bytes_accessed"] is None and port["transcendentals"] is None
    padded = flops_estimate(lambda x, k: conv(x, k, padding=1), tx, tk)["flops"]
    assert padded == 2 * 2 * 16 * 16 * 12 * 8 * 9


def test_nan_guard_names_the_path():
    from edtr_torch.utils.profiling import nan_guard, timeit

    net = torch.nn.Sequential(torch.nn.Linear(2, 2))
    tree = {"ok": [torch.ones(2), torch.zeros(1, dtype=torch.long)], "net": net}
    nan_guard(tree, "state")
    with torch.no_grad():
        net[0].bias[1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"state\['net'\]\.0\.bias"):
        nan_guard(tree, "state")
    tree["ok"].append({"x": torch.tensor([1.0, float("inf")])})
    with pytest.raises(FloatingPointError, match=r"\['ok'\]\[2\]\['x'\]"):
        nan_guard({"ok": tree["ok"]})
    assert timeit(lambda: torch.ones(4).sum(), iters=2) >= 0


def test_timeit_chained_chains_through_the_first_float_argument():
    from edtr_torch.utils.benchtime import _dep_args, timeit_chained

    x = torch.ones(3)
    out = _dep_args((torch.zeros(1, dtype=torch.long), x), {"y": torch.full((2,), 7.0)})
    assert torch.equal(out[1], x) and out[1] is not x
    assert timeit_chained(lambda a: a * 2, x, iters=3) >= 0
    with pytest.raises(ValueError):
        timeit_chained(lambda a: a, torch.zeros(2, dtype=torch.long), iters=1)


# -- dataset preprocessing --------------------------------------------------------------

def _cub_archive(src):
    base = "CUB_200_2011"
    names, splits = [], []
    with zipfile.ZipFile(os.path.join(src, "archive.zip"), "w") as z:
        for i, (cls, train) in enumerate([("001.Bird", "1"), ("001.Bird", "0"),
                                          ("002.Other", "1")]):
            name = f"{cls}/img_{i}.jpg"
            z.writestr(f"{base}/images/{name}", f"jpeg-{i}")
            names.append(f"{i + 1} {name}")
            splits.append(f"{i + 1} {train}")
        z.writestr(f"{base}/images.txt", "\n".join(names) + "\n")
        z.writestr(f"{base}/train_test_split.txt", "\n".join(splits) + "\n")
        z.writestr("attributes.txt", "x")
        z.writestr("segmentations/a.png", "y")


def _voc_archive(src):
    root = "VOC2012_train_val/VOC2012_train_val"
    with zipfile.ZipFile(os.path.join(src, "archive.zip"), "w") as z:
        z.writestr(f"{root}/JPEGImages/2012_000001.jpg", "jpeg")
        z.writestr(f"{root}/Annotations/2012_000001.xml", "<annotation/>")
        z.writestr(f"{root}/ImageSets/Main/train.txt", "2012_000001\n")
        z.writestr("VOC2012_test/VOC2012_test/JPEGImages/x.jpg", "t")


def _tree(root):
    out = []
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out.append((os.path.relpath(os.path.join(d, f), root), fh.read()))
    return sorted(out)


@pytest.mark.parametrize("dataset,make", [("cub200", _cub_archive), ("voc2012", _voc_archive)])
def test_preprocess_gives_jax_trees(tmp_path, dataset, make, capsys):
    from edtr_tpu.data import preprocess as JP

    from edtr_torch.data import preprocess as PP

    trees = []
    for side, mod in (("jax", JP), ("port", PP)):
        src = str(tmp_path / side)
        os.makedirs(src)
        make(src)
        getattr(mod, f"preprocess_{dataset}")(src)
        trees.append(_tree(src))
    assert trees[0] == trees[1] and trees[0]
    assert not os.path.exists(tmp_path / "port" / "archive.zip")


# -- validation hooks --------------------------------------------------------------------

def test_save_image_grid_bytes_equal_jax(tmp_path):
    from edtr_tpu.train.valhooks import save_image_grid as jax_grid

    from edtr_torch.train.valhooks import save_image_grid

    g = np.random.default_rng(0)
    rows = {"gt": g.random((3, 12, 10, 3)).astype(np.float32),
            "lq": (g.random((5, 14, 12, 3)) * 1.4 - 0.2).astype(np.float32)}
    rows["lq"][0, 0, 0] = np.nan
    a = jax_grid(str(tmp_path / "jax"), 12, {k: jnp.asarray(v) for k, v in rows.items()})
    b = save_image_grid(str(tmp_path / "port"), 12,
                        {k: torch.from_numpy(v) for k, v in rows.items()})
    assert os.path.basename(a) == os.path.basename(b) == "step_0000012.png"
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _det_items(g, n=3):
    items = []
    for i in range(n):
        h, w = 40 + 4 * i, 48
        boxes = np.array([[2, 3, 20, 30], [10, 5, 40, 25]], np.float32)
        annot = dict(image_id=i, boxes=boxes, labels=np.array([1, 2]), iscrowd=np.zeros(2),
                     area=(boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
        items.append((g.random((h, w, 3)).astype(np.float32),
                      g.random((h, w, 3)).astype(np.float32), annot, f"{i}.png"))
    return items


def test_validate_detection_and_task_equal_jax():
    """The same fixed net outputs give JAX's stats: detections (valid masks,
    COCO stats and PSNR after a restore), classification top-1 and the
    segmentation mIoU."""
    from edtr_tpu.train import valhooks as JV

    from edtr_torch.train import valhooks as PV

    g = np.random.default_rng(4)
    items = _det_items(g)
    dets = [dict(boxes=np.concatenate([it[2]["boxes"] + g.normal(0, 2, (2, 4)),
                                       g.random((2, 4)) * 30], 0).astype(np.float32)[None],
                 scores=g.random((1, 4)).astype(np.float32),
                 labels=np.array([[1, 2, 1, 3]]), valid=np.array([[True, True, True, False]]))
            for it in items]
    calls = iter(range(10 ** 6))

    def jdet(params, x):
        return {k: jnp.asarray(v) for k, v in dets[next(calls) % len(dets)].items()}

    js = JV.validate_detection(items, jdet, None, jax.random.PRNGKey(0),
                               restore_fn=lambda x, rng: x * 0.5, img_size=64)
    calls = iter(range(10 ** 6))
    ps = PV.validate_detection(items, lambda net, x: {k: torch.as_tensor(v) for k, v in
                                                      dets[next(calls) % len(dets)].items()},
                               None, None, restore_fn=lambda x, gen: x * 0.5, img_size=64)
    assert js.keys() == ps.keys() and "psnr" in ps
    np.testing.assert_allclose([ps[k] for k in js], [js[k] for k in js], rtol=1e-6)

    cls_items = [(it[0], it[1], i % 3, "p") for i, it in enumerate(items)]
    logits = g.standard_normal((3, 1, 5)).astype(np.float32)
    seg_items = [(it[0], it[1], g.integers(0, 4, it[0].shape[:2]).astype(np.uint8), "p")
                 for it in items]
    seg_logits = [g.standard_normal((1,) + it[0].shape[:2] + (4,)).astype(np.float32)
                  for it in items]
    for task, data, outs in (("cls", cls_items, logits), ("seg", seg_items, seg_logits)):
        def jnet(v, x, outs=outs, c=iter(range(9))):
            o = jnp.asarray(outs[next(c)])
            return o if task == "cls" else {"out": o}

        def pnet(net, x, outs=outs, c=iter(range(9))):
            o = torch.from_numpy(outs[next(c)])
            return o if task == "cls" else {"out": o.permute(0, 3, 1, 2)}

        js = JV.validate_task(task, data, jnet, None, jax.random.PRNGKey(0),
                              restore_fn=lambda x, rng: x ** 2)
        ps = PV.validate_task(task, data, pnet, None, None, restore_fn=lambda x, gen: x ** 2)
        assert js.keys() == ps.keys()
        np.testing.assert_allclose([ps[k] for k in js], [js[k] for k in js], rtol=1e-6)


def test_log_val_stats_lines_equal_jax():
    from edtr_tpu.train.valhooks import log_val_stats as jax_log

    from edtr_torch.train.valhooks import log_val_stats

    class Writer(list):
        def add_scalar(self, *a):
            self.append(a)

    stats = {"AP": 0.25, "psnr": 20.5, "n": 3}
    lines = [[], []]
    writers = [Writer(), Writer()]
    jax_log(lines[0].append, writers[0], 4, stats)
    log_val_stats(lines[1].append, writers[1], 4, stats)
    assert lines[0] == lines[1] and writers[0] == writers[1]
