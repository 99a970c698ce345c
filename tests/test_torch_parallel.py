"""``edtr_torch.parallel`` (the process group, the (data, model) mesh,
tensor parallelism, FSDP) and the data-parallel training it gives the
port's steps and runner, on the CPU.

* In this process: the TP and FSDP plans (``tp_spec`` / ``fsdp_spec`` leaf
  by leaf, in torch's layout) and both byte counts equal JAX's
  (``edtr_tpu/parallel/{tp,fsdp}.py``) on ``jax.eval_shape`` trees of the
  tiny UNet of JAX's ``tests/test_tensor_parallel.py`` and of the
  flagship at full width (SwinIR unpadded, as the port is), at (n_data,
  n_model) = (2, 1), (1, 2) and (2, 2). The JAX meshes are built as
  ``jax.sharding.Mesh`` directly: ``edtr_tpu.parallel.mesh.make_mesh``
  would turn JAX's Pallas kernels off for this whole test process.
* In two spawns of two gloo ranks each (``tests/torch_parallel_ranks.py``,
  which imports no JAX; one torch thread a rank; each spawn under its own
  time limit): the group joined from the ``EDTR_*`` variables; the COCO
  merge over ``all_gather_object`` equal to JAX's
  ``merge_prediction_shards`` of the same shards; the loader's rank shards
  equal to JAX's ``ShardedSampler``'s; the tiny UNet's forward and
  gradients at (1, 2) equal to one process (fp64, to rounding); FSDP's
  gradients and AdamW update equal to one process, its parameters and
  moments sharded (fp64); the tiny fp32 EDTR detector step and the
  SwinIR-pre step at two ranks equal to one rank on the global batch
  (losses at JAX's ``tests/test_multichip.py`` limits, rtol 5e-4 / atol
  1e-6); ``edtr_train --debug`` and ``task_train``'s SwinIR pre-training
  on a synthetic VOC tree with rank 0 alone writing the checkpoints and
  the ranks' weights equal.
"""

import functools
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import torch_parallel_ranks as RANKS
from edtr_torch.parallel import fsdp as TFSDP
from edtr_torch.parallel import tp as TTP
from edtr_torch.utils.convert import port_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_FILE = os.path.join(REPO, "tests", "torch_parallel_ranks.py")
# a spawn's two ranks, each: ~5 s of imports, then its cases
SPAWN_TIMEOUT = 150
TINY = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=16,
            transformer_depth=1, context_dim=48, use_linear_in_transformer=True)
MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the plans against JAX's -----------------------------------------------------------

def _jax_mesh(n_data, n_model):
    devices = jax.devices("cpu")[:n_data * n_model]
    return Mesh(np.asarray(devices).reshape(n_data, n_model), ("data", "model"))


def _tiny_trees():
    from edtr_tpu.models.unet import UNetModel as JUNet

    from edtr_torch.models.unet import UNetModel

    net = JUNet(**TINY)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, 4, 48)))["params"]
    with torch.device("meta"):
        port = UNetModel(**TINY)
    return {"unet": shapes}, port, lambda group: ""


@functools.lru_cache(maxsize=1)
def _flagship_trees():
    import __graft_entry__ as G

    from edtr_torch.pipeline import build_flagship

    pad = os.environ.get("EDTR_SWINIR_PAD")
    os.environ["EDTR_SWINIR_PAD"] = "0"  # the port's SwinIR is unpadded
    try:
        pipe = G._flagship_pipeline(dtype=None)
    finally:
        if pad is None:
            del os.environ["EDTR_SWINIR_PAD"]
        else:
            os.environ["EDTR_SWINIR_PAD"] = pad

    def init(key):
        k1, k2 = jax.random.split(key)
        p = pipe.cldm.init_params(k1, latent_hw=8)
        p["swinir"] = pipe.swinir.init(k2, jnp.zeros((1, 64, 64, 3)))["params"]
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    port = build_flagship(device="meta")
    return shapes, port, lambda group: "swinir." if group == "swinir" else f"cldm.{group}."


def _expected(spec: P, perm, axis):
    """JAX's spec of one leaf on ``axis`` as the port's placement: the
    torch dim of the JAX dim that carries the axis."""
    dims = [i for i, a in enumerate(spec) if a == axis]
    return Shard(perm[dims[0]]) if dims else Replicate()


@pytest.mark.parametrize("n_data,n_model", MESHES)
@pytest.mark.parametrize("which", ["tiny_unet", "flagship"])
def test_tp_and_fsdp_plans_equal_jax(which, n_data, n_model):
    from edtr_tpu.parallel import fsdp as JFSDP
    from edtr_tpu.parallel import tp as JTP

    trees, port, prefix = _tiny_trees() if which == "tiny_unet" else _flagship_trees()
    mesh = _jax_mesh(n_data, n_model)
    sizes = {"data": n_data, "model": n_model}
    tp = TTP.tp_shardings(port, sizes)
    fs = TFSDP.fsdp_shardings(port, sizes)
    checked = 0
    for group, tree in trees.items():
        if group == "clip":  # q/k/v fused into one leaf in the port: bytes only
            continue
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            ps = JTP._path_str(path)
            key = prefix(group) + port_key(ps, group)
            perm = TFSDP.jax_layout(port, key)
            spec = JTP.tp_spec(ps, leaf.shape)
            if not JTP._divisible(spec, leaf.shape, n_model):
                spec = P()
            assert tp[key] == _expected(spec, perm, "model"), (key, spec, tp[key])
            fspec = JFSDP.fsdp_spec(ps, leaf.shape, n_data, n_model)
            assert fs[key] == [_expected(fspec, perm, "data"), _expected(fspec, perm, "model")], \
                (key, fspec, fs[key])
            checked += 1
    assert checked == len(tp) - sum(k.startswith("cldm.clip.") for k in tp)
    assert TTP.tp_param_bytes(port, sizes) == JTP.tp_param_bytes(trees, mesh)
    assert TFSDP.fsdp_param_bytes(port, sizes) == JFSDP.fsdp_param_bytes(trees, mesh)
    per_dev, total = TTP.tp_param_bytes(port, sizes)
    assert (per_dev < total) == (n_model > 1)


def test_plans_split_what_jax_splits():
    """The plan's rules on the port's names (JAX's ``tests/test_tensor_parallel.py``
    and ``test_fsdp.py`` rules, in torch's layout)."""
    assert TTP.tp_spec("a.attn1.to_q.weight", (64, 64)) == Shard(0)
    assert TTP.tp_spec("a.attn2.to_out.0.weight", (64, 64)) == Shard(1)
    assert TTP.tp_spec("a.ff.net.0.proj.weight", (512, 64)) == Shard(0)
    assert TTP.tp_spec("a.ff.net.2.weight", (64, 256)) == Shard(1)
    assert TTP.tp_spec("b.in_layers.2.weight", (64, 64, 3, 3)) == Shard(0)
    assert TTP.tp_spec("b.out_layers.3.weight", (64, 64, 3, 3)) == Shard(1)
    assert TTP.tp_spec("b.emb_layers.1.weight", (64, 1280)) == Shard(0)
    assert TTP.tp_spec("a.norm1.weight", (64,)) == Replicate()
    assert TTP.tp_spec("b.skip_connection.weight", (64, 128, 1, 1)) == Replicate()
    # FSDP: the largest free dim in JAX's order; composed with TP; small or
    # indivisible leaves replicated on data
    assert TFSDP.fsdp_spec("x.weight", (1024, 256), 8, perm=(1, 0)) == [Shard(0), Replicate()]
    assert TFSDP.fsdp_spec("a.to_q.weight", (512, 512), 4, 2, perm=(1, 0)) == [Shard(1), Shard(0)]
    assert TFSDP.fsdp_spec("b.conv.weight", (128, 256, 3, 3), 8, perm=(2, 3, 1, 0)) == [
        Shard(1), Replicate()]
    assert TFSDP.fsdp_spec("a.norm.weight", (320,), 8) == [Replicate(), Replicate()]
    assert TFSDP.fsdp_spec("x.weight", (9, 7), 8, perm=(1, 0)) == [Replicate(), Replicate()]


# -- two ranks -------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(phase: str, out, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, RANKS_FILE, phase, str(rank), port, str(out),
                              *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for rank in range(2)]


def _join(procs, phase: str, out):
    """Both ranks' results; a rank that fails or outlives the spawn's time
    limit fails the test (both killed) with its output."""
    deadline = time.monotonic() + SPAWN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"phase {phase}: the ranks ran past {SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"phase {phase} rank {rank} failed:\n{log[-6000:]}"
    return [torch.load(os.path.join(out, f"{phase}-{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module", autouse=True)
def spawns(tmp_path_factory):
    """Both spawns started together before the module's first test, so
    that their ranks run while the plans are compared; every rank killed at
    the module's end if it still runs."""
    from edtr_torch.data import synthetic
    from test_torch_runner import tiny_config

    from edtr_torch.data.val_data_generation import generate

    root = str(tmp_path_factory.mktemp("voc"))
    synthetic.write_voc_tree(root, n=4, size_range=(72, 96), seed=3)
    swinir_path = "configs/det/voc2012/train/002_swinir-pre.yaml"
    generate(tiny_config(swinir_path, root, os.path.join(root, "gen")), "det", seed=231)
    configs = []
    # the EDTR loop at a global batch of 4 in two microbatches, validating;
    # the SwinIR pre-training at a global batch of 2, not validating
    for name, path, accum in (("edtr", "configs/det/voc2012/train/007_edtr-s4.yaml", 2),
                              ("swinir", swinir_path, 1)):
        cfg_path = tiny_config(path, root, os.path.join(root, name), accum_steps=accum)
        with open(cfg_path) as f:
            cfg = yaml.safe_load(f)
        cfg["train"]["batch_size"] = 2 * accum
        if name == "swinir":
            cfg["dataset"].pop("val", None)
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        configs.append(cfg_path)
    out = {phase: tmp_path_factory.mktemp(f"ranks_{phase}") for phase in "ab"}
    procs = {"a": _spawn("a", out["a"]), "b": _spawn("b", out["b"], *configs)}
    yield procs, out, root
    for p in procs["a"] + procs["b"]:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def phase_a(spawns):
    procs, out, _ = spawns
    return _join(procs["a"], "a", out["a"])


@pytest.fixture(scope="module")
def phase_b(spawns):
    """The ranks' results, and the one-process steps on the global batch,
    computed here while the ranks run."""
    procs, out, root = spawns
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # module fixtures run before _one_torch_thread
    try:
        refs = dict(det={accum: RANKS.det_step(accum=accum) for accum in RANKS.DET_ACCUM},
                    swinir_pre=RANKS.swinir_pre_step())
    finally:
        torch.set_num_threads(n)
    return _join(procs["b"], "b", out["b"]), refs, root


def test_group_joins_from_the_edtr_variables(phase_a, phase_b):
    for results in (phase_a, phase_b[0]):
        for rank, res in enumerate(results):
            assert res["multi"] and res["rank"] == (rank, 2) and res["backend"] == "gloo"


def test_coco_merge_across_ranks_equals_jax(phase_a):
    from edtr_tpu.utils.coco_eval import CocoEvaluator as JCoco

    ev = JCoco(RANKS.coco_gt())
    ev.dt = JCoco.merge_prediction_shards([RANKS.coco_shard(r) for r in range(2)])
    ev.accumulate()
    want = ev.summarize(verbose=False)
    for res in phase_a:
        assert res["coco"]["ids"] == [0, 1, 2, 3]
        assert res["coco"]["stats"].keys() == want.keys()
        for k, v in want.items():
            assert res["coco"]["stats"][k] == pytest.approx(v, abs=1e-12), k


def test_loader_rank_shards_equal_jax(phase_a):
    from edtr_tpu.train.harness import make_dataloader as jloader

    for i, kw in enumerate(RANKS.LOADERS):
        for rank, res in enumerate(phase_a):
            want = [[int(t) for t in b[2]] for b in jloader(
                RANKS.Range(kw["n"]), batch_size=kw["batch_size"], shuffle=True,
                seed=kw["seed"], process_index=rank, process_count=2)]
            assert res["loaders"][i] == want
        seen = sorted(t for res in phase_a for b in res["loaders"][i] for t in b)
        assert set(seen) == set(range(kw["n"])) and len(seen) == kw["n"] + kw["n"] % 2


def _close(a: dict, b: dict, atol_scale: float):
    scale = max(float(v.abs().max()) for v in b.values())
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=atol_scale * scale,
                                   err_msg=k)


def test_tp_unet_forward_and_grads_equal_one_process(phase_a):
    """Stock, and under the kernels' configuration, where the sharded
    modules reach every kernel wrapper (gathered weights, or this rank's
    heads), as the whole ones do."""
    for res in phase_a:
        tp = res["tp"]
        # the fused norms keep fp32 statistics in their plain versions, and
        # with split heads each rank's partial gradient passes a fused LN's
        # backward apart before the ranks' sum (~1.2e-12 of the largest)
        for case, grad_tol in ((tp, 1e-12), (tp["fused"], 1e-9)):
            np.testing.assert_allclose(case["out"].numpy(), case["ref"].numpy(), rtol=1e-12,
                                       atol=1e-12)
            _close(case["grads"], case["grads_ref"], grad_tol)
        assert all(tp["fused"]["calls"].values()), tp["fused"]["calls"]
        # the plan split the transformer and ResBlock weights; the 2-head
        # attention each rank computes one head of (its rows of to_q)
        assert any(k.endswith("attn1.to_q.weight") for k in tp["sharded"])
        assert any(k.endswith("in_layers.2.weight") for k in tp["sharded"])
        assert tp["local_rows"] == 32


def test_fsdp_update_equals_one_process_and_stays_sharded(phase_a):
    fs = [res["fsdp"] for res in phase_a]
    # fp32 norm statistics inside the fp64 net: the two halves' round
    # differently from the whole batch's
    assert float(sum(f["loss"] for f in fs) / 2) == pytest.approx(float(fs[0]["loss_ref"]),
                                                                   rel=1e-6)
    for f in fs:
        _close(f["grads"], f["grads_ref"], 1e-6)
        _close(f["params"], f["params_ref"], 1e-6)
        assert f["sharded_params"] > 0 and f["sharded_moments"] == f["sharded_params"]
        assert f["moments"] == len(f["params"])


STEP_TOL = dict(rel=5e-4, abs=1e-6)


@pytest.mark.parametrize("accum", RANKS.DET_ACCUM)
def test_det_step_at_two_ranks_equals_one_on_the_global_batch(phase_b, accum):
    """The losses, the gradients of both updates, the student's running
    statistics (synced BatchNorm); at one microbatch on given draws, at two
    on the step's own draws, each rank its rows of the global ones."""
    results, refs, _ = phase_b
    ref = refs["det"][accum]
    for res in results:
        got = res["det"][accum]
        assert set(got["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, **STEP_TOL), k
        for part in ("controlnet", "decoder", "detnet"):
            assert got[part].keys() == ref[part].keys() and ref[part]
        _close(got["controlnet"], ref["controlnet"], 1e-4)
        _close(got["decoder"], ref["decoder"], 1e-4)
        # the detector's train-mode gradients are ill-conditioned in fp32
        # on random weights (PERF.md §2; ~1.2e-4 here)
        _close(got["detnet"], ref["detnet"], 1e-3)
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_swinir_pre_step_at_two_ranks_equals_one_on_the_global_batch(phase_b):
    results, refs, _ = phase_b
    ref = refs["swinir_pre"]
    for res in results:
        assert res["swinir_pre"]["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"],
                                                                     **STEP_TOL)
        _close(res["swinir_pre"]["grads"], ref["grads"], 1e-4)


def test_runner_debug_runs_at_two_ranks(phase_b):
    """``edtr_train --debug`` at two microbatches: both ranks take 2 steps,
    validate after each on the same restorations (the same stats), rank 0
    alone saves (the ControlNet, decoder, detector and SwinIR each step),
    the ranks end on the same weights; ``task_train``'s SwinIR
    pre-training (which JAX's runner would leave unsynchronised, ROADMAP
    Queue 3) alike."""
    results, _, root = phase_b
    (r0, r1) = (res["runner"] for res in results)
    assert r0["edtr"]["step"] == r1["edtr"]["step"] == 2
    assert len(r0["edtr"]["vals"]) == 2 and r0["edtr"]["vals"] == r1["edtr"]["vals"]
    assert all(np.isfinite(v["psnr"]) for v in r0["edtr"]["vals"])
    assert r0["edtr"]["saves"] == [["controlnet", "decoder", "detnet", "swinir"]] * 2
    assert r1["edtr"]["saves"] == [] and r1["swinir"]["saves"] == []
    assert r0["swinir"]["saves"] == [["swinir"]] * 2
    assert r0["edtr"]["controlnet_sq"] == r1["edtr"]["controlnet_sq"]
    for k, v in r0["swinir"]["params"].items():
        assert torch.equal(v, r1["swinir"]["params"][k]), k
    ckpts = os.listdir(os.path.join(root, "edtr", "checkpoints"))
    assert "trainstate_last.pt" in ckpts and "controlnet_2.pt" in ckpts
    log = open(os.path.join(root, "edtr", "run.log")).read()
    assert "2 processes" in log and "step 2:" in log and "training done" in log
