"""The port's training recipes (``edtr_torch/train/recipes.py``) against
``edtr_tpu/train/recipes.py`` on the CPU in fp32.

* ``cosine_tx`` against optax: the learning rate at counts 0, 1, steps/2,
  steps - 1 and steps; AdamW (weight decay 0 and 1e-2) and SGD updates of a
  small tensor, at 1e-6.
* One step of each recipe against JAX's builder, at the tiny nets of
  ``tests/test_convergence.py``: SwinIR ``embed_dim`` 16, depths (2,),
  window 4; ResNet-18 with 10 classes; the tiny flagship of
  ``__graft_entry__._flagship_pipeline(tiny=True)``
  (``tests/torch_port_helpers.py``); all at 64² (at that file's 32² SwinIR
  sees one window and no shift, and the task net's last stage normalises
  1 x 1 maps over 2 images, where fp32 alone moved an SGD update 1.4% from
  fp64). ``make_task_train_step`` plain, with
  ``use_gt`` and with a frozen SwinIR ``pre_restore``;
  ``make_swinir_pre_train_step``; ``make_sr4ir_train_step`` with the CutMix
  cells replayed; ``make_diffbir_train_step`` with ``steps=3``, every draw
  (t, the eps noise, the posterior's sample noise, x_T and the walk's step
  noises) replayed from JAX's five-way split. Each is held on the losses
  and metrics at 1e-4 relative, the updated parameters at relative L2 <=
  3e-3 per leaf (every one moved), the running statistics at 1e-4, the
  teacher unchanged. One ``jax.jit`` per recipe on the JAX side, built
  once per module (the task recipe's three variants in one).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edtr_tpu.models.resnet import ResNet as JResNet
from edtr_tpu.models.swinir import SwinIR as JSwinIR
from edtr_tpu.train import edtr_step as JES
from edtr_tpu.train import recipes as JR
from edtr_tpu.train.runner import _task_apply_for
from edtr_torch.models.resnet import resnet
from edtr_torch.models.swinir import SwinIR
from edtr_torch.pipeline import build_flagship
from edtr_torch.train import recipes as R
from edtr_torch.train.tasks import task_apply_for
from edtr_torch.utils.convert import from_jax
from test_torch_tasknets import random_variables
from torch_port_helpers import CTX, IMAGE, compiled_in_thread, jax_tiny, load_port, nchw, t2n

SIDE = 64
CLASSES = 10
TOL_LOSS = 1e-4
TOL_LEAF = 3e-3
TOL_STATS = 1e-4
# the random ResNet's train-mode gradients are large (BatchNorm over 2 x 2
# maps of 2 images in its last stage): at 2e-3 an SGD update moves conv1 by
# about half its norm
LR_ADAMW, LR_SGD, STEPS = 1e-3, 2e-3, 100
DIFFBIR_STEPS, WEIGHT_FM = 3, 0.5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- cosine_tx ---------------------------------------------------------------------

@pytest.mark.parametrize("kind,wd", [("adamw", 0.0), ("adamw", 1e-2), ("sgd", None)])
def test_cosine_tx_matches_optax(kind, wd):
    lr, steps = 3e-3, 10
    sched = optax.cosine_decay_schedule(lr, steps, alpha=1e-7 / lr)
    p0 = np.random.default_rng(20).standard_normal((3, 4)).astype(np.float32)
    grads = [np.random.default_rng(21 + i).standard_normal((3, 4)).astype(np.float32)
             for i in range(steps + 1)]
    tx = JR.cosine_tx(kind, lr, steps, weight_decay=wd)
    params, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, schedule = R.cosine_tx(kind, lr, steps, weight_decay=wd)([p])
    for count in range(steps + 1):
        if count in (0, 1, steps // 2, steps - 1, steps):
            np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(count)),
                                       rtol=1e-6, err_msg=f"lr at {count}")
        updates, opt_state = tx.update(jnp.asarray(grads[count]), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(grads[count])
        opt.step()
        schedule.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6,
                                   atol=1e-6, err_msg=f"update {count}")
    defaults = dict(adamw=1e-2, sgd=1e-4)[kind] if wd is None else wd
    assert opt.param_groups[0]["weight_decay"] == defaults


# -- the nets ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _swinir_j():
    net = JSwinIR(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4, mlp_ratio=2, sf=8,
                  upsampler="nearest+conv", unshuffle=True, unshuffle_scale=8)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    return net, random_variables(shapes, seed=30)["params"]


def _swinir_t():
    net = SwinIR(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4, mlp_ratio=2, sf=8)
    net.load_state_dict(from_jax(_swinir_j()[1], "swinir"), strict=True)
    return net


@functools.lru_cache(maxsize=None)
def _resnet_j(side: int = SIDE):
    net = JResNet(type=18, num_classes=CLASSES)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    student = random_variables(shapes, seed=31)
    teacher = jax.tree.map(lambda x: (np.asarray(x) * 1.1).astype(np.float32), student)
    return net, student, teacher


def _resnet_t(variables):
    net = resnet(type=18, num_classes=CLASSES, device="cpu")
    net.load_state_dict(from_jax(variables, "resnet"), strict=True)
    return net


def _batch(side: int, b: int = 2, seed: int = 32):
    g = np.random.default_rng(seed)
    return dict(lq=g.random((b, side, side, 3)).astype(np.float32),
                gt=g.random((b, side, side, 3)).astype(np.float32),
                target=g.integers(0, CLASSES, b).astype(np.int32))


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -- the checks --------------------------------------------------------------------

def _check_metrics(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=TOL_LOSS, err_msg=k)


def _without_key_bias(name: str, t: torch.Tensor) -> torch.Tensor:
    """A Swin block's qkv bias without its key third: a key bias adds the
    same logit to a query's whole row, which the softmax takes back, so its
    gradient is zero in exact arithmetic and AdamW's first update there is
    the sign of rounding noise (+-lr) on either side."""
    if not name.endswith("attn.qkv.bias"):
        return t
    c = t.shape[0] // 3
    return torch.cat([t[:c], t[2 * c:]])


def _check_leaves(got: dict, want: dict, before: dict, what: str):
    """Every leaf of ``want`` at relative L2 <= TOL_LEAF, and moved."""
    bad = {}
    for n, w in want.items():
        g = _without_key_bias(n, got[n].detach().double())
        w = _without_key_bias(n, w.double())
        err = float((g - w).norm()) / max(float(w.norm()), 1e-12)
        if err > TOL_LEAF:
            bad[n] = err
    assert not bad, (what, bad)
    still = [n for n in want if torch.equal(got[n].detach(), before[n])]
    assert not still, (what, still[:5])


def _check_net(net, want_vars, kind: str, before: dict, what: str):
    want = from_jax(want_vars, kind)
    sd = net.state_dict()
    stats = [n for n in want if n.endswith(("running_mean", "running_var"))]
    _check_leaves(sd, {n: v for n, v in want.items() if n not in stats and
                       not n.endswith("num_batches_tracked")}, before, what)
    for n in stats:
        np.testing.assert_allclose(t2n(sd[n]), t2n(want[n]), rtol=TOL_STATS, atol=TOL_STATS,
                                   err_msg=f"{what} {n}")
    assert all(not torch.equal(sd[n], before[n]) for n in stats), what


def _snapshot(module) -> dict:
    return {n: v.detach().clone() for n, v in module.state_dict().items()}


# -- make_task_train_step ----------------------------------------------------------

VARIANTS = ("plain", "use_gt", "pre_restore")


def _jax_task_start():
    """JAX's three task steps from one state, in one ``jax.jit``."""
    net, student, _ = _resnet_j()
    sw, sw_params = _swinir_j()
    loss_fn, _ = _task_apply_for("cls", net)
    state = JR.SimpleTrainState.create(jax.tree.map(jnp.asarray, student),
                                       JR.cosine_tx("sgd", LR_SGD, STEPS))

    def run(state, sw_params, batch, rng):
        steps = dict(
            plain=JR.make_task_train_step(loss_fn, jit=False),
            use_gt=JR.make_task_train_step(loss_fn, use_gt=True, jit=False),
            pre_restore=JR.make_task_train_step(
                loss_fn, pre_restore=lambda lq: sw.apply({"params": sw_params}, lq), jit=False))
        out = {}
        for k, s in steps.items():
            new, m = s(state, batch, rng)
            out[k] = (new.variables, m)
        return out

    return compiled_in_thread(run, state, sw_params, jax.tree.map(jnp.asarray, _batch(SIDE)),
                              jax.random.PRNGKey(33), post=lambda out: jax.tree.map(np.asarray,
                                                                                   out))


@pytest.mark.parametrize("variant", VARIANTS)
def test_task_step_matches_jax(variant):
    want_vars, want_m = _jax_task()[variant]
    net = _resnet_t(_resnet_j()[1])
    before = _snapshot(net)
    state = R.SimpleTrainState.create(net, R.cosine_tx("sgd", LR_SGD, STEPS))
    loss_fn, _ = task_apply_for("cls")
    pre = _swinir_t() if variant == "pre_restore" else None
    step = R.make_task_train_step(loss_fn, pre_restore=pre, use_gt=variant == "use_gt")
    metrics = step(state, _torch(_batch(SIDE)))
    _check_metrics(metrics, want_m)
    _check_net(net, want_vars, "resnet", before, variant)
    assert state.step == 1 and state.schedule.last_epoch == 1
    if pre is not None:
        assert all(p.grad is None for p in pre.parameters())


# -- make_swinir_pre_train_step ----------------------------------------------------

def _jax_swinir_pre_start():
    sw, params = _swinir_j()
    state = JR.SimpleTrainState.create({"params": jax.tree.map(jnp.asarray, params)},
                                       JR.cosine_tx("adamw", LR_ADAMW, STEPS, weight_decay=0.0))
    step = JR.make_swinir_pre_train_step(sw, jit=False)
    return compiled_in_thread(step, state, jax.tree.map(jnp.asarray, _batch(SIDE)),
                              jax.random.PRNGKey(34),
                              post=lambda out: jax.tree.map(np.asarray, (out[0].params, out[1])))


def test_swinir_pre_step_matches_jax():
    want_params, want_m = _jax_swinir_pre()
    sw = _swinir_t()
    before = _snapshot(sw)
    state = R.SimpleTrainState.create(sw, R.cosine_tx("adamw", LR_ADAMW, STEPS,
                                                      weight_decay=0.0))
    metrics = R.make_swinir_pre_train_step(sw)(state, _torch(_batch(SIDE)))
    _check_metrics(metrics, want_m)
    _check_leaves(sw.state_dict(), from_jax(want_params, "swinir"), before, "swinir")


# -- make_sr4ir_train_step ---------------------------------------------------------

def _jax_sr4ir_start():
    sw, sw_params = _swinir_j()
    net, student, _ = _resnet_j()
    loss_fn, feats_fn = _task_apply_for("cls", net)
    sw_state = JR.SimpleTrainState.create(
        {"params": jax.tree.map(jnp.asarray, sw_params)},
        JR.cosine_tx("adamw", LR_ADAMW, STEPS, weight_decay=0.0))
    task_state = JR.SimpleTrainState.create(jax.tree.map(jnp.asarray, student),
                                            JR.cosine_tx("sgd", LR_SGD, STEPS))
    step = JR.make_sr4ir_train_step(sw, feats_fn, loss_fn, jit=False)
    rng = jax.random.PRNGKey(35)
    r_mask, _ = jax.random.split(rng)
    cells = jax.random.bernoulli(r_mask, 0.5, (2, 8, 8, 1)).astype(jnp.float32)
    return compiled_in_thread(
        step, (sw_state, task_state), jax.tree.map(jnp.asarray, _batch(SIDE)), rng,
        post=lambda out: jax.tree.map(np.asarray, (out[0][0].params, out[0][1].variables,
                                                   out[1], cells)))


def test_sr4ir_step_matches_jax():
    want_sw, want_task, want_m, cells = _jax_sr4ir()
    assert 0 < cells.mean() < 1
    sw, net = _swinir_t(), _resnet_t(_resnet_j()[1])
    sw_before, net_before = _snapshot(sw), _snapshot(net)
    sw_state = R.SimpleTrainState.create(sw, R.cosine_tx("adamw", LR_ADAMW, STEPS,
                                                         weight_decay=0.0))
    task_state = R.SimpleTrainState.create(net, R.cosine_tx("sgd", LR_SGD, STEPS))
    loss_fn, feats_fn = task_apply_for("cls")
    step = R.make_sr4ir_train_step(sw, feats_fn, loss_fn)
    metrics = step((sw_state, task_state), _torch(_batch(SIDE)), torch.from_numpy(cells))
    _check_metrics(metrics, want_m)
    _check_leaves(sw.state_dict(), from_jax(want_sw, "swinir"), sw_before, "swinir")
    _check_net(net, want_task, "resnet", net_before, "task net")


def test_cutmix_mask_is_nearest():
    cells = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])[..., None]
    mask = R.cutmix_mask(cells, 4, 6)
    assert mask.shape == (1, 1, 4, 6)
    assert mask[0, 0].tolist() == [[1, 1, 1, 0, 0, 0]] * 2 + [[0, 0, 0, 1, 1, 1]] * 2
    want = jax.image.resize(jnp.asarray(cells.numpy()), (1, 4, 6, 1), "nearest")
    np.testing.assert_array_equal(mask.permute(0, 2, 3, 1).numpy(), np.asarray(want))


# -- make_diffbir_train_step -------------------------------------------------------

def _diffbir_batch(b: int = 2):
    g = np.random.default_rng(36)
    out = _batch(IMAGE, b, seed=37)
    out["c_txt"] = g.standard_normal((b,) + CTX).astype(np.float32)
    return out


def _jax_diffbir_start():
    pipe_j, params = jax_tiny()
    net, student, teacher = _resnet_j(IMAGE)
    loss_fn, feats_fn = _task_apply_for("cls", net)
    params = jax.tree.map(jnp.asarray, params)
    tx = JR.cosine_tx("adamw", LR_ADAMW, STEPS, weight_decay=1e-2)
    trainable0, _ = JES.split_trainable(params, train_decoder=False)
    cldm_state = JR.SimpleTrainState(params=params, opt_state=tx.init(trainable0),
                                     step=jnp.zeros((), jnp.int32), tx=tx)
    task_state = JR.SimpleTrainState.create(jax.tree.map(jnp.asarray, student),
                                            JR.cosine_tx("sgd", LR_SGD, STEPS))
    step = JR.make_diffbir_train_step(pipe_j, loss_fn, feats_fn, steps=DIFFBIR_STEPS,
                                      weight_fm=WEIGHT_FM, jit=False)
    rng = jax.random.PRNGKey(38)
    return compiled_in_thread(
        step, (cldm_state, task_state, jax.tree.map(jnp.asarray, teacher)),
        jax.tree.map(jnp.asarray, _diffbir_batch()), rng,
        post=lambda out: (jax.tree.map(np.asarray, (out[0][0].params["controlnet"],
                                                    out[0][1].variables, out[1])), rng))


@functools.lru_cache(maxsize=1)
def _jax_references() -> dict:
    """Every recipe's JAX step, traced one after another (the longest to
    compile first) and compiled side by side (``compiled_in_thread``)."""
    return {name: start() for name, start in (
        ("diffbir", _jax_diffbir_start), ("sr4ir", _jax_sr4ir_start),
        ("task", _jax_task_start), ("swinir_pre", _jax_swinir_pre_start))}


def _jax_task():
    return _jax_references()["task"].result()


def _jax_swinir_pre():
    return _jax_references()["swinir_pre"].result()


def _jax_sr4ir():
    return _jax_references()["sr4ir"].result()


def _jax_diffbir():
    return _jax_references()["diffbir"].result()


def _diffbir_draws(rng, b: int = 2):
    """JAX's draws: ``r_t, r_eps, r_x0, r_s, r_task = split(rng, 5)``; t,
    the eps noise, the posterior's noise, x_T from r_s and the walk's step
    noises from r_s again (``sample_scan``'s splits)."""
    lat = IMAGE // 8
    r_t, r_eps, r_x0, r_s, _ = jax.random.split(rng, 5)
    bs2 = max(b // 2, 1)
    t = np.asarray(jax.random.randint(r_t, (b,), 0, 1000))
    noise = np.asarray(jax.random.normal(r_eps, (b, lat, lat, 4), jnp.float32))
    post = np.asarray(jax.random.normal(r_x0, (b, lat, lat, 4), jnp.float32))
    x_T = np.asarray(jax.random.normal(r_s, (bs2, lat, lat, 4), jnp.float32))
    key, steps = r_s, []
    for _ in range(DIFFBIR_STEPS):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, (bs2, lat, lat, 4), jnp.float32)))
    step_noise = torch.from_numpy(np.stack(steps).transpose(0, 1, 4, 2, 3).copy())
    return dict(t=torch.from_numpy(t).long(), noise=nchw(noise), posterior_noise=nchw(post),
                x_T=nchw(x_T), step_noise=step_noise)


def test_diffbir_step_matches_jax():
    (want_cn, want_task, want_m), rng = _jax_diffbir()
    _, params = jax_tiny()
    pipe = build_flagship(tiny=True, dtype=None, device="cpu")
    load_port(pipe, params)
    _, student_v, teacher_v = _resnet_j(IMAGE)
    net, teacher = _resnet_t(student_v), _resnet_t(teacher_v)
    teacher.requires_grad_(False)
    cn_before, net_before = _snapshot(pipe.cldm.controlnet), _snapshot(net)
    frozen_before = {n: v.clone() for n, v in pipe.state_dict().items()
                     if not n.startswith("cldm.controlnet.")}
    teacher_before = _snapshot(teacher)
    cldm_state = R.diffbir_state(pipe, R.cosine_tx("adamw", LR_ADAMW, STEPS, weight_decay=1e-2))
    task_state = R.SimpleTrainState.create(net, R.cosine_tx("sgd", LR_SGD, STEPS))
    loss_fn, feats_fn = task_apply_for("cls")
    step = R.make_diffbir_train_step(pipe, loss_fn, feats_fn, steps=DIFFBIR_STEPS,
                                     weight_fm=WEIGHT_FM)
    metrics = step((cldm_state, task_state, teacher), _torch(_diffbir_batch()),
                   **_diffbir_draws(rng))
    _check_metrics(metrics, want_m)
    assert set(metrics) == {"loss_eps", "loss_ce", "loss_fm"}
    _check_leaves(pipe.cldm.controlnet.state_dict(), from_jax(want_cn, "controlnet"),
                  cn_before, "controlnet")
    _check_net(net, want_task, "resnet", net_before, "task net")
    for n, v in pipe.state_dict().items():
        if n in frozen_before:
            assert torch.equal(v, frozen_before[n]), n
    assert all(torch.equal(v, teacher_before[n]) for n, v in teacher.state_dict().items())
    assert pipe.sampler.make_schedule(DIFFBIR_STEPS).timesteps.tolist() == [0, 500, 999]
    assert cldm_state.step == task_state.step == 1
    # the draws not given come from the generator: the same seed, the same step
    again = copy.deepcopy((pipe, cldm_state, task_state, teacher))
    m1 = step((cldm_state, task_state, teacher), _torch(_diffbir_batch()),
              generator=torch.Generator().manual_seed(5))
    p2, c2, t2, te2 = again
    step2 = R.make_diffbir_train_step(p2, loss_fn, feats_fn, steps=DIFFBIR_STEPS,
                                      weight_fm=WEIGHT_FM)
    m2 = step2((c2, t2, te2), _torch(_diffbir_batch()), generator=torch.Generator().manual_seed(5))
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}


def test_swinir_bias_is_contiguous_under_grad():
    """The window-attention kernel takes the relative-position bias only
    contiguous; the bias a training step differentiates is made anew each
    call and must be too (the card's first SwinIR step with a gradient
    raised without it)."""
    sw = _swinir_t()
    attn = sw.layers[0].residual_group.blocks[0].attn
    with torch.no_grad():
        cached = attn.bias()
    live = attn.bias()
    assert live.requires_grad and live.is_contiguous() and cached.is_contiguous()
    assert torch.equal(live.detach(), cached)
