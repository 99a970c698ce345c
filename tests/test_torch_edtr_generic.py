"""The port's EDTR step for classification and segmentation task nets
(``make_edtr_generic_train_step`` with ``edtr_torch.train.tasks``) against
``edtr_tpu``'s ``make_edtr_generic_train_step`` with
``runner._task_apply_for`` on the CPU in fp32: the tiny flagship
(``tests/torch_port_helpers.py``, the decoder trainable) at 64², a
full-width ResNet-18 (200 classes) or DeepLabV3-MobileNetV3-Large (21
classes, no auxiliary head) as student, its weights scaled by 1.1 as the
frozen teacher, the configs' loss weights (cls: task 1.0, feature matching
1.0; seg: 1.0, 0.5), seeded labels and masks with 255 borders; each with
``accum_steps`` 1 (batch 2) and 2 (batch 4, the running statistics
carried across the microbatches).

One step each, the port's t, noise, q_sample noise and walk noises replayed
from JAX's key splits: ``loss_hlf``, ``loss_task`` and ``loss_fm`` at 3e-3
relative, the updated ControlNet, VAE decoder and task-net parameters at
relative L2 <= 3e-3 per leaf (as the step with a detector), the student's
running statistics at 1e-4, the teacher unchanged.

JAX's generic step reads ``params["tasknet"]`` and
``params["teacher_tasknet"]`` after ``merge_params``, which keeps only the
pipeline's and a detector's entries: unpatched it raises KeyError. Here
``split_trainable`` and ``merge_params`` carry the two task nets through
(``_carry_task_nets``), the repair its docstring and runner imply.
"""

import copy
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.models import deeplabv3 as JD
from edtr_tpu.models import resnet as JR
from edtr_tpu.train import edtr_step as JS
from edtr_tpu.train.runner import _task_apply_for
from edtr_torch.models import deeplabv3 as TD
from edtr_torch.models import resnet as TR
from edtr_torch.train.edtr_step import EDTRTrainState, make_edtr_generic_train_step
from edtr_torch.train.tasks import task_apply_for
from edtr_torch.utils.convert import from_jax
from test_torch_tasknets import random_variables
from test_torch_train_step import LAT, _port
from torch_port_helpers import CTX, IMAGE, jax_tiny, nchw, t2n

TOL = 3e-3
# task -> (JAX net, port factory, from_jax kind, target maker, weight_task, weight_fm)
TASKS = {
    "cls": (lambda: JR.ResNet(type=18, num_classes=200),
            lambda: TR.resnet(type=18, num_classes=200, device="cpu"), "resnet",
            lambda g, b: g.integers(0, 200, b).astype(np.int32), 1.0, 1.0),
    "seg": (lambda: JD.deeplabv3_mobilenet_v3_large(num_classes=21, aux_loss=False),
            lambda: TD.deeplabv3_mobilenet_v3_large(num_classes=21, aux_loss=False,
                                                    device="cpu"), "deeplabv3",
            lambda g, b: _masks(g, b), 1.0, 0.5),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(g, b):
    m = g.integers(0, 21, (b, IMAGE, IMAGE)).astype(np.int32)
    m[:, :4] = m[:, -4:] = m[:, :, :4] = 255  # VOC's border
    return m


def _batch(task: str, b: int):
    g = np.random.default_rng(41 + b)
    return dict(lq=g.random((b, IMAGE, IMAGE, 3)).astype(np.float32),
                gt=g.random((b, IMAGE, IMAGE, 3)).astype(np.float32),
                c_txt=g.standard_normal((b,) + CTX).astype(np.float32),
                target=TASKS[task][3](g, b))


@functools.lru_cache(maxsize=None)
def _task_variables(task: str):
    """(JAX net, student variables, teacher variables: the student's x 1.1)."""
    net = TASKS[task][0]()
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)))
    student = random_variables(shapes, seed=7)
    teacher = jax.tree.map(lambda x: (np.asarray(x) * 1.1).astype(np.float32), student)
    return net, student, teacher


def _carry_task_nets():
    keys = ("tasknet", "teacher_tasknet")
    split, merge = JS.split_trainable, JS.merge_params

    def split_trainable(params, train_decoder=True):
        trainable, frozen = split(params, train_decoder)
        return trainable, {**frozen, **{k: params[k] for k in keys if k in params}}

    def merge_params(trainable, frozen):
        return {**merge(trainable, frozen), **{k: frozen[k] for k in keys if k in frozen}}

    return mock.patch.multiple(JS, split_trainable=split_trainable, merge_params=merge_params)


@functools.lru_cache(maxsize=None)
def _jax_step(task: str, accum: int):
    """JAX's generic step once: (updated params, metrics, rng)."""
    pipe_j, params = jax_tiny()
    net, student, teacher = _task_variables(task)
    _, _, _, _, w_task, w_fm = TASKS[task]
    loss_fn, feats_fn = _task_apply_for(task, net)
    state = JS.EDTRTrainState.create(pipe_j, jax.tree.map(jnp.array, dict(params, detnet=student)),
                                     train_steps=100, train_decoder=True)
    state = state.replace(params=jax.tree.map(jnp.array, dict(
        params, tasknet=student, teacher_tasknet=teacher)))
    batch = jax.tree.map(jnp.asarray, _batch(task, 2 * accum))
    rng = jax.random.PRNGKey(401 + accum)
    with _carry_task_nets():
        step = JS.make_edtr_generic_train_step(pipe_j, feats_fn, loss_fn, weight_task=w_task,
                                               weight_fm=w_fm, jit=False, accum_steps=accum)
        state, metrics = jax.jit(step)(state, batch, rng)
    return jax.tree.map(np.asarray, state.params), jax.tree.map(float, metrics), rng


def _walk(key, shape, steps):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out).transpose(0, 1, 4, 2, 3).copy())


def _replay(rng, pipe_j, b: int, accum: int):
    """JAX's draws: t and noise of the EDTR half over the batch, and each
    microbatch's q_sample noise and walk noises of the task half."""
    r_edtr, r_task = jax.random.split(rng)
    m, k = b // accum, len(pipe_j.used_timesteps)
    bs2 = max(m // 2, 1)
    ts, noises, draws = [], [], []
    key_e, key_t = r_edtr, r_task
    for _ in range(accum):
        if accum == 1:
            sub_e, sub_t = r_edtr, r_task
        else:
            key_e, sub_e = jax.random.split(key_e)
            key_t, sub_t = jax.random.split(key_t)
        rng_t, rng_n = jax.random.split(sub_e)
        idx = jax.random.randint(rng_t, (m,), 0, k)
        ts.append(np.asarray(pipe_j.used_timesteps)[np.asarray(idx)])
        noises.append(np.asarray(jax.random.normal(rng_n, (m, LAT, LAT, 4), jnp.float32)))
        r_n, r_s, _ = jax.random.split(sub_t, 3)
        q = np.asarray(jax.random.normal(r_n, (bs2, LAT, LAT, 4), jnp.float32))
        draws.append(dict(noise=nchw(q), step_noise=_walk(r_s, (bs2, LAT, LAT, 4), k)))
    return (torch.from_numpy(np.concatenate(ts)).long(), nchw(np.concatenate(noises)), draws)


def _rel_leaves(got: dict, want: dict) -> tuple:
    return max((float((got[n].double() - want[n].double()).norm())
                / float(want[n].double().norm().clamp(min=1e-12)), n) for n in want)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("task", ["cls", "seg"])
def test_generic_step_matches_jax(task, accum):
    want_params, want_m, rng = _jax_step(task, accum)
    pipe_j, _ = jax_tiny()
    _, student_v, teacher_v = _task_variables(task)
    _, factory, kind, _, w_task, w_fm = TASKS[task]
    student, teacher = factory(), factory()
    student.load_state_dict(from_jax(student_v, kind), strict=True)
    teacher.load_state_dict(from_jax(teacher_v, kind), strict=True)
    pipe = _port()
    state = EDTRTrainState.create(pipe, train_steps=100, train_decoder=True, detnet=student,
                                  teacher_detnet=teacher)
    loss_fn, feats_fn = task_apply_for(task)
    step = make_edtr_generic_train_step(pipe, student, teacher, feats_fn, loss_fn,
                                        weight_task=w_task, weight_fm=w_fm, accum_steps=accum)
    t, noise, draws = _replay(rng, pipe_j, 2 * accum, accum)
    batch = {k: torch.from_numpy(v) for k, v in _batch(task, 2 * accum).items()}
    teacher_before = copy.deepcopy(teacher.state_dict())
    metrics = step(state, batch, t, noise, task_draws=draws)

    assert set(metrics) == set(want_m) == {"loss_hlf", "loss_task", "loss_fm"}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), want_m[k], rtol=TOL, err_msg=k)
    for group in ("controlnet", "vae"):
        sd = getattr(pipe.cldm, group).state_dict()
        want = {n: v for n, v in from_jax(want_params[group], group).items()
                if group == "controlnet" or n.startswith("decoder.")}
        worst = _rel_leaves({n: sd[n] for n in want}, want)
        assert worst[0] <= TOL, (group, worst)
    want_t = from_jax(want_params["tasknet"], kind)
    got_t = student.state_dict()
    stats = [n for n in want_t if n.endswith(("running_mean", "running_var"))]
    worst = _rel_leaves({n: got_t[n] for n in want_t if n not in stats},
                        {n: v for n, v in want_t.items() if n not in stats})
    assert worst[0] <= TOL, worst
    moved = [n for n in stats if not torch.equal(got_t[n], from_jax(student_v, kind)[n])]
    assert len(moved) == len(stats)
    for n in stats:
        np.testing.assert_allclose(t2n(got_t[n]), t2n(want_t[n]), rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    for n, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_before[n]), n
    assert state.step == 1 and state.schedule_detnet.last_epoch == 1
