"""The port's EDTR step with a detection net (``edtr_torch/train/edtr_step.py``)
against ``edtr_tpu``'s ``make_edtr_train_step(pipe, detnet=...)`` on the
CPU: the tiny flagship in fp32 (``tests/torch_port_helpers.py``, the
decoder trainable) and the tiny detector (``__graft_entry__._tiny_detnet``'s
knobs at 128², sampling keeping every candidate as in
``test_torch_det_train.py``) as student, a second set of weights as the
frozen teacher.

* One step: the port's step with t, noise, the q_sample noise and the
  walk's step noises replayed from JAX's key splits (the detector's sampler
  keeps every candidate, so its draws need no replay) against JAX's jitted
  step: ``loss_hlf``, ``loss_det``, ``loss_fm`` and the four detector
  losses at 3e-3 relative, the updated ControlNet and detnet parameters at
  relative L2 <= 3e-3 per leaf, the detnet's running statistics at 1e-4.
* ``accum_steps=2`` on a batch of 4: the EDTR half's loss and gradients
  equal one batch's (to fp32 rounding); the task-net half's equal the mean
  of the two microbatches' halves run one after the other.
* ``cast_frozen_bf16``: the dtypes of JAX's per module and the same bf16
  values; on the cast weights the tiny restore and the teacher's features
  equal the port's on the same values stored in fp32 (1e-5), and the text
  tower JAX's on its cast tree (bf16 on both sides: 3e-3).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.models.clip import CLIPTextEncoder as JCLIP
from edtr_tpu.train import edtr_step as JS
from edtr_torch.models import faster_rcnn as TF
from edtr_torch.train.edtr_step import (EDTRTrainState, cast_frozen_bf16,
                                        make_edtr_train_step)
from edtr_torch.utils.convert import from_jax, pipeline_from_jax
from test_torch_det_train import TRAIN_KNOBS
from test_torch_detection import DET_IMAGE, _detector
from test_torch_pipeline import _replay_noise
from test_torch_train_step import LAT, _port, _worst
from torch_port_helpers import CTX, IMAGE, jax_tiny, nchw, t2n

TOL = 3e-3
DET_KW = dict(num_classes=6, device="cpu", min_size=DET_IMAGE, max_size=DET_IMAGE * 2,
              rpn_pre_nms_top_n_train=64, rpn_pre_nms_top_n_test=64,
              rpn_post_nms_top_n_train=32, rpn_post_nms_top_n_test=32,
              box_detections_per_img=8, **TRAIN_KNOBS)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _det_variables():
    """(JAX detector with the training knobs, student variables, teacher
    variables: the student's scaled by 1.1)."""
    det, variables, _ = _detector()
    teacher = jax.tree.map(lambda x: (np.asarray(x) * 1.1).astype(np.float32), variables)
    return det.clone(**TRAIN_KNOBS), variables, teacher


def _port_dets():
    _, student, teacher = _det_variables()
    out = []
    for variables in (student, teacher):
        net = TF.fasterrcnn_mobilenet_v3_large_fpn(**DET_KW)
        net.load_state_dict(from_jax(variables, "fasterrcnn"), strict=True)
        out.append(net)
    return out


def _batch(seed: int, b: int):
    g = np.random.default_rng(seed)
    boxes = np.zeros((b, 3, 4), np.float32)
    xy = g.random((b, 2, 2)) * 36
    boxes[:, :2] = np.concatenate([xy, xy + 12 + g.random((b, 2, 2)) * 16], -1)
    return dict(lq=g.random((b, IMAGE, IMAGE, 3)).astype(np.float32),
                gt=g.random((b, IMAGE, IMAGE, 3)).astype(np.float32),
                c_txt=g.standard_normal((b,) + CTX).astype(np.float32),
                targets=dict(boxes=boxes, labels=g.integers(1, 6, (b, 3)).astype(np.int32),
                             valid=np.array([[True, True, False]] * b)))


def _torch(batch):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in batch.items()}


def _replay(rng, pipe_j, b):
    """JAX's draws from ``rng`` (accum_steps 1): t and noise of the EDTR half,
    the q_sample noise and the walk's step noises of the task-net half."""
    _, r_edtr, r_det = jax.random.split(rng, 3)
    rng_t, rng_n = jax.random.split(r_edtr)
    idx = jax.random.randint(rng_t, (b,), 0, len(pipe_j.used_timesteps))
    t = np.asarray(pipe_j.used_timesteps)[np.asarray(idx)]
    noise = np.asarray(jax.random.normal(rng_n, (b, LAT, LAT, 4), jnp.float32))
    rng_qn, rng_s, _ = jax.random.split(r_det, 3)
    bs2 = max(b // 2, 1)
    q_noise = np.asarray(jax.random.normal(rng_qn, (bs2, LAT, LAT, 4), jnp.float32))
    # the walk: key, sub = split(key) per step, as the restore's sampler
    key, steps = rng_s, []
    for _ in range(len(pipe_j.used_timesteps)):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, (bs2, LAT, LAT, 4), jnp.float32)))
    draws = dict(noise=nchw(q_noise), step_noise=torch.from_numpy(
        np.stack(steps).transpose(0, 1, 4, 2, 3).copy()), uniforms=None)
    return torch.from_numpy(t).long(), nchw(noise), draws


@functools.lru_cache(maxsize=1)
def _jax_step():
    pipe_j, params = jax_tiny()
    det, student, teacher = _det_variables()
    params = dict(params, detnet=student, teacher_detnet=teacher)
    state = JS.EDTRTrainState.create(pipe_j, jax.tree.map(jnp.array, params), train_steps=100,
                                     train_decoder=True)
    step = JS.make_edtr_train_step(pipe_j, detnet=det)
    batch = jax.tree.map(jnp.asarray, _batch(31, 2))
    rng = jax.random.PRNGKey(301)
    state, metrics = step(state, batch, rng)
    return jax.tree.map(np.asarray, state.params), jax.tree.map(float, metrics), rng


def _rel_leaves(got: dict, want: dict) -> tuple:
    return max((float((got[n].double() - want[n].double()).norm())
                / float(want[n].double().norm().clamp(min=1e-12)), n) for n in want)


def test_one_step_with_a_detnet_matches_jax():
    want_params, want_m, rng = _jax_step()
    pipe_j, _ = jax_tiny()
    pipe = _port()
    det, teacher = _port_dets()
    state = EDTRTrainState.create(pipe, train_steps=100, train_decoder=True, detnet=det,
                                  teacher_detnet=teacher)
    step = make_edtr_train_step(pipe, detnet=det, teacher_detnet=teacher)
    t, noise, draws = _replay(rng, pipe_j, 2)
    teacher_before = copy.deepcopy(teacher.state_dict())
    metrics = step(state, _torch(_batch(31, 2)), t, noise,
                   generator=torch.Generator().manual_seed(0), task_draws=[draws])
    assert set(metrics) == set(want_m)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), want_m[k], rtol=TOL, err_msg=k)
    got = {"cldm.controlnet." + n: p for n, p in
           pipe.cldm.controlnet.state_dict().items()}
    want = {"cldm.controlnet." + n: v for n, v in
            from_jax(want_params["controlnet"], "controlnet").items()}
    worst = _rel_leaves(got, want)
    assert worst[0] <= TOL, worst
    want_d = from_jax(want_params["detnet"], "fasterrcnn")
    got_d = det.state_dict()
    worst = _rel_leaves({n: got_d[n] for n in want_d}, want_d)
    assert worst[0] <= TOL, worst
    for n, v in want_d.items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t2n(got_d[n]), t2n(v), rtol=1e-4, atol=1e-4, err_msg=n)
    for n, v in teacher.state_dict().items():  # the teacher stays
        assert torch.equal(v, teacher_before[n]), n
    assert state.step == 1 and state.schedule_detnet.last_epoch == 1


def _snapshot(pipe, det):
    return ({n: p.grad.clone() for n, p in pipe.named_parameters() if p.grad is not None},
            {n: p.grad.clone() for n, p in det.named_parameters() if p.grad is not None},
            {n: b.clone() for n, b in det.named_buffers()})


def test_accum_steps_two_microbatches():
    batch = _torch(_batch(32, 4))
    g = torch.Generator().manual_seed(5)
    t = torch.tensor([50, 200, 100, 150])
    noise = torch.randn((4, 4, LAT, LAT), generator=g)

    def draws(shared, k):
        n = torch.randn((k, 4, LAT, LAT), generator=g)
        return dict(noise=n[:1], step_noise=n[1:, None], uniforms=None)

    pipe, (det, teacher) = _port(), _port_dets()
    state = EDTRTrainState.create(pipe, train_decoder=True, detnet=det, teacher_detnet=teacher)
    step2 = make_edtr_train_step(pipe, detnet=det, teacher_detnet=teacher, accum_steps=2)
    loss2, shared = step2._edtr_half(state, batch, t, noise, None)
    d = [draws(sh, 5) for sh in shared]
    m2 = step2.task_grads(state, batch, shared, d)
    edtr2, det2, stats2 = _snapshot(pipe, det)

    pipe, (det, teacher) = _port(), _port_dets()
    state = EDTRTrainState.create(pipe, train_decoder=True, detnet=det, teacher_detnet=teacher)
    step1 = make_edtr_train_step(pipe, detnet=det, teacher_detnet=teacher)
    loss1 = step1.grads(state, batch, t, noise)
    edtr1, _, _ = _snapshot(pipe, det)
    torch.testing.assert_close(loss2, loss1, rtol=1e-5, atol=0)
    worst = _worst(edtr2, edtr1)
    assert worst[0] <= 1e-3, worst
    grads, totals = {}, {}
    for i in range(2):  # each microbatch's task-net half alone, in turn
        mb = {k: ({kk: vv[2 * i:2 * i + 2] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[2 * i:2 * i + 2]) for k, v in batch.items()}
        m = step1.task_grads(state, mb, [shared[i]], [d[i]])
        for n, p in det.named_parameters():
            if p.grad is not None:
                grads[n] = grads.get(n, 0) + p.grad / 2
        for k, v in m.items():
            totals[k] = totals.get(k, 0) + v / 2
    for k, v in m2.items():
        torch.testing.assert_close(v, totals[k], rtol=1e-5, atol=1e-7, msg=k)
    assert set(grads) == set(det2)
    worst = _worst(det2, grads)
    assert worst[0] <= 1e-4, worst
    for n, b in det.named_buffers():
        torch.testing.assert_close(stats2[n], b, rtol=1e-6, atol=1e-7, msg=n)


def test_cast_frozen_bf16_matches_jax():
    pipe_j, params = jax_tiny()
    _, student, teacher = _det_variables()
    cast = JS.cast_frozen_bf16(dict(params, teacher_detnet=teacher), train_decoder=True)
    pipe, (_, t_det) = _port(), _port_dets()
    # the same stored values in fp32: every frozen weight rounded through bf16
    rounded, (_, t_rounded) = _port(), _port_dets()
    with torch.no_grad():
        for net, ref in ((rounded, pipe), (t_rounded, t_det)):
            for (n, t), (_, r) in zip(net.state_dict().items(), ref.state_dict().items()):
                if not n.startswith(("cldm.controlnet.", "cldm.vae.decoder.")):
                    t.copy_(r.to(torch.bfloat16).float())
    before = sum(p.numel() * p.element_size() for p in pipe.parameters())
    cast_frozen_bf16(pipe, train_decoder=True, teacher_detnet=t_det)
    after = sum(p.numel() * p.element_size() for p in pipe.parameters())
    assert after < before
    # dtypes and values, group by group, as JAX's cast
    want = pipeline_from_jax(cast)  # bf16 values, widened to fp32 exactly
    dtypes = {g: {str(x.dtype) for x in jax.tree.leaves(cast[g])}
              for g in ("unet", "clip", "swinir", "controlnet")}
    assert dtypes == {"unet": {"bfloat16"}, "clip": {"bfloat16"}, "swinir": {"bfloat16"},
                      "controlnet": {"float32"}}
    for n, p in pipe.named_parameters():
        trains = n.startswith(("cldm.controlnet.", "cldm.vae.decoder."))
        assert p.dtype == (torch.float32 if trains else torch.bfloat16), n
        assert torch.equal(p.float(), want[n]), n
    for n, v in from_jax(cast["teacher_detnet"], "fasterrcnn").items():
        got = t_det.state_dict()[n]
        assert got.dtype == torch.bfloat16 and torch.equal(got.float(), v), n
    # the fp32 modules compute on bf16 storage what they compute on the same
    # values stored in fp32 (JAX's modules promote bf16 params likewise)
    g = np.random.default_rng(33)
    lq = torch.from_numpy(g.random((1, IMAGE, IMAGE, 3)).astype(np.float32))
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        g.standard_normal((1,) + CTX), g.standard_normal((1, LAT, LAT, 4)),
        g.standard_normal((4, 1, LAT, LAT, 4)))]
    got, ref = (p_.restore(lq, args[0], noise=args[1], step_noise=args[2])
                for p_ in (pipe, rounded))
    for name in ("pre_restored", "z", "restored"):
        torch.testing.assert_close(got[name], ref[name], rtol=1e-5, atol=1e-5, msg=name)
    img = nchw(np.repeat(np.repeat(t2n(lq), 2, 1), 2, 2))  # 128²
    with torch.no_grad():
        for k, v in t_det.features(img).items():
            torch.testing.assert_close(v, t_rounded.features(img)[k], rtol=1e-5, atol=1e-5)
    # the text tower's bf16 embeddings run it in bf16, on both sides
    ids = g.integers(0, 512, (1, 77)).astype(np.int32)
    want_txt = np.asarray(JCLIP(vocab_size=512, width=64, heads=4, layers=2).apply(
        {"params": cast["clip"]}, ids))
    with torch.no_grad():
        got_txt = t2n(pipe.cldm.clip(ids))
    assert np.linalg.norm(got_txt - want_txt) / np.linalg.norm(want_txt) <= TOL
