"""The port's EDTR training step (``edtr_torch/train/edtr_step.py``) against
``edtr_tpu``'s ``make_edtr_train_step`` with ``detnet=None``, on the tiny
flagship in fp32 on the CPU (``tests/torch_port_helpers.py``; the decoder
trainable on both sides, ``train_decoder=True``).

* Loss and gradients: the port's loss at 1e-4 relative and every ControlNet
  and VAE-decoder gradient leaf at relative L2 <= 3e-3 (floored at 1e-3 of
  the largest leaf's norm: some leaves are zero in exact arithmetic) against
  ``jax.value_and_grad`` of the JAX loss, built from the JAX package's own
  functions on the same weights, batch, t and noise.
* Two steps of JAX's jitted step against two port steps (t and noise
  replayed from JAX's key splits): the losses agree at 1e-4.
* The optimizer: five AdamW + cosine updates fed the same numpy gradients
  against ``EDTRTrainState.create(...).tx_edtr``, at 1e-6.
* The partition: frozen parameters bit-identical after a step, every
  trainable one moved, the cached bf16 conv weights re-packed; with a
  detnet and its teacher, the state's SGD over the detnet's trainable
  parameters.
* ``accum_steps=2`` against one batch of 2; ``use_checkpoint`` on against
  off; the recompute runs in the configuration of its forward even when the
  backward runs outside it; the K5/K6 autograd Functions against autograd
  of their plain versions; the step's phases are profiler ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edtr_tpu.train import edtr_step as JS
from edtr_tpu.utils.image import wavelet_reconstruction as j_wavelet
from edtr_torch.diffusion.schedule import Diffusion
from edtr_torch.models import layers
from edtr_torch.models.cldm import ControlLDM
from edtr_torch.models.swinir import SwinIR
from edtr_torch.ops import geglu as GG
from edtr_torch.ops import gn_conv as G
from edtr_torch.ops import ln_matmul as LM
from edtr_torch.pipeline import EDTRPipeline, flagship_configs
from edtr_torch.train.edtr_step import EDTRTrainState, make_edtr_train_step, split_trainable
from edtr_torch.utils.convert import from_jax
from torch_port_helpers import CTX, IMAGE, compiled_step, jax_tiny, load_port, nchw

LAT = IMAGE // 8
B = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tiny shapes need one thread. The suite runs several test
    processes on a few cores, and torch's own thread pool in each of them
    oversubscribes the CPU: the port's steps ran 40x slower that way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(use_checkpoint: bool = False, fused_conv: bool = False,
          fused_proj: bool = False) -> EDTRPipeline:
    """A fresh tiny port pipeline (the step updates it in place) with the
    JAX weights, trainable decoder, and ``use_checkpoint`` and the
    configuration as given."""
    _, params = jax_tiny()
    cfg = flagship_configs(tiny=True)
    for name in ("unet", "controlnet"):
        cfg[name]["use_checkpoint"] = use_checkpoint
    cfg["vae"]["ddconfig"]["use_checkpoint"] = use_checkpoint
    cfg["vae"]["train_decoder"] = True
    pipe = EDTRPipeline(SwinIR(**cfg["swinir"]),
                        ControlLDM(cfg["unet"], cfg["vae"], cfg["controlnet"], 0.18215,
                                   clip_cfg=cfg["clip"]),
                        Diffusion.create(1000, linear_start=0.00085, linear_end=0.0120),
                        device="cpu", fused_conv=fused_conv, fused_proj=fused_proj)
    load_port(pipe, params)
    return pipe


def _batch(seed: int = 11, b: int = B):
    g = np.random.default_rng(seed)
    return dict(lq=g.random((b, IMAGE, IMAGE, 3)).astype(np.float32),
                gt=g.random((b, IMAGE, IMAGE, 3)).astype(np.float32),
                c_txt=g.standard_normal((b,) + CTX).astype(np.float32))


def _t_noise(seed: int = 12, b: int = B):
    g = np.random.default_rng(seed)
    t = np.array([50, 200, 100, 150][:b], np.int32)
    return t, g.standard_normal((b, LAT, LAT, 4)).astype(np.float32)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss(pipe, batch, t, noise):
    """``edtr_loss`` of JAX's step (``detnet=None``) at given t and NHWC
    noise, from the JAX package's functions: (trainable, frozen) -> loss."""
    def shared_for(params):
        pre_res = pipe.pre_restore(params, jnp.asarray(batch["lq"]))
        z_pre = pipe.cldm.vae_encode(params, pre_res * 2 - 1, sample=False)
        return pre_res, z_pre

    def loss(trainable, frozen):
        params = JS.merge_params(trainable, frozen)
        pre_res, z_pre = jax.lax.stop_gradient(shared_for(params))
        cond = dict(c_txt=jnp.asarray(batch["c_txt"]), c_img=z_pre)
        out = pipe.diffusion.reverse(pipe.cldm.model_fn(params), jnp.asarray(t), z_pre, cond,
                                     noise=jnp.asarray(noise))
        decoded = (pipe.cldm.vae_decode(params, out["x_pred"]) + 1) / 2
        res = j_wavelet(decoded, pre_res)
        return 0.5 * jnp.abs(res - jnp.asarray(batch["gt"])).mean()
    return loss


def _port_names(jax_grads) -> dict:
    """JAX trainable-tree leaves under the port's parameter names."""
    out = {"cldm.controlnet." + k: v for k, v in from_jax(jax_grads["controlnet"],
                                                           "controlnet").items()}
    out.update({"cldm.vae." + k: v for k, v in from_jax({"decoder": jax_grads["vae_decoder"]},
                                                         "vae").items()})
    return out


def _worst(got: dict, want: dict) -> tuple:
    """The largest relative L2 error over the gradient leaves, with its
    name. Some leaves are zero in exact arithmetic (a bias that a
    one-channel GroupNorm or the wavelet's low-pass removal cancels) and
    hold rounding noise alone, so each leaf's error is relative to its norm
    floored at 1e-3 of the largest leaf's."""
    floor = 1e-3 * max(float(g.norm()) for g in want.values())
    return max((float((got[n] - want[n]).norm()) / max(float(want[n].norm()), floor), n)
               for n in want)


def test_loss_and_gradients_match_jax():
    pipe_j, params = jax_tiny()
    batch, (t, noise) = _batch(), _t_noise()
    trainable, frozen = JS.split_trainable(params, train_decoder=True)
    loss_j, grads_j = compiled_step(jax.value_and_grad(_jax_loss(pipe_j, batch, t, noise)),
                                    trainable, frozen)(trainable, frozen)
    want = _port_names(grads_j)

    pipe = _port()
    state = EDTRTrainState.create(pipe, train_decoder=True)
    step = make_edtr_train_step(pipe)
    loss_t = step.grads(state, _torch(batch), torch.from_numpy(t).long(), nchw(noise))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    got = {n: p.grad for n, p in pipe.named_parameters() if p.requires_grad}
    assert set(got) == set(want)
    worst = _worst(got, want)
    assert worst[0] <= 3e-3, worst


def _replay_t_noise(rng, pipe_j, b):
    """t and noise JAX's step draws from ``rng`` (accum_steps 1): split(rng,
    3)[1] -> split -> (randint over used_timesteps, normal NHWC)."""
    _, r_edtr, _ = jax.random.split(rng, 3)
    rng_t, rng_n = jax.random.split(r_edtr)
    idx = jax.random.randint(rng_t, (b,), 0, len(pipe_j.used_timesteps))
    t = np.asarray(pipe_j.used_timesteps)[np.asarray(idx)]
    noise = jax.random.normal(rng_n, (b, LAT, LAT, 4), jnp.float32)
    return t, np.asarray(noise)


def test_two_steps_match_jax():
    pipe_j, params = jax_tiny()
    batch = _batch(seed=21)
    state_j = JS.EDTRTrainState.create(pipe_j, jax.tree.map(jnp.array, params),
                                       train_steps=100, train_decoder=True)
    step_j = JS.make_edtr_train_step(pipe_j, jit=False)
    pipe = _port()
    state = EDTRTrainState.create(pipe, train_steps=100, train_decoder=True)
    step = make_edtr_train_step(pipe)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step_j = compiled_step(step_j, state_j, jb, jax.random.PRNGKey(100))
    for i in range(2):
        rng = jax.random.PRNGKey(100 + i)
        state_j, m_j = step_j(state_j, jb, rng)
        t, noise = _replay_t_noise(rng, pipe_j, B)
        m_t = step(state, _torch(batch), torch.from_numpy(t).long(), nchw(noise))
        np.testing.assert_allclose(float(m_t["loss_hlf"]), float(m_j["loss_hlf"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    assert state.step == 2 and int(state_j.step) == 2


def test_optimizer_matches_optax():
    pipe_j, params = jax_tiny()
    state_j = JS.EDTRTrainState.create(pipe_j, params, train_steps=10, train_decoder=True)
    trainable, _ = JS.split_trainable(params, train_decoder=True)
    opt_j = state_j.tx_edtr.init(trainable)
    update = jax.jit(state_j.tx_edtr.update)
    pipe = _port()
    state = EDTRTrainState.create(pipe, train_steps=10, train_decoder=True)
    named = dict(pipe.named_parameters())
    g = np.random.default_rng(4)
    for _ in range(5):
        grads = jax.tree.map(lambda x: (g.standard_normal(x.shape) * 0.01).astype(np.float32),
                             trainable)
        updates, opt_j = update(grads, opt_j, trainable)
        trainable = optax.apply_updates(trainable, updates)
        for name, gr in _port_names(grads).items():
            named[name].grad = gr
        state.tx_edtr.step()
        state.schedule.step()
    for name, want in _port_names(trainable).items():
        np.testing.assert_allclose(named[name].detach().numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_step_moves_trainable_and_keeps_frozen():
    pipe = _port()
    state = EDTRTrainState.create(pipe, train_decoder=True)
    trainable, frozen = split_trainable(pipe, True)
    assert all(n.startswith(("cldm.controlnet.", "cldm.vae.decoder.")) for n in trainable)
    for part in ("cldm.unet.", "cldm.vae.encoder.", "cldm.vae.quant_conv.",
                 "cldm.vae.post_quant_conv.", "swinir."):
        assert any(n.startswith(part) for n in frozen), part
    before = {n: p.detach().clone() for n, p in pipe.named_parameters()}
    conv = pipe.cldm.vae.decoder.conv_in
    packed = conv.packed_weight(torch.bfloat16).clone()
    t, noise = _t_noise()
    make_edtr_train_step(pipe)(state, _torch(_batch()), torch.from_numpy(t).long(), nchw(noise))
    for n, p in pipe.named_parameters():
        if n in frozen:
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n
    # the optimizer's in-place update is seen by the cached bf16 copy
    assert not torch.equal(conv.packed_weight(torch.bfloat16), packed)
    torch.testing.assert_close(conv.packed_weight(torch.bfloat16),
                               G.pack_weight(conv.weight, torch.bfloat16), rtol=0, atol=0)
    # with a detnet and its teacher, the state holds SGD over the detnet's
    # trainable parameters (the body's early stages frozen), none of the
    # teacher's
    from edtr_torch.models.faster_rcnn import fasterrcnn_mobilenet_v3_large_fpn

    det = fasterrcnn_mobilenet_v3_large_fpn(num_classes=6, device="cpu")
    teacher = fasterrcnn_mobilenet_v3_large_fpn(num_classes=6, device="cpu")
    state = EDTRTrainState.create(pipe, train_decoder=True, detnet=det, teacher_detnet=teacher)
    sgd = state.tx_detnet.param_groups[0]
    assert isinstance(state.tx_detnet, torch.optim.SGD)
    assert (sgd["momentum"], sgd["weight_decay"]) == (0.9, 1e-4)
    assert {id(p) for p in sgd["params"]} == {id(p) for p in det.parameters() if p.requires_grad}
    assert any(not p.requires_grad for p in det.parameters())
    assert not any(p.requires_grad for p in teacher.parameters())
    with pytest.raises(ValueError, match="teacher"):
        EDTRTrainState.create(pipe, detnet=det)


def _grads(pipe, accum_steps=1, batch=None, t=None, noise=None):
    state = EDTRTrainState.create(pipe, train_decoder=True)
    step = make_edtr_train_step(pipe, accum_steps=accum_steps)
    loss = step.grads(state, batch, t, noise)
    return loss, {n: p.grad.clone() for n, p in pipe.named_parameters() if p.requires_grad}


def test_accum_steps_matches_one_batch():
    batch = _torch(_batch())
    t, noise = _t_noise()
    t, noise = torch.from_numpy(t).long(), nchw(noise)
    pipe = _port()
    loss1, g1 = _grads(pipe, 1, batch, t, noise)
    loss2, g2 = _grads(pipe, 2, batch, t, noise)
    torch.testing.assert_close(loss2, loss1, rtol=1e-5, atol=0)
    # the same per-sample gradients summed in another order: fp32 rounding,
    # largest on the leaves that are zero in exact arithmetic
    worst = _worst(g2, g1)
    assert worst[0] <= 1e-3, worst


def test_step_phases_are_profiler_ranges(tmp_path):
    """The step puts each microbatch's forward+loss and backward, and the
    update, under the ranges ``profile_restore.TRAIN_STAGES`` reads: a trace
    of the step itself splits it, with no copy of the step to time."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from edtr_torch.profile_restore import TRAIN_STAGES, summarise

    pipe = _port()
    state = EDTRTrainState.create(pipe, train_decoder=True)
    step = make_edtr_train_step(pipe, accum_steps=2)
    t, noise = _t_noise()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _torch(_batch()), torch.from_numpy(t).long(), nchw(noise))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    ranges = [e["name"] for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert {s: ranges.count(s) for s in TRAIN_STAGES} == {
        "forward+loss": 2, "sample": 0, "backward": 2, "optimizer": 1}
    stages = summarise(trace, TRAIN_STAGES, runs=1)["stages"]
    assert all(stages[s]["host_ms"] > 0 for s in TRAIN_STAGES if s != "sample"), stages


def test_checkpointing_gives_the_same_gradients():
    batch = _torch(_batch())
    t, noise = _t_noise()
    t, noise = torch.from_numpy(t).long(), nchw(noise)
    loss0, g0 = _grads(_port(use_checkpoint=False), 1, batch, t, noise)
    loss1, g1 = _grads(_port(use_checkpoint=True), 1, batch, t, noise)
    assert float(loss1) == float(loss0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-9, msg=n)


def test_recompute_runs_in_the_forward_configuration(monkeypatch):
    """A backward run outside ``fused_conv()`` still recomputes the ResBlocks
    through the fused wrapper: ``remat`` re-enters the forward's
    configuration."""
    pipe = _port(use_checkpoint=True, fused_conv=True)
    split_trainable(pipe, True)
    seen = []
    phase = ["forward"]
    real = G.gn_silu_conv

    def spy(*args, **kwargs):
        seen.append((phase[0], layers._fused_conv))
        return real(*args, **kwargs)
    monkeypatch.setattr(G, "gn_silu_conv", spy)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 4, LAT, LAT), generator=g)
    cond = dict(c_img=torch.randn((1, 4, LAT, LAT), generator=g),
                c_txt=torch.randn((1,) + CTX, generator=g))
    with pipe.configuration():
        eps = pipe.cldm(x, torch.tensor([200]), cond)
    phase[0] = "backward"
    assert not layers._fused_conv
    eps.square().mean().backward()
    fwd = [c for p, c in seen if p == "forward"]
    bwd = [c for p, c in seen if p == "backward"]
    # every ControlNet ResBlock half is recomputed (trainable); the frozen
    # UNet recomputes only its output blocks, which the control reaches
    assert fwd and all(fwd) and bwd and all(bwd)
    assert len(fwd) > len(bwd) > 0


@pytest.mark.parametrize("param", ["eps", "x0", "v"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses_matches_jax(param, loss_type):
    """The diffusion objective and its v target against ``edtr_tpu``'s, the
    noise replayed from JAX's key; the model a fixed function of (x, t)."""
    from edtr_tpu.diffusion.schedule import Diffusion as JDiffusion

    g = np.random.default_rng(5)
    x0 = g.standard_normal((2, 4, LAT, LAT)).astype(np.float32)
    t = np.array([50, 200], np.int32)
    rng = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(rng, x0.shape, jnp.float32))
    kw = dict(linear_start=0.00085, linear_end=0.0120, parameterization=param,
              loss_type=loss_type)
    jd, td = JDiffusion.create(1000, **kw), Diffusion.create(1000, **kw)

    def model(x, tt, cond):
        return 0.5 * x + 1e-3 * tt.reshape(-1, 1, 1, 1)
    want, xs_j = jd.p_losses(model, jnp.asarray(x0), jnp.asarray(t), {}, rng,
                             return_predicted_x_start=True)
    got, xs_t = td.p_losses(model, torch.from_numpy(x0), torch.from_numpy(t).long(), {},
                            noise=torch.from_numpy(noise), return_predicted_x_start=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        td.get_v(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t).long()),
        np.asarray(jd.get_v(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("emb,res", [(False, False), (True, False), (False, True), (True, True)])
def test_gn_silu_conv_function_backward_matches_plain(emb, res):
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(shape, generator=g).requires_grad_()
    args = [r(2, 32, 8, 8), r(2, 32), r(2, 32), r(64, 32, 3, 3), r(64),
            r(2, 64) if emb else None, r(2, 64, 8, 8) if res else None]
    live = [a for a in args if a is not None]
    out = G.gn_silu_conv(*args)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, live, cot)
    want = torch.autograd.grad(G.plain_gn_silu_conv(*args), live, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("act", [None, "lrelu"])
def test_upsample_conv_function_backward_matches_plain(act):
    g = torch.Generator().manual_seed(2)
    x, w, b = (torch.randn(s, generator=g).requires_grad_()
               for s in ((2, 32, 8, 8), (64, 32, 3, 3), (64,)))
    out = G.upsample_conv(x, w, b, act)
    cot = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (x, w, b), cot)
    want = torch.autograd.grad(G.plain_upsample_conv(x, w, b, act), (x, w, b), cot)
    for a, bb in zip(got, want):
        torch.testing.assert_close(a, bb, rtol=0, atol=0)


def test_fused_proj_step_gives_the_stock_gradients(monkeypatch):
    """The step with ``fused_proj`` on (remat on): the transformer blocks'
    LN + q/k/v, LN + query, GroupNorm-affine + ``proj_in`` and LN + GEGLU
    run through the K7/K8 autograd Functions (the tiny UNet's 64-token
    blocks taken with 64-token tiles, as the tiny-restore tests take them)
    in the forward and again in remat's recompute, and the loss and every
    trainable gradient equal the stock step's to fp32 rounding (the fused
    forms add the GEGLU bias in fp32 before the GELU, the stock one after a
    rounding to the compute dtype, which is fp32 here)."""
    for mod in (LM, GG):
        monkeypatch.setattr(mod, "SEQ_TILE", 64)
    calls = {"forward": 0, "backward": 0}
    phase = ["forward"]
    for mod, name in ((LM, "_ln_matmuls"), (LM, "_affine_matmul")):
        real = getattr(mod, name)

        def spy(*args, _real=real):
            calls[phase[0]] += 1
            return _real(*args)
        monkeypatch.setattr(mod, name, spy)
    batch = _torch(_batch())
    t, noise = _t_noise()
    t, noise = torch.from_numpy(t).long(), nchw(noise)
    loss0, g0 = _grads(_port(use_checkpoint=True), 1, batch, t, noise)
    assert calls == {"forward": 0, "backward": 0}
    pipe = _port(use_checkpoint=True, fused_proj=True)
    state = EDTRTrainState.create(pipe, train_decoder=True)
    step = make_edtr_train_step(pipe)
    real_backward = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        phase[0] = "backward"
        return real_backward(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "backward", backward)
    loss1 = step.grads(state, batch, t, noise)
    g1 = {n: p.grad.clone() for n, p in pipe.named_parameters() if p.requires_grad}
    # the tiny nets' 64-token transformer blocks (ControlNet 1, UNet input 1
    # and output 2; the middle blocks have 16 tokens), 3 K8 calls each
    # (affine, q/k/v, query); the recompute: the ControlNet's and the UNet
    # output blocks'
    assert calls == {"forward": 12, "backward": 9}, calls
    torch.testing.assert_close(loss1, loss0, rtol=1e-5, atol=0)
    worst = _worst(g1, g0)
    assert worst[0] <= 1e-4, worst
