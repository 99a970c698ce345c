"""Training recipes beyond EDTR: the task losses, the optimizers and their
cosine schedule, and the oracle / LQ / frozen-SwinIR task training,
SwinIR pre-training, SR4IR and DiffBIR steps.

Counterpart of ``edtr_tpu/train/recipes.py``. The losses are JAX's
cross-entropy (label smoothing 0) and the segmentation cross-entropy over
the pixels not labelled ``ignore_index`` (255, VOC's border), in fp32 and
in JAX's layouts: logits (B, K) and (B, H, W, K), labels (B,) and masks (B,
H, W).

The nets hold their parameters and running statistics, so a
:class:`SimpleTrainState` holds the trained module, its optimizer and
schedule; a step updates it in place and returns its metrics. The task
hooks are those of :func:`edtr_torch.train.tasks.task_apply_for`:
``loss_fn(net, images, target, generator) -> (loss, metrics)`` in train
mode (its running statistics updated) and ``feats_fn(net, images)`` on the
running statistics, images NCHW in [0, 1]. A batch holds NHWC images in [0,
1] (``lq``, ``gt``), the task's ``target`` and, for DiffBIR, ``c_txt``.
Every random draw of a step is a tensor argument, else drawn from its
``generator``: JAX's in-step key splits become arguments a test replays.

The steps put their phases under ``record_function`` ranges
(:data:`STAGES`): ``pre_restore`` the frozen, no-grad pre-restoration
(SwinIR, and DiffBIR's condition latent); ``forward+loss``, ``backward``
and ``optimizer`` the restoration net's half (SwinIR, or the ControlNet);
``sample`` what is restored again under no grad for the task net (SR4IR's
updated SwinIR and CutMix, DiffBIR's walk from pure noise and decode);
``task`` the task net's whole half. A SwinIR trained or run alone runs in
the pipeline's default conv and Swin configuration
(:func:`swinir_configuration`), its backward too; DiffBIR's nets in their
pipeline's.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from edtr_torch.models.faster_rcnn import detnet_trainable_mask
from edtr_torch.models.layers import fused_conv as conv_config
from edtr_torch.models.layers import fused_swin as swin_config
from edtr_torch.parallel.distributed import average_gradients
from edtr_torch.pipeline import FUSED_CONV_DEFAULT, FUSED_SWIN_DEFAULT
from edtr_torch.train.common import RECIPE_STAGES as STAGES
from edtr_torch.train.common import cosine_schedule, no_param_grads, split_trainable

# builds (optimizer, schedule) over a parameter list: what cosine_tx returns
TxBuilder = Callable[[List[nn.Parameter]],
                     Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``-log_softmax(logits)[label]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def seg_cross_entropy(logits: torch.Tensor, mask: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """The per-pixel cross-entropy of NHWC ``logits`` against ``mask``,
    summed over the pixels not labelled ``ignore_index`` and divided by
    their number (at least 1)."""
    valid = mask != ignore_index
    safe = torch.where(valid, mask, torch.zeros_like(mask)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def cosine_tx(kind: str, lr: float, steps: int, eta_min: float = 1e-7,
              weight_decay: Optional[float] = None) -> TxBuilder:
    """JAX's ``cosine_tx``: what builds the optimizer and its cosine
    schedule (``lr`` to ``eta_min`` over ``steps``) over a parameter list.
    ``"adamw"``: torch's AdamW (betas 0.9/0.999, eps 1e-8, decoupled decay
    1e-2 unless given, optax's ``adamw``); ``"sgd"``: momentum 0.9 with
    coupled decay 1e-4 unless given (optax's ``add_decayed_weights`` before
    ``sgd`` is torch SGD's ``weight_decay``)."""
    if kind == "adamw":
        wd = 1e-2 if weight_decay is None else weight_decay

        def build(params):
            tx = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                   weight_decay=wd)
            return tx, cosine_schedule(tx, lr, steps, eta_min)
        return build
    if kind == "sgd":
        wd = 1e-4 if weight_decay is None else weight_decay

        def build(params):
            tx = torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=wd)
            return tx, cosine_schedule(tx, lr, steps, eta_min)
        return build
    raise ValueError(kind)


@dataclass
class SimpleTrainState:
    """JAX's ``SimpleTrainState``: the trained module (updated in place;
    its BatchNorm running statistics, JAX's ``extra_vars``, stay in its
    buffers), its optimizer and schedule, and the number of updates."""

    module: nn.Module
    tx: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, tx: TxBuilder,
               params: Optional[Iterable[nn.Parameter]] = None) -> "SimpleTrainState":
        """``tx`` (:func:`cosine_tx`) over ``params``; by default the
        module's parameters (not its buffers, JAX's split of ``params`` from
        the other collections) that :func:`detnet_trainable_mask` leaves
        trainable: a detector's frozen stages get no update and no decay,
        as JAX's ``mask_detnet_tx``; any other net trains every one."""
        if params is None:
            mask = detnet_trainable_mask(module)
            params = [p for name, p in module.named_parameters() if mask[name]]
        opt, schedule = tx(list(params))
        return cls(module=module, tx=opt, schedule=schedule)

    def apply_gradients(self) -> None:
        """One update from the gradients in ``.grad`` (averaged over the
        ranks first in a process group: ``parallel.distributed.
        average_gradients``, every recipe's data parallelism), then the
        schedule."""
        average_gradients(p for group in self.tx.param_groups for p in group["params"])
        self.tx.step()
        self.schedule.step()
        self.step += 1


def _nchw(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, torch.float32).permute(0, 3, 1, 2)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


@contextlib.contextmanager
def swinir_configuration(kernel: bool = True) -> Iterator[None]:
    """The conv and Swin configuration a standalone SwinIR runs in
    (``EDTRPipeline.configuration`` for one outside a pipeline): the
    pipeline's defaults, or with ``kernel`` False stock convs and the stock
    SwinIR."""
    with conv_config(kernel and FUSED_CONV_DEFAULT), swin_config(kernel and FUSED_SWIN_DEFAULT):
        yield


def _target(target, device):
    """A batch's target on ``device``: a tensor, or a dict of tensors (a
    detector's padded ``boxes``, ``labels``, ``valid``)."""
    if isinstance(target, dict):
        return {k: v.to(device) for k, v in target.items()}
    return target.to(device)


def _concat(targets):
    if isinstance(targets[0], dict):
        return {k: torch.cat([t[k] for t in targets]) for k in targets[0]}
    return torch.cat(targets)


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def _task_update(state: SimpleTrainState, loss_fn: Callable[[nn.Module], tuple]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The task net's half under the ``task`` range: ``loss_fn(net) ->
    (loss, metrics)``, its backward, the update."""
    with record_function(STAGES[5]):
        state.tx.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.module)
        loss.backward()
        state.apply_gradients()
    return loss.detach(), _detached(metrics)


# -- task-net training (oracle / LQ / frozen-SwinIR input) ------------------------

def make_task_train_step(task_apply: Callable, pre_restore: Optional[Callable] = None,
                         use_gt: bool = False):
    """JAX's ``make_task_train_step``: ``step(state, batch, generator=None)
    -> metrics`` trains ``state.module`` by ``task_apply`` (a task's
    ``loss_fn``) on ``gt`` (``use_gt``, the oracle recipe) or ``lq``,
    passed first through the frozen ``pre_restore`` (NCHW in and out, e.g.
    a SwinIR) under no grad (the train_swinir recipe). Metrics: the loss
    function's and ``loss``."""

    def step(state: SimpleTrainState, batch, generator: Optional[torch.Generator] = None):
        dev = _device(state.module)
        inp = _nchw(batch["gt"] if use_gt else batch["lq"], dev)
        if pre_restore is not None:
            with record_function(STAGES[0]), torch.no_grad(), swinir_configuration():
                inp = pre_restore(inp)
        target = _target(batch["target"], dev)
        loss, metrics = _task_update(
            state, lambda net: task_apply(net, inp, target, generator))
        return dict(metrics, loss=loss)

    return step


# -- SwinIR pre-restoration training ----------------------------------------------

def _swinir_update(state: SimpleTrainState, loss_fn: Callable[[], tuple]
                   ) -> Tuple[torch.Tensor, Dict]:
    """SwinIR's half: ``loss_fn() -> (loss, metrics)`` and its backward in
    the default configuration, the update."""
    state.tx.zero_grad(set_to_none=True)
    with swinir_configuration():
        with record_function(STAGES[1]):
            loss, metrics = loss_fn()
        with record_function(STAGES[2]):
            loss.backward()
    with record_function(STAGES[3]):
        state.apply_gradients()
    return loss.detach(), _detached(metrics)


def swinir_pre_loss(swinir: nn.Module, lq: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The L1 of ``swinir(lq)`` against ``gt`` (NCHW) times 255."""
    return (swinir(lq) - gt).abs().mean() * 255.0


def make_swinir_pre_train_step(swinir: nn.Module):
    """JAX's ``make_swinir_pre_train_step``: ``step(state, batch) ->
    {"loss"}`` (:func:`swinir_pre_loss`)."""

    def step(state: SimpleTrainState, batch):
        dev = _device(swinir)
        lq, gt = _nchw(batch["lq"], dev), _nchw(batch["gt"], dev)
        loss, _ = _swinir_update(state, lambda: (swinir_pre_loss(swinir, lq, gt), {}))
        return dict(loss=loss)

    return step


# -- SR4IR ------------------------------------------------------------------------

def cutmix_mask(cells: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, n, n, 1) cells to a (B, 1, h, w) mask by nearest resizing
    (``jax.image.resize(..., "nearest")``: exact repeats where n divides h
    and w)."""
    n_h, n_w = cells.shape[1:3]
    iy = ((torch.arange(h, device=cells.device) + 0.5) * n_h / h).floor().long()
    ix = ((torch.arange(w, device=cells.device) + 0.5) * n_w / w).floor().long()
    return cells[:, iy][:, :, ix].permute(0, 3, 1, 2)


def sr4ir_swinir_loss(swinir: nn.Module, net: nn.Module, task_apply_feats: Callable,
                      lq: torch.Tensor, gt: torch.Tensor, pix_weight: float
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SR4IR's SwinIR loss (NCHW): ``pix_weight`` times the L1 of ``res =
    swinir(lq)`` against gt plus the task-driven perceptual L1 of ``net``'s
    features of ``res`` against those of gt (no gradient). Returns (loss,
    {swinir_pix, swinir_tdp})."""
    res = swinir(lq)
    pix = (res - gt).abs().mean() * pix_weight
    with torch.no_grad():
        f_gt = task_apply_feats(net, gt)
    tdp = (task_apply_feats(net, res).float() - f_gt.float()).abs().mean()
    return pix + tdp, dict(swinir_pix=pix, swinir_tdp=tdp)


def sr4ir_task_images(res: torch.Tensor, gt: torch.Tensor, cells: torch.Tensor
                      ) -> torch.Tensor:
    """``[res, gt, CutMix(res, gt)]`` (NCHW), the mix ``res`` where the
    cells, upsampled by nearest (:func:`cutmix_mask`), are 1."""
    mask = cutmix_mask(cells.to(gt.device, gt.dtype), *gt.shape[-2:])
    return torch.cat([res, gt, res * mask + gt * (1 - mask)])


def make_sr4ir_train_step(swinir: nn.Module, task_apply_feats: Callable,
                          task_apply_loss: Callable, pix_weight: float = 255.0,
                          cutmix_cells: int = 8):
    """JAX's ``make_sr4ir_train_step``: ``step((sw_state, task_state),
    batch, cells=None, generator=None) -> metrics``.

    SwinIR's half first: ``pix_weight`` times the L1 of ``res = swinir(lq)``
    against gt, plus the task-driven perceptual L1 of the task net's
    features of ``res`` against those of gt (no gradient); the task net
    takes no gradient there. The SwinIR is updated. Then the task net's
    half: cross-entropy over ``[res, gt, CutMix(res, gt)]`` with the target
    three times, ``res`` recomputed by the updated SwinIR under no grad;
    the mix takes ``res`` where the ``cells`` (B, ``cutmix_cells``,
    ``cutmix_cells``, 1), 0 or 1, upsampled by nearest, are 1 (drawn with
    probability 0.5 from ``generator`` when not given). Metrics:
    ``swinir_pix``, ``swinir_tdp``, the task loss's and ``task_loss``."""
    def step(states: Tuple[SimpleTrainState, SimpleTrainState], batch,
             cells: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        sw_state, task_state = states
        net = task_state.module
        dev = _device(swinir)
        lq, gt = _nchw(batch["lq"], dev), _nchw(batch["gt"], dev)

        with no_param_grads(net):
            _, sw_m = _swinir_update(
                sw_state, lambda: sr4ir_swinir_loss(swinir, net, task_apply_feats, lq, gt,
                                                    pix_weight))

        with record_function(STAGES[4]), torch.no_grad():
            with swinir_configuration():
                res = swinir(lq)
            if cells is None:
                cells = torch.bernoulli(torch.full((gt.shape[0], cutmix_cells, cutmix_cells, 1),
                                                   0.5, device=dev), generator=generator)
            images = sr4ir_task_images(res, gt, cells)
            target = _concat([_target(batch["target"], dev)] * 3)
        t_loss, t_m = _task_update(
            task_state, lambda net: task_apply_loss(net, images, target, generator))
        return {**sw_m, **t_m, "task_loss": t_loss}

    return step


# -- DiffBIR ----------------------------------------------------------------------

def diffbir_eps_loss(pipe: nn.Module, z_pre: torch.Tensor, gt: torch.Tensor,
                     c_txt: torch.Tensor, t: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     posterior_noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DiffBIR's stage-1 loss, in the pipeline's configuration: the eps
    objective ``p_losses`` on ``z_0``, the sample of gt's (NCHW) posterior
    with ``posterior_noise``, at ``t`` (B,) uniform over the process, with
    ``noise``, conditioned on ``z_pre`` and ``c_txt``; each draw not given
    comes from ``generator``."""
    dev = z_pre.device
    with pipe.configuration():
        with torch.no_grad():
            z_0 = pipe.cldm.vae_encode(gt * 2 - 1, sample=True, noise=posterior_noise,
                                       generator=generator)
        if t is None:
            t = torch.randint(0, pipe.diffusion.num_timesteps, (gt.shape[0],),
                              generator=generator, device=dev)
        return pipe.diffusion.p_losses(pipe.cldm, z_0, t.to(dev),
                                       dict(c_txt=c_txt, c_img=z_pre),
                                       None if noise is None else noise.to(dev, z_0.dtype),
                                       generator)


@torch.no_grad()
def diffbir_sample(pipe: nn.Module, steps: int, z_pre: torch.Tensor, pre_res: torch.Tensor,
                   c_txt: torch.Tensor, x_T: Optional[torch.Tensor] = None,
                   step_noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DiffBIR's stage-2 images (NCHW): the ``steps``-step walk from pure
    noise ``x_T`` conditioned on ``z_pre`` and ``c_txt``, decoded and
    wavelet-fixed against ``pre_res``, in the pipeline's configuration."""
    with pipe.configuration():
        z = pipe.sampler.sample(pipe.cldm, steps, z_pre.shape[1:],
                                dict(c_txt=c_txt, c_img=z_pre), batch_size=z_pre.shape[0],
                                x_T=x_T, step_noise=step_noise, generator=generator)
    return pipe.decode(z, pre_res)


def make_diffbir_train_step(pipe: nn.Module, task_apply_loss: Callable,
                            task_apply_feats: Callable, steps: int = 50,
                            weight_ce: float = 1.0, weight_fm: float = 0.2):
    """JAX's ``make_diffbir_train_step``: ``step((cldm_state, task_state,
    teacher), batch, t=None, noise=None, posterior_noise=None, x_T=None,
    step_noise=None, generator=None) -> metrics``. ``cldm_state`` trains
    the pipeline's ControlNet (:func:`diffbir_state`); ``teacher`` is the
    frozen task net.

    Stage 1 (:func:`diffbir_eps_loss`): the eps objective at ``t`` with
    ``noise`` on gt's posterior sample; the condition is the pre-restored
    lq's posterior mode and ``c_txt``, neither taking a gradient. Only the
    ControlNet trains (``split_trainable(train_decoder=False)``). Stage 2
    (:func:`diffbir_sample`): the first ``bs2 = max(B // 2, 1)`` images
    walk ``steps`` spaced steps from pure noise ``x_T`` (bs2, 4, h, w) with
    ``step_noise`` (steps, bs2, 4, h, w) on the updated ControlNet under no
    grad; the task net trains on ``[restored ; gt[bs2:]]``: ``weight_ce``
    times its loss plus ``weight_fm`` times the L1 of its features (on the
    running statistics the step starts from) against the teacher's of gt.
    The draws not given come from ``generator``. Metrics: ``loss_eps``,
    the task loss's, ``loss_ce`` and ``loss_fm``."""
    def step(states, batch, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             posterior_noise: Optional[torch.Tensor] = None,
             x_T: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        cldm_state, task_state, teacher = states
        dev = pipe.device
        lq, gt = _nchw(batch["lq"], dev), _nchw(batch["gt"], dev)
        c_txt = batch["c_txt"].to(dev, torch.float32)
        with record_function(STAGES[0]):
            pre_res = pipe.pre_restore(lq)
            z_pre = pipe.encode(pre_res)
        split_trainable(pipe, train_decoder=False)
        cldm_state.tx.zero_grad(set_to_none=True)
        with record_function(STAGES[1]):
            loss_eps = diffbir_eps_loss(pipe, z_pre, gt, c_txt, t, noise, posterior_noise,
                                        generator)
        with record_function(STAGES[2]), pipe.configuration():
            loss_eps.backward()
        with record_function(STAGES[3]):
            cldm_state.apply_gradients()

        bs2 = max(gt.shape[0] // 2, 1)
        with record_function(STAGES[4]):
            res = diffbir_sample(pipe, steps, z_pre[:bs2], pre_res[:bs2], c_txt[:bs2], x_T,
                                 step_noise, generator)
        images = torch.cat([res, gt[bs2:]])
        target = _target(batch["target"], dev)

        def task_loss(net):
            f_s = task_apply_feats(net, images)  # before the loss updates the statistics
            loss_ce, metrics = task_apply_loss(net, images, target, generator)
            with torch.no_grad():
                f_t = task_apply_feats(teacher, gt)
            loss_fm = weight_fm * (f_s.float() - f_t.float()).abs().mean()
            return weight_ce * loss_ce + loss_fm, dict(metrics, loss_ce=loss_ce,
                                                       loss_fm=loss_fm)

        _, tm = _task_update(task_state, task_loss)
        return dict(loss_eps=loss_eps.detach(), **tm)

    return step


def diffbir_state(pipe: nn.Module, tx: TxBuilder) -> SimpleTrainState:
    """JAX's DiffBIR ``cldm_state``: ``tx`` over the ControlNet, the
    trainable part of ``split_trainable(train_decoder=False)``."""
    trainable, _ = split_trainable(pipe, train_decoder=False)
    return SimpleTrainState.create(pipe, tx, list(trainable.values()))
