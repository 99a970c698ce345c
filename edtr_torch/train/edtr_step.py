"""EDTR training step of the port: the two alternating updates.

Counterpart of ``edtr_tpu/train/edtr_step.py`` (``make_edtr_train_step``
and ``make_edtr_generic_train_step``):

* **EDTR half**: AdamW (lr 1e-4, cosine to 1e-7, weight decay 1e-2) over
  the ControlNet and, with ``train_decoder``, the VAE decoder::

    pre_res  = swinir(lq); z_pre = vae_encode(pre_res*2-1)   # frozen, no grad
    t        = used_timesteps[randint]                        # per sample
    x_pred   = diffusion.reverse(cldm, t, z_pre, cond, noise)["x_pred"]
    restored = wavelet_reconstruction((vae_decode(x_pred)+1)/2, pre_res)
    loss_hlf = weight_hlf * (L1 of the student task net's features on
               restored vs gt + the same for the frozen teacher's)

  without a task net, ``weight_hlf * L1(restored, gt)`` (or
  ``hlf_loss_fn``). The task nets' feature passes run their norms on
  running statistics, those of gt under no grad; no gradient of this loss
  reaches a task-net parameter. A detector's features are its FPN maps
  '0' and '1' (each L1 halved), recomputed in the backward
  (``torch.utils.checkpoint``); a classification or segmentation net's are
  the map its ``task_feats_fn`` gives (:mod:`edtr_torch.train.tasks`).
* **task-net half**, after the AdamW update, on the updated ControlNet:
  SGD (lr 5e-3, momentum 0.9, weight decay 1e-4, cosine to 1e-7) over the
  task-net parameters (a detector's: those ``detnet_trainable_mask`` leaves
  trainable; a classification or segmentation net's: all). Under no grad
  the first ``bs2 = max(bs // 2, 1)`` images (of the global batch in a
  process group: :func:`restored_rows`) are noised to
  ``start_timestep``, walked down by the sampler and decoded (the
  ``sample`` range); the task net then trains on ``[restored ;
  gt[bs2:]]`` with the batch's target (norms on batch statistics, their
  running ones updated):

  - detector (:class:`DetHalf`, the batch's ``targets``): ``loss_det =
    weight_det * (its four losses)`` plus ``loss_fm = weight_fm * L1`` of
    its FPN maps from that same call against the teacher's on gt;
  - classification or segmentation (:class:`GenericHalf`, the batch's
    ``target``: labels or masks): ``weight_task * loss_task`` plus
    ``loss_fm = weight_fm * L1`` of its features, in a second pass on the
    running statistics the loss's call has just updated, against the
    teacher's on gt.

``accum_steps=K`` splits the batch into K microbatches: the frozen shared
activations (pre_res, z_pre) are made once per microbatch and reused by
both halves; each half takes the mean of the microbatches' mean gradients
before its one update, and the task net's running statistics update
microbatch by microbatch (JAX's global-batch semantics on one card). The
step runs its forwards and backwards inside ``pipe.configuration()``, so
the recomputes of ``use_checkpoint`` see the kernels their forward ran.

Over several processes (``edtr_torch.parallel``) each rank steps on its
own rows, and global microbatch k is the ranks' k-th microbatches, rank
0's first (with one microbatch: rank 0's rows, then rank 1's, JAX's global
batch). Each half averages its gradients over the ranks before its
update, the task nets' train-mode BatchNorms reduce their statistics over
them, the task-net half restores the first half of each global
microbatch (:func:`restored_rows`), and the draws a rank makes are its
rows of the global microbatch's (:func:`parallel.distributed.rank_rows`),
drawn from a ``generator`` seeded alike on every rank. So the update is
the one-process update on the global batch laid out microbatch by
microbatch, but for a detector's sampler uniforms, which each rank draws
for its own images (their shapes follow its proposals), from a generator
forked from the shared one per microbatch.

Every random draw can be given: t and noise of the EDTR half, and per
microbatch of the task-net half the q_sample noise, the walk's step noises
and, for a detector, the sampler's uniforms (:meth:`EDTRTrainStep.task_draw`);
each one not given is drawn from one ``generator``.

Partition (``split_trainable``, JAX's parity): trainable are
``cldm.controlnet.*`` and, with ``train_decoder``, ``cldm.vae.decoder.*``;
frozen are the UNet, the CLIP tower, the VAE encoder, ``quant_conv``,
``post_quant_conv`` (outside the decoder subtree) and SwinIR, as
``requires_grad`` flags. :func:`cast_frozen_bf16` stores the frozen ones
(and a teacher task net) in bf16. Images are NHWC in [0, 1] in the batch,
as JAX's; the noise and the restored image the loss sees are NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from edtr_torch.models.faster_rcnn import detnet_trainable_mask
from edtr_torch.models.layers import remat
from edtr_torch.parallel.distributed import average_gradients, process_rank, rank_rows
# the step's phases, each under a ``record_function`` range of this name
# (``edtr_torch.profile_restore`` reads them from a trace)
from edtr_torch.train.common import TRAIN_STAGES as STAGES
from edtr_torch.train.common import cosine_schedule, no_param_grads, split_trainable
from edtr_torch.train.tasks import det_losses
from edtr_torch.utils.image import wavelet_reconstruction

Batch = Dict[str, torch.Tensor]
# the FPN maps the HLF and feature-matching losses compare: [-3:-1] of
# ('0', '1', 'pool')
FEATURE_KEYS = ("0", "1")


def _bf16_(module: nn.Module, buffers: bool = False) -> None:
    """Every fp32 parameter (and with ``buffers`` every fp32 persistent
    buffer) of ``module`` stored in bf16, in place."""
    with torch.no_grad():
        tensors = list(module.parameters())
        if buffers:
            tensors += [b for name, b in module.named_buffers()
                        if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")]
        for t in tensors:
            if t.dtype == torch.float32:
                t.data = t.data.to(torch.bfloat16)


def cast_frozen_bf16(pipe: nn.Module, train_decoder: bool = True,
                     teacher_detnet: Optional[nn.Module] = None) -> None:
    """JAX's ``cast_frozen_bf16``: the modules that never receive updates
    keep their weights in bf16 (no fp32 masters): the UNet, the CLIP tower,
    SwinIR, the teacher task net (its BatchNorm running statistics too) and
    the VAE, all but the decoder when it trains. The modules compute in
    their ``dtype`` whatever their storage, and every norm and bias that
    needs fp32 casts it (``.float()``), as JAX's counterparts do; the
    kernels' cached bf16 weights are made anew from the cast ones."""
    cldm = pipe.cldm
    for module in (cldm.unet, cldm.clip, pipe.swinir):
        if module is not None:
            _bf16_(module)
    for name, child in cldm.vae.named_children():
        if not (train_decoder and name == "decoder"):
            _bf16_(child)
    if teacher_detnet is not None:
        _bf16_(teacher_detnet, buffers=True)


@dataclass
class EDTRTrainState:
    """The pipeline (its trainable parameters updated in place), the EDTR
    optimizer and its schedule, the task net (a detector, or a
    classification or segmentation net, in the ``detnet`` slot as JAX's
    runner puts it), its teacher, their optimizer and schedule (None
    without a task net), and the number of updates."""

    pipe: nn.Module
    tx_edtr: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR
    detnet: Optional[nn.Module] = None
    teacher_detnet: Optional[nn.Module] = None
    tx_detnet: Optional[torch.optim.SGD] = None
    schedule_detnet: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    step: int = 0

    @classmethod
    def create(cls, pipe: nn.Module, learning_rate_edtr: float = 1e-4,
               train_steps: int = 10000, train_decoder: Optional[bool] = None,
               detnet: Optional[nn.Module] = None,
               teacher_detnet: Optional[nn.Module] = None,
               learning_rate_detnet: float = 5e-3) -> "EDTRTrainState":
        """AdamW (betas 0.9/0.999, eps 1e-8, weight decay 1e-2: torch's
        defaults, as the reference passes lr only) with the cosine schedule
        from ``learning_rate_edtr`` to 1e-7 over ``train_steps``, over
        :func:`split_trainable`. ``train_decoder`` defaults to the VAE's
        flag. With ``detnet`` (and its frozen ``teacher_detnet``): SGD
        (momentum 0.9, weight decay 1e-4) with the cosine schedule from
        ``learning_rate_detnet`` to 1e-7 over the detnet parameters
        :func:`detnet_trainable_mask` leaves trainable (every one of a net
        that is not a Faster R-CNN); the frozen stages get neither an
        update nor decay."""
        if (detnet is None) != (teacher_detnet is None):
            raise ValueError("the task-net half needs both a detnet and its teacher")
        if train_decoder is None:
            train_decoder = pipe.cldm.vae.train_decoder
        trainable, _ = split_trainable(pipe, train_decoder)
        tx = torch.optim.AdamW(list(trainable.values()), lr=learning_rate_edtr,
                               betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
        state = cls(pipe=pipe, tx_edtr=tx,
                    schedule=cosine_schedule(tx, learning_rate_edtr, train_steps))
        if detnet is not None:
            mask = detnet_trainable_mask(detnet)
            teacher_detnet.requires_grad_(False)
            params = [p for name, p in detnet.named_parameters() if mask[name]]
            tx_d = torch.optim.SGD(params, lr=learning_rate_detnet, momentum=0.9,
                                   weight_decay=1e-4)
            state.detnet, state.teacher_detnet, state.tx_detnet = detnet, teacher_detnet, tx_d
            state.schedule_detnet = cosine_schedule(tx_d, learning_rate_detnet, train_steps)
        return state


def _feat_l1(fa: Dict[str, torch.Tensor], fb: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum((fa[k].float() - fb[k].float()).abs().mean() * 0.5 for k in FEATURE_KEYS)


class TaskHalf:
    """What the two halves need of a task net: the student (trained by
    SGD), its frozen teacher, the HLF's feature L1 (:meth:`hlf`, before
    ``weight_hlf``) and the task-net half's loss on ``[restored ;
    gt[bs2:]]`` (:meth:`loss`). ``target_key``: the batch entry the loss
    reads."""

    target_key = ""

    def __init__(self, student: nn.Module, teacher: nn.Module, weight_fm: float):
        self.student, self.teacher, self.weight_fm = student, teacher, weight_fm

    def feats(self, net: nn.Module, images: torch.Tensor):
        raise NotImplementedError

    def feat_l1(self, fa, fb) -> torch.Tensor:
        raise NotImplementedError

    def hlf(self, res: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """The student's and the teacher's feature L1 of ``res`` against
        ``gt`` (gt's features under no grad)."""
        loss = 0.0
        for net in (self.student, self.teacher):
            with torch.no_grad():
                f_gt = self.feats(net, gt)
            loss = loss + self.feat_l1(self.feats(net, res), f_gt)
        return loss

    def loss(self, images: torch.Tensor, gt: torch.Tensor, target, draws: Dict[str, object],
             generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError


class DetHalf(TaskHalf):
    """The detector's half (JAX's ``make_edtr_train_step`` with a
    ``detnet``): FPN maps '0', '1' on running statistics, recomputed in the
    backward (JAX's ``jax.checkpoint`` of ``det_feats``); the loss of
    ``detnet_loss``. Its draws may carry the sampler's ``uniforms``."""

    target_key = "targets"

    def __init__(self, detnet: nn.Module, teacher: nn.Module, weight_det: float,
                 weight_fm: float):
        super().__init__(detnet, teacher, weight_fm)
        self.weight_det = weight_det

    def feats(self, net: nn.Module, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return remat(net.features, images)

    def feat_l1(self, fa, fb) -> torch.Tensor:
        return _feat_l1(fa, fb)

    def loss(self, images, gt, target, draws, generator):
        losses, feats = det_losses(self.student, images, target, generator,
                                   draws.get("uniforms"))
        loss_det = self.weight_det * sum(losses.values())
        with torch.no_grad():
            tf_gt = self.feats(self.teacher, gt)
        loss_fm = self.weight_fm * _feat_l1(feats, tf_gt)
        metrics = dict(loss_det=loss_det.detach(), loss_fm=loss_fm.detach(),
                       **{k: v.detach() for k, v in losses.items()})
        return loss_det + loss_fm, metrics


class GenericHalf(TaskHalf):
    """A classification or segmentation net's half (JAX's
    ``make_edtr_generic_train_step``): ``task_feats_fn(net, images)`` the
    feature map on running statistics, ``task_loss_fn(net, images, target)
    -> (loss, metrics)`` the train-mode loss, which updates the running
    statistics that the feature matching then reads
    (:mod:`edtr_torch.train.tasks`)."""

    target_key = "target"

    def __init__(self, student: nn.Module, teacher: nn.Module, task_feats_fn: Callable,
                 task_loss_fn: Callable, weight_task: float, weight_fm: float):
        super().__init__(student, teacher, weight_fm)
        self.feats_fn, self.loss_fn, self.weight_task = task_feats_fn, task_loss_fn, weight_task

    def feats(self, net: nn.Module, images: torch.Tensor) -> torch.Tensor:
        return self.feats_fn(net, images)

    def feat_l1(self, fa, fb) -> torch.Tensor:
        return (fa.float() - fb.float()).abs().mean()

    def loss(self, images, gt, target, draws, generator):
        loss_task, metrics = self.loss_fn(self.student, images, target)
        f_s = self.feats(self.student, images)
        with torch.no_grad():
            f_t = self.feats(self.teacher, gt)
        loss_fm = self.weight_fm * self.feat_l1(f_s, f_t)
        metrics = dict(metrics, loss_task=loss_task.detach(), loss_fm=loss_fm.detach())
        return self.weight_task * loss_task + loss_fm, metrics


class EDTRTrainStep:
    """The update of :func:`make_edtr_train_step` and
    :func:`make_edtr_generic_train_step`; its parts (:meth:`shared`,
    :meth:`draw`, :meth:`restored`, :meth:`hlf`, :meth:`loss`,
    :meth:`grads`, :meth:`task_draw`, :meth:`task_loss`,
    :meth:`task_grads`) are public so a caller can compare them; a trace
    splits the step by the ranges of :data:`STAGES`. ``task``: the task
    net's half, None for the restoration-only step."""

    def __init__(self, pipe: nn.Module, task: Optional[TaskHalf] = None,
                 weight_hlf: float = 0.5,
                 hlf_loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]
                 = None, accum_steps: int = 1):
        self.pipe, self.task = pipe, task
        self.weight_hlf, self.hlf_loss_fn = weight_hlf, hlf_loss_fn
        self.accum_steps = int(accum_steps)
        self.used_ts = torch.tensor(pipe.used_timesteps, dtype=torch.long, device=pipe.device)

    @torch.no_grad()
    def shared(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        """JAX's ``_shared_for``: (gt, pre_res, z_pre, c_txt), NCHW, from
        the frozen SwinIR and VAE encoder under no grad."""
        dev = self.pipe.device
        pre_res = self.pipe.pre_restore(batch["lq"].to(dev, torch.float32).permute(0, 3, 1, 2))
        z_pre = self.pipe.encode(pre_res)
        gt = batch["gt"].to(dev, torch.float32).permute(0, 3, 1, 2)
        return gt, pre_res, z_pre, batch["c_txt"].to(dev, torch.float32)

    def draw(self, z_pre: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, noise) for a microbatch: t from ``used_timesteps``, noise like
        ``z_pre``, both from ``generator``; in a process group this rank's
        rows of the global microbatch's draws."""
        m, world = z_pre.shape[0], process_rank()[1]
        idx = torch.randint(0, len(self.used_ts), (world * m,), generator=generator,
                            device=z_pre.device)
        noise = torch.randn((world * m,) + tuple(z_pre.shape[1:]), generator=generator,
                            device=z_pre.device, dtype=z_pre.dtype)
        rows = rank_rows(m)
        return self.used_ts[idx[rows]], noise[rows]

    def restored(self, shared: Tuple[torch.Tensor, ...], t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """The EDTR half's restored image (NCHW) at given t and NCHW noise:
        one-step reverse, decode, wavelet fix."""
        pipe = self.pipe
        _, pre_res, z_pre, c_txt = shared
        out = pipe.diffusion.reverse(pipe.cldm, t.to(z_pre.device), z_pre,
                                     dict(c_txt=c_txt, c_img=z_pre),
                                     noise=noise.to(z_pre.device, z_pre.dtype))
        decoded = (pipe.cldm.vae_decode(out["x_pred"]) + 1) / 2
        return wavelet_reconstruction(decoded, pre_res)

    def hlf(self, res: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """The HLF loss of a restored image against gt: the task half's
        feature L1 (:meth:`TaskHalf.hlf`), else the pixel L1 (or
        ``hlf_loss_fn``), times ``weight_hlf``."""
        if self.task is not None:
            return self.weight_hlf * self.task.hlf(res, gt)
        if self.hlf_loss_fn is not None:
            return self.weight_hlf * self.hlf_loss_fn(res, gt)
        return self.weight_hlf * (res - gt).abs().mean()

    def loss(self, shared: Tuple[torch.Tensor, ...], t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
        """JAX's ``edtr_loss`` at given t and NCHW noise."""
        return self.hlf(self.restored(shared, t, noise), shared[0])

    def _microbatches(self, batch: Batch) -> List[Batch]:
        k = self.accum_steps
        n = batch["lq"].shape[0]
        if n % k:
            raise ValueError(f"batch of {n} does not split into {k} microbatches")
        m = n // k
        return [{key: _slice(v, slice(i * m, (i + 1) * m)) for key, v in batch.items()}
                for i in range(k)]

    def grads(self, state: EDTRTrainState, batch: Batch, t: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The EDTR half: the mean over ``accum_steps`` microbatches of
        their loss and mean gradients, the gradients left in the trainable
        parameters' ``.grad`` (set anew). ``t`` (B,) and ``noise`` (B, 4, h,
        w) cover the whole batch; each is drawn from ``generator`` per
        microbatch when not given. Each microbatch's shared activations,
        forward and loss, and its backward, run under the
        ``record_function`` ranges of :data:`STAGES`. Returns the mean loss
        (detached)."""
        return self._edtr_half(state, batch, t, noise, generator)[0]

    def _edtr_half(self, state: EDTRTrainState, batch: Batch, t: Optional[torch.Tensor],
                   noise: Optional[torch.Tensor], generator: Optional[torch.Generator]
                   ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, ...]]]:
        """:meth:`grads`, and each microbatch's :meth:`shared` for the
        task-net half."""
        k = self.accum_steps
        micro = self._microbatches(batch)
        m = batch["lq"].shape[0] // k
        state.tx_edtr.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.pipe.device)
        shared = []
        student = None if self.task is None else self.task.student
        with self.pipe.configuration(), no_param_grads(student):
            for i in range(k):
                sl = slice(i * m, (i + 1) * m)
                with record_function(STAGES[0]):
                    shared.append(self.shared(micro[i]))
                    t_i, noise_i = ((t[sl], noise[sl]) if t is not None and noise is not None
                                    else self.draw(shared[i][2], generator))
                    loss = self.loss(shared[i], t_i, noise_i)
                with record_function(STAGES[2]):
                    (loss / k).backward()
                total += loss.detach() / k
        return total, shared

    def task_draw(self, shared: Tuple[torch.Tensor, ...], generator: Optional[torch.Generator]
                  = None) -> Dict[str, object]:
        """The task-net half's draws for a microbatch: ``noise`` (bs2, 4, h,
        w) of the q_sample and ``step_noise`` (K, bs2, 4, h, w) of the walk,
        bs2 = :func:`restored_rows`, from ``generator`` (in a process group
        this rank's rows of the global microbatch's draws), and with a
        ``generator`` the ``sampler_generator`` that a detector draws its
        sampler's uniforms from: seeded from ``generator`` and the rank."""
        z = shared[2]
        m, (rank, world) = z.shape[0], process_rank()
        bs2, k = max(world * m // 2, 1), len(self.pipe.used_timesteps)
        noise = torch.randn((bs2,) + tuple(z.shape[1:]), generator=generator, device=z.device,
                            dtype=z.dtype)
        step_noise = torch.randn((k, bs2) + tuple(z.shape[1:]), generator=generator,
                                 device=z.device, dtype=z.dtype)
        mine = slice(rank * m, rank * m + restored_rows(m))
        draws = dict(noise=noise[mine], step_noise=step_noise[:, mine])
        if generator is not None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            draws["sampler_generator"] = torch.Generator(generator.device).manual_seed(
                seed + rank)
        return draws

    def task_loss(self, shared: Tuple[torch.Tensor, ...], target, draws: Dict[str, object],
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """JAX's ``detnet_loss`` / generic ``task_loss`` for a microbatch at
        given draws: the walk and decode under no grad (the ``sample``
        range) of its first :func:`restored_rows`, then the task net's loss
        on ``[restored ; gt[bs2:]]`` with ``target`` (:meth:`TaskHalf.loss`,
        the ``forward+loss`` range). Returns (loss, metrics)."""
        pipe = self.pipe
        gt, pre_res, z_pre, c_txt = shared
        bs2 = restored_rows(gt.shape[0])
        images = gt[bs2:]
        if bs2:
            with record_function(STAGES[1]):
                z = pipe.denoise(z_pre[:bs2], c_txt[:bs2], draws["noise"], draws["step_noise"],
                                 generator)
                images = torch.cat([pipe.decode(z, pre_res[:bs2]), images])
        with record_function(STAGES[0]):
            return self.task.loss(images, gt, target, draws,
                                  draws.get("sampler_generator", generator))

    def task_grads(self, state: EDTRTrainState, batch: Batch,
                   shared: Sequence[Tuple[torch.Tensor, ...]],
                   draws: Optional[Sequence[Dict[str, object]]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The task-net half: the mean over the microbatches of their
        metrics and mean task-net gradients (left in ``.grad``, set anew),
        the running statistics updated microbatch by microbatch.
        ``draws``: each microbatch's :meth:`task_draw`, drawn from
        ``generator`` when not given."""
        k = self.accum_steps
        micro = self._microbatches(batch)
        state.tx_detnet.zero_grad(set_to_none=True)
        totals: Dict[str, torch.Tensor] = {}
        with self.pipe.configuration():
            for i in range(k):
                d = draws[i] if draws is not None else self.task_draw(shared[i], generator)
                loss, metrics = self.task_loss(shared[i], micro[i][self.task.target_key], d,
                                               generator)
                with record_function(STAGES[2]):
                    (loss / k).backward()
                for name, v in metrics.items():
                    totals[name] = totals.get(name, 0.0) + v / k
        return totals

    def __call__(self, state: EDTRTrainState, batch: Batch,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 task_draws: Optional[Sequence[Dict[str, object]]] = None
                 ) -> Dict[str, torch.Tensor]:
        """One update: :meth:`grads`, AdamW and its schedule (under the
        ``optimizer`` range); with a task net then :meth:`task_grads` on
        the updated ControlNet, SGD and its schedule. In a process group
        each half's gradients are averaged over the ranks before its update
        (``parallel.distributed.average_gradients``), and the metrics are
        this rank's. The shared
        activations are made once per microbatch for both halves. Returns
        ``{"loss_hlf": ...}`` and the task half's metrics (means over the
        microbatches): a detector's ``loss_det``, ``loss_fm`` and its four
        losses; a classification or segmentation net's ``loss_task`` and
        ``loss_fm``."""
        student = None if self.task is None else self.task.student
        if student is not state.detnet:
            raise ValueError("the step and its state hold different task nets")
        loss, shared = self._edtr_half(state, batch, t, noise, generator)
        metrics = {"loss_hlf": loss}
        with record_function(STAGES[3]):
            average_gradients(_params(state.tx_edtr))
            state.tx_edtr.step()
            state.schedule.step()
        if self.task is not None:
            metrics.update(self.task_grads(state, batch, shared, task_draws, generator))
            with record_function(STAGES[3]):
                average_gradients(_params(state.tx_detnet))
                state.tx_detnet.step()
                state.schedule_detnet.step()
        state.step += 1
        return metrics


def restored_rows(m: int) -> int:
    """How many of a microbatch's ``m`` rows the task-net half restores:
    JAX's bs2 = max(G // 2, 1) of the global microbatch of G = world·m
    rows, of which rank r holds rows r·m .. (r+1)·m (the first ranks
    restore, the last train on gt); max(m // 2, 1) in one process."""
    rank, world = process_rank()
    return min(max(max(world * m // 2, 1) - rank * m, 0), m)


def _params(tx: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in tx.param_groups for p in group["params"]]


def _slice(v, sl: slice):
    """A microbatch of a batch entry: a tensor, or a dict of tensors (the
    targets)."""
    return {k: x[sl] for k, x in v.items()} if isinstance(v, dict) else v[sl]


def make_edtr_train_step(pipe: nn.Module, detnet: Optional[nn.Module] = None,
                         teacher_detnet: Optional[nn.Module] = None, weight_hlf: float = 0.5,
                         weight_det: float = 1.0, weight_fm: float = 0.2,
                         hlf_loss_fn: Optional[Callable] = None,
                         accum_steps: int = 1) -> EDTRTrainStep:
    """``edtr_tpu.train.edtr_step.make_edtr_train_step``: ``step(state,
    batch, t=None, noise=None, generator=None, task_draws=None)`` makes one
    update of ``state`` in place and returns the metrics. ``batch``:
    ``lq``/``gt`` (B, H, W, 3) in [0, 1], ``c_txt`` and, with a detnet,
    padded ``targets`` (``boxes`` (B, G, 4) in pixels, ``labels``,
    ``valid`` (B, G)); ``hlf_loss_fn(restored, gt)`` on NCHW images
    replaces the pixel L1 without a detnet. ``detnet`` and
    ``teacher_detnet`` are those of :meth:`EDTRTrainState.create`."""
    if (detnet is None) != (teacher_detnet is None):
        raise ValueError("the task-net half needs both a detnet and its teacher")
    task = None if detnet is None else DetHalf(detnet, teacher_detnet, weight_det, weight_fm)
    return EDTRTrainStep(pipe, task, weight_hlf, hlf_loss_fn, accum_steps)


def make_edtr_generic_train_step(pipe: nn.Module, tasknet: nn.Module,
                                 teacher_tasknet: nn.Module, task_feats_fn: Callable,
                                 task_loss_fn: Callable, weight_hlf: float = 0.5,
                                 weight_task: float = 1.0, weight_fm: float = 0.2,
                                 accum_steps: int = 1) -> EDTRTrainStep:
    """``edtr_tpu.train.edtr_step.make_edtr_generic_train_step``: the
    two-half step of the classification and segmentation recipes, called
    as :func:`make_edtr_train_step`'s, its batch carrying ``target``
    (labels (B,) or masks (B, H, W)). ``task_feats_fn`` and
    ``task_loss_fn``: :func:`edtr_torch.train.tasks.task_apply_for`'s;
    ``tasknet`` and ``teacher_tasknet`` are the ``detnet`` and
    ``teacher_detnet`` of :meth:`EDTRTrainState.create`."""
    task = GenericHalf(tasknet, teacher_tasknet, task_feats_fn, task_loss_fn, weight_task,
                       weight_fm)
    return EDTRTrainStep(pipe, task, weight_hlf, None, accum_steps)


def make_edtr_sample_fn(pipe: nn.Module, staged: bool = True) -> Callable:
    """``edtr_tpu.train.edtr_step.make_edtr_sample_fn``: the no-grad K-step
    restore of the evaluation loops, ``sample(lq, c_txt=None, noise=None,
    step_noise=None, generator=None) -> restored``, NHWC in [0, 1] in and
    out: ``pipe.restore(...)["restored"]`` (its stages ``pre_restore |
    encode | denoise | decode``; ``c_txt``, ``noise``, ``step_noise`` as
    :meth:`EDTRPipeline.restore` takes them). JAX's ``staged`` chooses
    between one compiled graph and four of the same numbers; eager PyTorch
    runs the stages one by one either way, so ``staged`` is kept for the
    signature alone."""

    def sample(lq: torch.Tensor, c_txt: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return pipe.restore(lq, c_txt, noise, step_noise, generator)["restored"]

    return sample
