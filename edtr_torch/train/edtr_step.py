"""EDTR training step of the port: the EDTR half, with no detection net.

Counterpart of ``edtr_tpu/train/edtr_step.py`` with ``detnet=None`` (the
restoration-only recipes, ``tests/test_convergence.py::
test_edtr_hlf_overfit``): AdamW (lr 1e-4, cosine to 1e-7, weight decay
1e-2) over the ControlNet and, with ``train_decoder``, the VAE decoder:

    pre_res  = swinir(lq); z_pre = vae_encode(pre_res*2-1)   # frozen, no grad
    t        = used_timesteps[randint]                        # per sample
    x_pred   = diffusion.reverse(cldm, t, z_pre, cond, noise)["x_pred"]
    restored = wavelet_reconstruction((vae_decode(x_pred)+1)/2, pre_res)
    loss_hlf = weight_hlf * L1(restored, gt)                  # or hlf_loss_fn

then backward and one optimizer update. ``accum_steps=K`` splits the batch
into K microbatches and takes the mean of their mean gradients before the
one update (JAX's global-batch semantics on one card). The step runs its
forward and its backward inside ``pipe.configuration()``, so the
recomputes of ``use_checkpoint`` see the kernels their forward ran.

Partition (``split_trainable``, JAX's :84-92 parity): trainable are
``cldm.controlnet.*`` and, with ``train_decoder``, ``cldm.vae.decoder.*``;
frozen are the UNet, the VAE encoder, ``quant_conv``, ``post_quant_conv``
(outside the decoder subtree) and SwinIR, as ``requires_grad`` flags.

The detection half (SGD on Faster R-CNN, feature HLF and feature matching)
waits for the detection port; given a detnet, :meth:`EDTRTrainState.create`
raises. Images are NHWC in [0, 1] in the batch, as JAX's; the noise and the
restored image the loss sees are NCHW, as the port's modules.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from edtr_torch.utils.image import wavelet_reconstruction

Params = Dict[str, nn.Parameter]
Batch = Dict[str, torch.Tensor]
# the step's phases, each under a ``record_function`` range of this name
# (``edtr_torch.profile_restore.TRAIN_STAGES`` reads them from a trace)
STAGES = ("forward+loss", "backward", "optimizer")


def split_trainable(pipe: nn.Module, train_decoder: bool = True) -> Tuple[Params, Params]:
    """(trainable, frozen) parameters of an ``EDTRPipeline`` by name, their
    ``requires_grad`` set to match: the ControlNet (+ the VAE decoder)
    train, everything else stays."""
    trainable, frozen = {}, {}
    for name, p in pipe.named_parameters():
        train = name.startswith("cldm.controlnet.") or (
            train_decoder and name.startswith("cldm.vae.decoder."))
        p.requires_grad_(train)
        (trainable if train else frozen)[name] = p
    return trainable, frozen


def cosine_decay(count: int, init_value: float, decay_steps: int, alpha: float) -> float:
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)`` at
    ``count``."""
    c = min(count, decay_steps)
    return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)


@dataclass
class EDTRTrainState:
    """The pipeline (its trainable parameters updated in place), the EDTR
    optimizer and its schedule, and the number of updates made."""

    pipe: nn.Module
    tx_edtr: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    @classmethod
    def create(cls, pipe: nn.Module, learning_rate_edtr: float = 1e-4,
               train_steps: int = 10000, train_decoder: Optional[bool] = None,
               detnet: Optional[nn.Module] = None) -> "EDTRTrainState":
        """AdamW (betas 0.9/0.999, eps 1e-8, weight decay 1e-2: torch's
        defaults, as the reference passes lr only) with the cosine schedule
        from ``learning_rate_edtr`` to 1e-7 over ``train_steps``, over
        :func:`split_trainable`. ``train_decoder`` defaults to the VAE's
        flag."""
        if detnet is not None:
            raise NotImplementedError("the detection half of the EDTR step (SGD on the "
                                      "detnet, feature HLF and matching) waits for the "
                                      "port of detection (models/faster_rcnn.py)")
        if train_decoder is None:
            train_decoder = pipe.cldm.vae.train_decoder
        trainable, _ = split_trainable(pipe, train_decoder)
        tx = torch.optim.AdamW(list(trainable.values()), lr=learning_rate_edtr,
                               betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
        alpha = 1e-7 / learning_rate_edtr
        sched = torch.optim.lr_scheduler.LambdaLR(
            tx, lambda count: cosine_decay(count, 1.0, train_steps, alpha))
        return cls(pipe=pipe, tx_edtr=tx, schedule=sched)


class EDTRTrainStep:
    """The EDTR update of :func:`make_edtr_train_step`; its parts
    (:meth:`shared`, :meth:`draw`, :meth:`loss`, :meth:`grads`) are public
    so a caller can compare them; a trace splits the step by the ranges of
    :data:`STAGES`."""

    def __init__(self, pipe: nn.Module, weight_hlf: float = 0.5,
                 hlf_loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]
                 = None, accum_steps: int = 1):
        self.pipe = pipe
        self.weight_hlf = weight_hlf
        self.hlf_loss_fn = hlf_loss_fn
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
        ``z_pre``, both from ``generator``."""
        idx = torch.randint(0, len(self.used_ts), (z_pre.shape[0],), generator=generator,
                            device=z_pre.device)
        noise = torch.randn(z_pre.shape, generator=generator, device=z_pre.device,
                            dtype=z_pre.dtype)
        return self.used_ts[idx], noise

    def loss(self, shared: Tuple[torch.Tensor, ...], t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
        """JAX's ``edtr_loss`` (``detnet=None``) at given t and NCHW noise."""
        pipe = self.pipe
        gt, pre_res, z_pre, c_txt = shared
        out = pipe.diffusion.reverse(pipe.cldm, t.to(z_pre.device), z_pre,
                                     dict(c_txt=c_txt, c_img=z_pre),
                                     noise=noise.to(z_pre.device, z_pre.dtype))
        decoded = (pipe.cldm.vae_decode(out["x_pred"]) + 1) / 2
        res = wavelet_reconstruction(decoded, pre_res)
        if self.hlf_loss_fn is not None:
            return self.weight_hlf * self.hlf_loss_fn(res, gt)
        return self.weight_hlf * (res - gt).abs().mean()

    def grads(self, state: EDTRTrainState, batch: Batch, t: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The mean over ``accum_steps`` microbatches of their loss and mean
        gradients, the gradients left in the trainable parameters' ``.grad``
        (set anew). ``t`` (B,) and ``noise`` (B, 4, h, w) cover the whole
        batch; each is drawn from ``generator`` per microbatch when not
        given. Each microbatch's forward and loss, and its backward, run
        under the ``record_function`` ranges of :data:`STAGES`. Returns the
        mean loss (detached)."""
        k = self.accum_steps
        n = batch["lq"].shape[0]
        if n % k:
            raise ValueError(f"batch of {n} does not split into {k} microbatches")
        m = n // k
        state.tx_edtr.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.pipe.device)
        with self.pipe.configuration():
            for i in range(k):
                sl = slice(i * m, (i + 1) * m)
                with record_function(STAGES[0]):
                    shared = self.shared({key: v[sl] for key, v in batch.items()})
                    t_i, noise_i = ((t[sl], noise[sl]) if t is not None and noise is not None
                                    else self.draw(shared[2], generator))
                    loss = self.loss(shared, t_i, noise_i)
                with record_function(STAGES[1]):
                    (loss / k).backward()
                total += loss.detach() / k
        return total

    def __call__(self, state: EDTRTrainState, batch: Batch,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One update: :meth:`grads`, then AdamW and the schedule (under the
        ``optimizer`` range). Returns ``{"loss_hlf": mean loss}``."""
        loss = self.grads(state, batch, t, noise, generator)
        with record_function(STAGES[2]):
            state.tx_edtr.step()
            state.schedule.step()
        state.step += 1
        return {"loss_hlf": loss}


def make_edtr_train_step(pipe: nn.Module, weight_hlf: float = 0.5,
                         hlf_loss_fn: Optional[Callable] = None,
                         accum_steps: int = 1) -> EDTRTrainStep:
    """``edtr_tpu.train.edtr_step.make_edtr_train_step(pipe, detnet=None)``:
    ``step(state, batch, t=None, noise=None, generator=None)`` makes one
    update of ``state`` in place and returns ``{"loss_hlf": ...}``.
    ``batch``: ``lq``/``gt`` (B, H, W, 3) in [0, 1] and ``c_txt``;
    ``hlf_loss_fn(restored, gt)`` on NCHW images replaces the pixel L1."""
    return EDTRTrainStep(pipe, weight_hlf, hlf_loss_fn, accum_steps)
