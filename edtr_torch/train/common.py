"""What the EDTR steps (``edtr_torch.train.edtr_step``) and the other
training recipes (``edtr_torch.train.recipes``) share: optax's cosine
schedule, the pipeline's trainable partition, a block in which a module's
parameters take no gradient, and the names of the steps'
``record_function`` ranges, which ``edtr_torch.profile_restore`` reads
from a trace. It imports no model, so both modules (and the trace reader)
import it and it imports neither.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

Params = Dict[str, nn.Parameter]

# an EDTR step's phases: each half's forward and loss, the task-net half's
# no-grad walk, each half's backward, each optimizer update
TRAIN_STAGES = ("forward+loss", "sample", "backward", "optimizer")
# a recipe step's phases: the frozen pre-restoration, the restoration
# net's forward and loss, backward and update, the no-grad restorations
# for the task net, the task net's half
RECIPE_STAGES = ("pre_restore", "forward+loss", "backward", "optimizer", "sample", "task")


def cosine_decay(count: int, init_value: float, decay_steps: int, alpha: float) -> float:
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)`` at
    ``count``."""
    c = min(count, decay_steps)
    return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)


def cosine_schedule(tx: torch.optim.Optimizer, lr: float, train_steps: int,
                    eta_min: float = 1e-7) -> torch.optim.lr_scheduler.LambdaLR:
    """``tx``'s learning rate from ``lr`` down to ``eta_min`` over
    ``train_steps`` updates, optax's cosine schedule."""
    alpha = eta_min / lr
    return torch.optim.lr_scheduler.LambdaLR(
        tx, lambda count: cosine_decay(count, 1.0, train_steps, alpha))


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


@contextlib.contextmanager
def no_param_grads(module: Optional[nn.Module]) -> Iterator[None]:
    """``module``'s parameters take no gradient inside the block (their
    ``requires_grad`` restored after it)."""
    flags = [] if module is None else [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
