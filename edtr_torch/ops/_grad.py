"""The backward shared by the kernel wrappers' autograd Functions
(``ops/{gn_conv,ln_matmul,geglu,window_attention,swin_block}.py``): JAX's
recompute rule (the ``custom_vjp``s' ``jax.vjp(_ref, *res)``), the gradients
of a wrapper's plain version at the inputs its forward saved. The kernels
themselves have no backward: on the card the plain version's ops run.

The K7-K10 wrappers call their Function only where a gradient can flow
(:func:`needs_grad`), and their forward directly otherwise: the same
kernel launch, without the Function's host cost on every call (the
restore is bound by the host's launch rate)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd records a graph through these inputs (grad mode on
    and one of them requires grad)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def recompute_grads(needs: Sequence[bool], plain: Callable, grads, args: Sequence) -> tuple:
    """The gradients of ``plain(*args)`` against ``grads`` (one tensor, or
    one per output of a plain version with several), for each tensor of
    ``args`` whose ``needs`` entry is set (``ctx.needs_input_grad`` of the
    Function, aligned with ``args``); None for the others. An output that no
    such input reaches takes no part."""
    want = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and needs[i]]
    out = [None] * len(args)
    if not want:
        return tuple(out)
    with torch.enable_grad():
        live = [a.detach().requires_grad_(i in want) if isinstance(a, torch.Tensor) else a
                for i, a in enumerate(args)]
        outs = plain(*live)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        grads = grads if isinstance(grads, (tuple, list)) else (grads,)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], [live[i] for i in want],
                                  [g for _, g in pairs], allow_unused=True)
    for i, g in zip(want, got):
        out[i] = g
    return tuple(out)
