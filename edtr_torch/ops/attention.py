"""Attention entry point of the port: ``dot_product_attention``.

Counterpart of ``edtr_tpu/ops/attention.py``. Layout ``(B, N, H, D)``
throughout. A CUDA tensor at a shape JAX sends to a flash kernel
(:func:`edtr_torch.ops.flash_attention.shapes_supported`, no bias) goes to
the kernel :func:`kernel_route` names where the port's kernel takes it
(``flash_attention.kernel_takes``: bf16, D 64, or D 256-512 for the
streamed-KV kernel); every other call (77-token cross-attention, N = 256
or 64, any call with a bias, fp32 or D-128 calls, which JAX's Pallas
kernels would take, and every CPU tensor) takes the plain math of
``_xla_attention``, as JAX leaves the first ones to XLA. Both are
differentiable: the flash route through the autograd Function of
:func:`edtr_torch.ops.flash_attention.flash_attention` (JAX's
``custom_vjp``, its backward kernels on the card), the plain math under
autograd.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from edtr_torch.ops import flash_attention as _fa

_force_plain = False


@contextlib.contextmanager
def force_plain(on: bool = True) -> Iterator[None]:
    """Test hook: inside the block every call takes the plain math, also
    on CUDA (chip_smoke.py holds the kernels' path against it)."""
    global _force_plain
    prev, _force_plain = _force_plain, bool(on)
    try:
        yield
    finally:
        _force_plain = prev


def force_plain_on() -> bool:
    """Whether the call runs inside a :func:`force_plain` block."""
    return _force_plain


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> Optional[str]:
    """The flash wrapper a call at these shapes and dtypes goes to on the
    card, or None for the plain math: the dispatch of ``edtr_tpu``'s
    attention on a TPU where the port's kernels take the call (its forward
    wrapper's and, where the backward is a kernel, its backward wrappers'
    ``kernel_takes``), else None."""
    if bias is not None or not _fa.shapes_supported(q, k, v):
        return None
    if not q.dtype == k.dtype == v.dtype:
        return None
    b, n, h, d = q.shape
    name = _fa.kernel_for(n, d)
    bwd = _fa.bwd_kernel_for(n, d)
    wrappers = [name] + ([] if bwd == "plain_bwd" else
                         ["whole_bwd"] if bwd == "whole_bwd" else
                         ["flash_bwd_dq", "flash_bwd_dkv"])
    if not all(_fa.kernel_takes(w, q.dtype, b * h, n, d) for w in wrappers):
        return None
    return name


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``_xla_attention``: fp32 logits and softmax whatever the input dtype,
    probabilities cast to v's dtype, PV accumulated in fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(v.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v with fp32 softmax.

    q: (B, Nq, H, D); k/v: (B, Nk, H, D); bias broadcastable to
    (B, H, Nq, Nk). Returns (B, Nq, H, D) in v's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    route = kernel_route(q, k, v, bias)
    if route is not None and q.is_cuda and scale > 0 and not _force_plain:
        return _fa.flash_attention(q, k, v, scale)
    return plain_attention(q, k, v, scale, bias)
