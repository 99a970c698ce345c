"""Spatial/cross-attention transformer of the LDM UNet and ControlNet.

Counterpart of ``edtr_tpu/models/attention.py``: LayerNorm in fp32 then
cast to the compute dtype before the bias-free q/k/v projections;
exact-erf GEGLU; the SpatialTransformer's GroupNorm folded to a per-(B, C)
fp32 affine applied before ``proj_in`` (``use_linear_in_transformer``, the
only SD2.1 form). As in JAX, ``BasicTransformerBlock`` hands its norms to
``CrossAttention`` and ``FeedForward`` (``pre_norm``). Outside a
``layers.fused_proj`` block they apply them and run stock PyTorch ops (JAX's
dispatch with the ``ln_matmul``/``geglu`` families off: their ``_ref``
math). Inside one, at the token counts the kernels take
(``ln_matmul.supported``, ``geglu.supported``), they run through the
projection kernels (JAX with both families forced): LN+q/k/v and LN+query
(``ln_matmuls``), LN+GEGLU (``ln_geglu_proj``, the split-halves form) and
GroupNorm-affine+``proj_in`` (``affine_matmul``). JAX's rule chooses the
form; on the card a call in that form which the kernel does not take (its
predicate, :func:`proj_route`: fp32 tokens, the tiny flagship's 32-wide
heads) runs the wrapper's plain version, the same math. Attention runs through
:func:`edtr_torch.ops.attention.dot_product_attention` in ``(B, N, H, D)``
layout, so self-attention at the shapes the flash kernels take launches
them on the card.

Parameter names are the reference LDM state-dict keys (``attn1.to_q``,
``attn1.to_out.0``, ``ff.net.0.proj``, ``ff.net.2``, ``transformer_blocks.0``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.models.layers import (DerivedWeight, GroupNorm32, LayerNorm, Linear,
                                      concat_weights, fused_proj_on, whole)
from edtr_torch.ops import geglu, ln_matmul
from edtr_torch.ops.attention import dot_product_attention
from edtr_torch.parallel import tp
from edtr_torch.parallel.mesh import is_sharded


def proj_route(x: torch.Tensor, takes, *dims: int) -> bool:
    """Whether a fused-projection call on tokens ``x`` goes to its wrapper:
    always on the CPU, where the wrapper is the plain version; elsewhere
    only where the kernel takes it (``takes(x.dtype, *dims)``: one of
    ``ln_matmul.ln_matmuls_takes`` / ``affine_matmul_takes``,
    ``geglu.geglu_takes``), else the caller runs the plain version."""
    return x.device.type == "cpu" or takes(x.dtype, *dims)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None.
    ``pre_norm``: the block's LayerNorm, and ``x`` the pre-norm residual
    stream (else ``x`` is already normalised)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = heads * dim_head
        ctx = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(ctx, inner, bias=False, dtype=dtype)
        self.to_v = Linear(ctx, inner, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(Linear(inner, query_dim, dtype=dtype))
        self._qkv = DerivedWeight()

    def qkv_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The (3*inner, C) concatenation of the q/k/v weights in ``dtype``,
        kept until one of them changes."""
        return self._qkv.get((self.to_q.weight, self.to_k.weight, self.to_v.weight), dtype,
                             concat_weights)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                pre_norm: Optional[LayerNorm] = None) -> torch.Tensor:
        lins = (self.to_q, self.to_k, self.to_v)
        out_proj = self.to_out[0]
        heads = (tp.split_attention_heads(self.heads, [m.weight for m in lins + (out_proj,)])
                 if is_sharded(self.to_q.weight) else 0)
        fused = pre_norm is not None and fused_proj_on() and ln_matmul.supported(x.shape[1])
        if pre_norm is not None and not fused:
            x = pre_norm(x)
        norm = None if not fused else (pre_norm.weight, pre_norm.bias)
        group = None
        if heads:
            # tensor parallelism over a model dim that divides the heads
            # (edtr_torch/parallel/tp.py): this rank's heads, the gradients
            # of the inputs (and of a fused norm) summed over the ranks
            group = out_proj.weight.device_mesh.get_group()
            x = tp.to_model_region(x, group)
            context = None if context is None else tp.to_model_region(context, group)
            norm = None if norm is None else tuple(tp.to_model_region(p, group) for p in norm)
            ws = [m.weight.to_local() for m in lins]
        else:
            heads, ws = self.heads, [whole(m.weight) for m in lins]
        if fused:
            xc = x.to(self.to_q.dtype or x.dtype)
            sel = ws if context is None else ws[:1]
            _, n, c = xc.shape
            if not proj_route(xc, ln_matmul.ln_matmuls_takes, n, c, sel[0].shape[0]):
                outs = ln_matmul.plain_ln_matmuls(xc, *norm, sel, pre_norm.eps)
            else:
                wp = (self.qkv_weight(xc.dtype) if context is None
                      else self.to_q.packed_weight(xc.dtype))
                outs = ln_matmul.ln_matmuls(xc, *norm, sel, pre_norm.eps, w_packed=wp)
            q, k, v = outs if context is None else (*outs, self.to_k(context, ws[1]),
                                                    self.to_v(context, ws[2]))
        else:
            ctx = x if context is None else context
            q, k, v = self.to_q(x, ws[0]), self.to_k(ctx, ws[1]), self.to_v(ctx, ws[2])
        b, n, _ = q.shape
        m, d = k.shape[1], self.dim_head
        out = dot_product_attention(q.reshape(b, n, heads, d), k.reshape(b, m, heads, d),
                                    v.reshape(b, m, heads, d), scale=d ** -0.5)
        out = out.reshape(b, n, heads * d)
        if group is None:
            return self.to_out(out)
        # the row-split output projection: the ranks' partial sums added
        y = tp.from_model_region(out_proj(out, out_proj.weight.to_local()), group)
        return y + out_proj.bias.to(y.dtype)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU, as torch's default


class FeedForward(nn.Module):
    """GEGLU feed-forward. ``pre_norm``: the block's norm3, and ``x`` the
    pre-norm residual stream. Inside ``fused_proj``, where
    ``geglu.supported`` holds (``geglu.will_fuse`` with the family forced),
    the split-halves form through the GEGLU kernels (their plain versions
    where :func:`proj_route` refuses the call): both biases added in fp32
    before the GELU; elsewhere the packed form: one projection rounded with
    its bias added in the compute dtype, then GELU on the rounded gate."""

    def __init__(self, dim: int, mult: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.inner = dim * mult
        # net.1 is the reference's Dropout(0): no parameters, no effect
        self.net = nn.Sequential(GEGLU(dim, self.inner, dtype), nn.Identity(),
                                 Linear(self.inner, dim, dtype=dtype))

    def forward(self, x: torch.Tensor, pre_norm: Optional[LayerNorm] = None) -> torch.Tensor:
        if fused_proj_on() and geglu.supported(x.shape[1], x.shape[2], self.inner):
            proj = self.net[0].proj
            w = whole(proj.weight)
            xc = x.to(proj.dtype or x.dtype)
            if not proj_route(xc, geglu.geglu_takes, xc.shape[1], xc.shape[2], self.inner):
                if pre_norm is not None:
                    h = geglu.plain_ln_geglu_proj(xc, pre_norm.weight, pre_norm.bias, w,
                                                  proj.bias, pre_norm.eps)
                else:
                    h = geglu.plain_geglu_proj(xc, w, proj.bias)
            elif pre_norm is not None:
                h = geglu.ln_geglu_proj(xc, pre_norm.weight, pre_norm.bias, w, proj.bias,
                                        pre_norm.eps, w_packed=proj.packed_weight(xc.dtype))
            else:
                h = geglu.geglu_proj(xc, w, proj.bias, w_packed=proj.packed_weight(xc.dtype))
            return self.net[2](h)
        if pre_norm is not None:
            x = pre_norm(x)
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dtype)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = x + self.attn1(x, pre_norm=self.norm1)
        x = x + self.attn2(x, context, pre_norm=self.norm2)
        return x + self.ff(x, pre_norm=self.norm3)


class SpatialTransformer(nn.Module):
    """NCHW features -> tokens -> transformer blocks -> NCHW, plus input."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = n_heads * d_head
        self.dtype = dtype
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = Linear(in_channels, inner, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, dtype)
            for _ in range(depth))
        self.proj_out = Linear(inner, in_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, c, h, w = x.shape
        xc = x.to(self.dtype or x.dtype)
        mul, add = self.norm.fold(xc)
        t = xc.flatten(2).transpose(1, 2)  # (B, HW, C), contiguous on channels-last memory
        if fused_proj_on() and ln_matmul.supported(h * w):
            w_in, b_in = self.proj_in.weight, self.proj_in.bias
            if not proj_route(t, ln_matmul.affine_matmul_takes, h * w, c, w_in.shape[0]):
                t = ln_matmul.plain_affine_matmul(t, mul, add, w_in, b_in)
            else:
                if not t.is_contiguous():  # the kernel reads C-contiguous token rows
                    t = t.contiguous()
                    ln_matmul.layout_copies["count"] += 1
                t = ln_matmul.affine_matmul(t, mul, add, w_in, b_in,
                                            w_packed=self.proj_in.packed_weight(xc.dtype))
        else:
            t = (t.float() * mul[:, None] + add[:, None]).to(xc.dtype)
            t = self.proj_in(t)
        for blk in self.transformer_blocks:
            t = blk(t, context)
        t = self.proj_out(t)
        return t.transpose(1, 2).reshape(b, -1, h, w) + x
