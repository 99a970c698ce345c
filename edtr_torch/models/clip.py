"""Frozen OpenCLIP ViT-H text tower of the port (text transformer only).

Counterpart of ``edtr_tpu/models/clip.py``: token and position embeddings,
pre-LN residual blocks (causal self-attention, erf-GELU MLP), ``ln_final``
over the whole 77-token sequence, no pooling and no text projection.
``penultimate`` builds and runs ``layers - 1`` blocks, as the reference's
``layer="penultimate"`` stops before the last one. The output is fp32.

Parameter names are the OpenCLIP text keys (``token_embedding.weight``,
``positional_embedding``, ``transformer.resblocks.N.{ln_1,attn,ln_2,mlp}``,
``ln_final``), the part after ``cond_stage_model.model.`` in an SD2.1
checkpoint. The attention keeps the reference's fused ``in_proj_weight``
(3W, W) and ``in_proj_bias``; q, k and v are its three row blocks, each
computed as JAX's separate ``q_proj``/``k_proj``/``v_proj`` dense layers
compute it.

Numerics as in JAX: fp32 params; dense layers cast input and weight to
``dtype``, accumulate in fp32, round, add the bias in ``dtype``; LayerNorm
in fp32, cast back; logits in fp32, scaled, plus the causal -inf bias,
softmax in fp32, cast to v's dtype. Every op is stock PyTorch: the biased
77-token attention takes the plain math of ``ops/attention.py``, as JAX
leaves it to XLA.

Token ids are checked on the host: an id outside ``[0, vocab_size)``
raises ``ValueError`` (JAX's ``jnp.take`` returns NaN rows there).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edtr_torch.data.tokenizer import tokenize
from edtr_torch.models.layers import LayerNorm, Linear
from edtr_torch.ops.attention import dot_product_attention


class MultiheadAttention(nn.Module):
    """Self-attention on the reference's fused projection: ``in_proj_weight``
    (3W, W), ``in_proj_bias`` (3W,), ``out_proj``."""

    def __init__(self, width: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        nn.init.normal_(self.in_proj_weight, std=width ** -0.5)
        self.out_proj = Linear(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        dt = self.dtype or torch.promote_types(x.dtype, self.in_proj_weight.dtype)
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt)) + self.in_proj_bias.to(dt)
        q, k, v = qkv.reshape(b, n, 3, self.heads, c // self.heads).unbind(2)
        out = dot_product_attention(q, k, v, bias=bias)
        return self.out_proj(out.reshape(b, n, c))


class MLP(nn.Module):
    def __init__(self, width: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c_fc = Linear(width, 4 * width, dtype=dtype)
        self.c_proj = Linear(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + MLP block."""

    def __init__(self, width: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, heads, dtype)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, dtype)
                                       for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """``forward(tokens) -> (B, context_length, width)`` fp32; ``encode``
    tokenizes prompts first."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024, heads: int = 16,
                 layers: int = 24, context_length: int = 77, penultimate: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.vocab_size, self.width = vocab_size, width
        self.context_length, self.dtype = context_length, dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = Transformer(width, heads, layers - 1 if penultimate else layers,
                                       dtype)
        self.ln_final = LayerNorm(width)

    def host_tokens(self, tokens: Union[np.ndarray, torch.Tensor, Sequence]) -> torch.Tensor:
        """``tokens`` as a CPU int64 tensor, every id checked against the
        vocabulary."""
        ids = torch.as_tensor(np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                                         else tokens), dtype=torch.long)
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= self.vocab_size):
            raise ValueError(f"CLIP token ids must lie in [0, {self.vocab_size}), got "
                             f"[{int(ids.min())}, {int(ids.max())}]")
        return ids

    def forward(self, tokens: Union[np.ndarray, torch.Tensor, Sequence]) -> torch.Tensor:
        dev = self.positional_embedding.device
        ids = self.host_tokens(tokens).to(dev, non_blocking=True)
        x = self.token_embedding.weight[ids] + self.positional_embedding[None]
        x = x.to(self.dtype or x.dtype)
        n = self.context_length
        causal = torch.full((n, n), float("-inf"), device=dev).triu_(1)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, causal)
        return self.ln_final(x).float()

    def encode(self, prompts: Sequence[str]) -> torch.Tensor:
        """The embedding of each prompt, (len(prompts), context_length,
        width) fp32."""
        return self(tokenize(list(prompts), self.context_length))
