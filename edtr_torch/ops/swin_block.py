"""The two halves of a SwinIR transformer block in rolled token space:
Hopper kernels and their plain PyTorch versions.

Counterpart of ``edtr_tpu/ops/swin_block.py``:

  =========  =========================================  ================
  wrapper    replaces (edtr_tpu/ops/swin_block.py)      CUDA kernel
  =========  =========================================  ================
  swin_pre   ``swin_pre`` (``_pre_kernel``)             swin_pre_kernel
  swin_post  ``swin_post`` (``_post_kernel``)           swin_post_kernel
  =========  =========================================  ================

The kernels live in ``edtr_torch/csrc/swin_block.cu`` (see its header for
the design). The plain versions are the math of JAX's ``_pre_ref`` and
``_post_ref``/``_post_body``, not of the module path: the qkv, proj, fc1 and
fc2 biases are added in fp32 before the single rounding to the tokens'
dtype, the GELU is the exact erf form in fp32, and the residual adds are in
that dtype.

Rolled space: ``swin_pre`` rolls its input by ``(-d, -d)`` over the (h, w)
token grid (``d = shift - in_offset``, which may be negative: it is taken
mod h and mod w), and ``swin_post`` leaves its output rolled, so a block
hands its successor tokens rolled by its own shift and the RSTB un-rolls
once (``models/swinir.py``).

Weights are in nn.Linear layout (out, in): the module's fp32 weights for
the plain versions; the kernels read bf16 copies (``w_packed``/``packed``)
zero-padded along ``in`` to a multiple of 64 (:func:`pad_weight`), whose
rows TMA can read, that the modules cache until a weight changes
(``Linear.padded_weight``): qkv for ``swin_pre``, proj, fc1 and fc2 for
``swin_post``. A wrapper given CPU tensors computes the plain version;
given CUDA tensors it launches its kernel or raises. The kernels take bf16
tokens, window 8 (64 tokens), h and w multiples of it, C a multiple of 4
up to 192 and an MLP hidden a multiple of 4 up to 384
(:func:`swin_pre_takes`, :func:`swin_post_takes`; the fused block's route
sends what they do not take to the plain versions). ``swin_post`` gives a
window to a two-block cluster where that fills the card
(:func:`post_split`).

Both wrappers are ``torch.autograd.Function``s whose backward is JAX's
recompute (``swin_block.py:_pre_bwd``/``_post_bwd``): ``torch.autograd.grad``
of the plain version at the saved inputs (``ops/_grad.py``), for every
tensor input but the bf16 weight copies; the grid, window and shift are
integers, nondiff in JAX too. An output of ``swin_pre`` given no gradient
counts as zero.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from edtr_torch.ops import _cuda
from edtr_torch.ops._grad import needs_grad, recompute_grads
from edtr_torch.ops._norms import ln_f32
from edtr_torch.ops._proj import check, dot32, on_device, raise_on_error

WIN_TOKENS = 64   # tokens per window the kernels take (window 8)
MAX_C = 192
MAX_HIDDEN = 384

# kernel launches per wrapper; chip_smoke.py zeroes these around a run
launches: Dict[str, int] = {"swin_pre": 0, "swin_post": 0}
# launches per ("swin_pre", B, h, w, C, win, d) / ("swin_post", B, h, w, C,
# win, hidden)
shapes: Counter = Counter()


# swin_post's hidden slab (fc1 columns) a cluster block takes
POST_SLAB = 192


def post_split(b: int, h: int, w: int, win: int, hidden: int) -> int:
    """Blocks a window of ``swin_post``: 2 (a cluster, each block one
    192-column slab of the hidden) where the hidden has two slabs and two
    blocks a window still fit the card one block an SM (bs 1 at 64 x 64
    tokens: 128 blocks), else 1 (bs 2: 128 windows already)."""
    windows = b * (h // win) * (w // win)
    return 2 if hidden > POST_SLAB and 2 * windows <= _cuda.SMS else 1


def swin_pre_takes(dtype: torch.dtype, h: int, w: int, win: int, c: int) -> bool:
    """Whether the ``swin_pre`` kernel takes (B, h*w, C) tokens of
    ``dtype``: bf16, window 8 over an (h, w) grid of its multiples, C a
    multiple of 4 up to :data:`MAX_C`."""
    return (dtype == torch.bfloat16 and win * win == WIN_TOKENS and supported(h, w, win)
            and 0 < c <= MAX_C and c % 4 == 0)


def swin_post_takes(dtype: torch.dtype, h: int, w: int, win: int, c: int,
                    hidden: int) -> bool:
    """Whether the ``swin_post`` kernel takes the call: as
    :func:`swin_pre_takes`, and an MLP hidden a multiple of 4 up to
    :data:`MAX_HIDDEN`."""
    return (swin_pre_takes(dtype, h, w, win, c) and 0 < hidden <= MAX_HIDDEN
            and hidden % 4 == 0)


def supported(h: int, w: int, win: int) -> bool:
    """``swin_block.supported`` (JAX) without its VMEM budget, a TPU
    artefact: the token grids the fused block takes."""
    return h % win == 0 and w % win == 0 and h >= win and w >= win


def roll2d(x: torch.Tensor, d: int, h: int, w: int) -> torch.Tensor:
    """(B, h*w, C) tokens rolled by (-d, -d) over the (h, w) grid: token
    (y, x) of the result is token ((y + d) mod h, (x + d) mod w) of x."""
    if d % h == 0 and d % w == 0:
        return x
    b, _, c = x.shape
    return torch.roll(x.reshape(b, h, w, c), (-(d % h), -(d % w)), (1, 2)).reshape(b, h * w, c)


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, win*win, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def window_reverse(windows: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, win*win, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // win) * (w // win))
    x = windows.reshape(b, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def pad_weight(w: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(out, in) -> (out, 64 * ceil(in / 64)) in ``dtype``, zeros past
    ``in``: a weight as the kernels read it (qkv for ``swin_pre``, proj, fc1
    and fc2 for ``swin_post``: rows of a multiple of 128 bytes, which a TMA
    tensor map can describe)."""
    out, cin = w.shape
    wp = torch.zeros((out, -(-cin // 64) * 64), dtype=dtype, device=w.device)
    wp[:, :cin] = w
    return wp


def plain_swin_pre(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                   wqkv: torch.Tensor, bqkv: torch.Tensor, h: int, w: int, win: int,
                   d: int, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """LN1 + roll(-d) + qkv + window partition with the casts of
    ``_pre_ref``. x (B, h*w, C); ln_s/ln_b (C,); wqkv (3C, C); bqkv (3C,).
    Returns (qkv windows (B, nW, win², 3C), x rolled (B, h*w, C))."""
    cdt = x.dtype
    b, _, c = x.shape
    xln = roll2d(ln_f32(x, ln_s, ln_b, eps).to(cdt), d, h, w)
    qkv = (dot32(xln, wqkv) + bqkv.float()).to(cdt)
    qkv = window_partition(qkv.reshape(b, h, w, 3 * c), win)
    return qkv.reshape(b, -1, win * win, 3 * c), roll2d(x, d, h, w)


def plain_swin_post(attn: torch.Tensor, xr: torch.Tensor, wproj: torch.Tensor,
                    bproj: torch.Tensor, ln2s: torch.Tensor, ln2b: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    h: int, w: int, win: int, eps: float = 1e-5) -> torch.Tensor:
    """Window reverse + proj + residual + LN2 + MLP + residual with the
    casts of ``_post_body``. attn (B, nW, win², C); xr (B, h*w, C) rolled;
    wproj (C, C), w1 (hidden, C), w2 (C, hidden). Returns (B, h*w, C), still
    rolled."""
    cdt = xr.dtype
    b, l, c = xr.shape
    a = window_reverse(attn.reshape(-1, win * win, c), win, h, w).reshape(b, l, c)
    x1 = xr + (dot32(a, wproj) + bproj.float()).to(cdt)
    xln = ln_f32(x1, ln2s, ln2b, eps).to(cdt)
    hid = F.gelu(dot32(xln, w1) + b1.float()).to(cdt)
    return x1 + (dot32(hid, w2) + b2.float()).to(cdt)


@functools.lru_cache(maxsize=None)
def _symbol(name: str):
    lib = _cuda.load("swin_block")
    if name == "swin_pre":
        fn = lib.edtr_swin_pre
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        fn = lib.edtr_swin_post
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_tokens(name: str, x: torch.Tensor, h: int, w: int, win: int,
                  hidden: Optional[int] = None) -> None:
    if x.ndim != 3 or x.shape[1] != h * w:
        raise ValueError(f"{name}: tokens must be (B, h*w, C) over the grid {(h, w)}, got "
                         f"{tuple(x.shape)}")
    c = x.shape[2]
    takes = (swin_pre_takes(x.dtype, h, w, win, c) if hidden is None
             else swin_post_takes(x.dtype, h, w, win, c, hidden))
    if not takes:
        raise ValueError(f"{name}: the kernel takes bf16 tokens, window 8 over an (h, w) grid "
                         f"of its multiples, C a multiple of 4 up to {MAX_C} and a hidden a "
                         f"multiple of 4 up to {MAX_HIDDEN}; got {x.dtype}, window {win}, "
                         f"grid {(h, w)}, C {c}, hidden {hidden}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: tokens must be contiguous and 16-byte aligned")


def _vec(t: torch.Tensor, what: str, n: int, dev: torch.device) -> torch.Tensor:
    t = t.detach().float().contiguous()
    check(t, what, torch.float32, (n,), dev)
    return t


def _padded(w: torch.Tensor, packed: Optional[torch.Tensor], what: str, shape: tuple,
            dev: torch.device) -> torch.Tensor:
    wp = pad_weight(w.detach()) if packed is None else packed
    check(wp, f"{what} (pad_weight)", torch.bfloat16, shape, dev)
    return wp


def _swin_pre(x, ln_s, ln_b, wqkv, bqkv, h, w, win, d, eps, w_packed
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return plain_swin_pre(x, ln_s, ln_b, wqkv, bqkv, h, w, win, d, eps)
    _check_tokens("swin_pre", x, h, w, win)
    b, l, c = x.shape
    dev = x.device
    with torch.no_grad():
        wp = pad_weight(wqkv.detach()) if w_packed is None else w_packed
        check(wp, "swin_pre: w_packed", torch.bfloat16, (3 * c, -(-c // 64) * 64), dev)
        s, sh = _vec(ln_s, "swin_pre: ln_s", c, dev), _vec(ln_b, "swin_pre: ln_b", c, dev)
        bias = _vec(bqkv, "swin_pre: bqkv", 3 * c, dev)
    nw = (h // win) * (w // win)
    qkv = torch.empty((b, nw, WIN_TOKENS, 3 * c), device=dev, dtype=torch.bfloat16)
    xr = torch.empty_like(x)
    with on_device(dev):
        err = _symbol("swin_pre")(x.data_ptr(), s.data_ptr(), sh.data_ptr(), wp.data_ptr(),
                                  bias.data_ptr(), qkv.data_ptr(), xr.data_ptr(), b, h, w, win,
                                  c, d, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("swin_pre", err)
    launches["swin_pre"] += 1
    shapes[("swin_pre", b, h, w, c, win, d)] += 1
    return qkv, xr


def _swin_post(attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, h, w, win, eps,
               packed) -> torch.Tensor:
    if xr.device.type == "cpu":
        return plain_swin_post(attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, h, w, win,
                               eps)
    hidden = w1.shape[0]
    _check_tokens("swin_post", xr, h, w, win, hidden)
    b, l, c = xr.shape
    dev = xr.device
    nw = (h // win) * (w // win)
    check(attn, "swin_post: attn", torch.bfloat16, (b, nw, WIN_TOKENS, c), dev)
    pk = (None, None, None) if packed is None else packed
    kc, kh = -(-c // 64) * 64, -(-hidden // 64) * 64
    with torch.no_grad():
        wp = _padded(wproj, pk[0], "swin_post: proj weight", (c, kc), dev)
        w1p = _padded(w1, pk[1], "swin_post: fc1 weight", (hidden, kc), dev)
        w2p = _padded(w2, pk[2], "swin_post: fc2 weight", (c, kh), dev)
        vecs = [_vec(t, f"swin_post: {what}", n, dev) for t, what, n in (
            (bproj, "proj bias", c), (ln2s, "ln2 scale", c), (ln2b, "ln2 shift", c),
            (b1, "fc1 bias", hidden), (b2, "fc2 bias", c))]
    bp, s, sh, bias1, bias2 = vecs
    out = torch.empty_like(xr)
    with on_device(dev):
        err = _symbol("swin_post")(attn.data_ptr(), xr.data_ptr(),
                                   wp.data_ptr(), bp.data_ptr(), s.data_ptr(), sh.data_ptr(),
                                   w1p.data_ptr(), bias1.data_ptr(), w2p.data_ptr(),
                                   bias2.data_ptr(), out.data_ptr(), b, h, w, win, c, hidden,
                                   float(eps), post_split(b, h, w, win, hidden),
                                   torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("swin_post", err)
    launches["swin_post"] += 1
    shapes[("swin_post", b, h, w, c, win, hidden)] += 1
    return out


class _SwinPre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, h, w, win, d, eps, w_packed):
        ctx.save_for_backward(x, ln_s, ln_b, wqkv, bqkv)
        ctx.dims = h, w, win, d, eps
        return _swin_pre(x, ln_s, ln_b, wqkv, bqkv, h, w, win, d, eps, w_packed)

    @staticmethod
    def backward(ctx, *grads):
        return recompute_grads(ctx.needs_input_grad,
                               lambda *a: plain_swin_pre(*a, *ctx.dims), grads,
                               ctx.saved_tensors) + (None,) * 6


class _SwinPost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, h, w, win, eps,
                packed):
        ctx.save_for_backward(attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2)
        ctx.dims = h, w, win, eps
        return _swin_post(attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, h, w, win, eps,
                          packed)

    @staticmethod
    def backward(ctx, grad):
        return recompute_grads(ctx.needs_input_grad,
                               lambda *a: plain_swin_post(*a, *ctx.dims), grad,
                               ctx.saved_tensors) + (None,) * 5


def swin_pre(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor, wqkv: torch.Tensor,
             bqkv: torch.Tensor, h: int, w: int, win: int, d: int, eps: float = 1e-5, *,
             w_packed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LN1 + roll(-d) + qkv + window partition: the ``swin_pre`` kernel on
    CUDA tensors, :func:`plain_swin_pre` on CPU tensors; differentiable (the
    plain version's gradients). ``w_packed``: the bf16 copy of ``wqkv``
    zero-padded by :func:`pad_weight` (made here, per call, when not
    given)."""
    if needs_grad(x, ln_s, ln_b, wqkv, bqkv):
        return _SwinPre.apply(x, ln_s, ln_b, wqkv, bqkv, h, w, win, d, eps, w_packed)
    return _swin_pre(x, ln_s, ln_b, wqkv, bqkv, h, w, win, d, eps, w_packed)


def swin_post(attn: torch.Tensor, xr: torch.Tensor, wproj: torch.Tensor,
              bproj: torch.Tensor, ln2s: torch.Tensor, ln2b: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              h: int, w: int, win: int, eps: float = 1e-5, *,
              packed: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Window reverse + proj + residual + LN2 + MLP + residual: the
    ``swin_post`` kernel on CUDA tensors, :func:`plain_swin_post` on CPU
    tensors; differentiable (the plain version's gradients). ``packed``: the
    zero-padded bf16 copies (:func:`pad_weight`) of (wproj, w1, w2) (made
    here, per call, when not given)."""
    if needs_grad(attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2):
        return _SwinPost.apply(attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, h, w, win,
                               eps, packed)
    return _swin_post(attn, xr, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, h, w, win, eps,
                      packed)
