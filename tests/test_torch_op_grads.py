"""The gradients of edtr_torch's K7-K10 autograd Functions against
``jax.vjp`` through the edtr_tpu ops, on the CPU with numpy-seeded inputs
and cotangents.

JAX gives ``ln_matmuls``, ``affine_matmul``, ``geglu_proj``,
``ln_geglu_proj``, ``window_attention``, ``swin_pre`` and ``swin_post`` each
a ``custom_vjp`` that recomputes its reference math; the port's wrappers are
``torch.autograd.Function``s whose backward is autograd of the plain version
at the saved inputs (``edtr_torch/ops/_grad.py``). Each op runs on the JAX
side as the JAX op tests run it (the Pallas kernel in interpret mode where
the op has a switch for it), at the shapes of the forward tests.

* fp32 under float32 matmul precision: every gradient within 2e-5 of the
  largest of its kind (the two sides sum in other orders).
* bf16 tokens (fp32 weights, as the modules hold them): within 2 bf16 ulps
  of the largest gradient of its kind, the tolerance of the op tests. One
  gradient is held to its exact value instead: ``affine_matmul``'s bias
  gradient in bf16 is the sum over the tokens of the bf16 cotangent (the
  bias is added in bf16), which XLA's CPU reduction rounds in bf16 (2.2
  ulps from the exact sum at this shape) where torch sums in fp32 (0.5).
* The weight copies (``w_packed``/``packed``) and the shift mask get no
  gradient; an output given none counts as zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.ops import geglu as JGG
from edtr_tpu.ops import ln_matmul as JLM
from edtr_tpu.ops import swin_block as JSB
from edtr_tpu.ops import window_attention as JWA

from edtr_torch.ops import geglu as GG
from edtr_torch.ops import ln_matmul as LM
from edtr_torch.ops import swin_block as SB
from edtr_torch.ops import window_attention as WA


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OP_TOL = 2e-5
SWIN = dict(h=16, w=16, win=8)


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _rand(g, *shape, scale=1.0, mean=0.0):
    return (mean + scale * g.standard_normal(shape)).astype(np.float32)


def _tokens(g, *shape):
    # a mean and a spread per row, as a residual stream has
    return (g.standard_normal(shape) * 2 + 0.5).astype(np.float32)


def _case(op: str, g):
    """(JAX function, port function, numpy args, token-arg indices, the
    port's layout of each arg: ``"T"`` for a JAX (in, out) kernel that the
    port holds as (out, in), ``None`` as it is). Both functions take the
    args in the same order; the port's take them in its layout."""
    b, n, c = 1, 256, 64
    if op.startswith("ln_matmuls"):
        k = int(op[-1])
        args = [_tokens(g, b, n, c), _rand(g, c, mean=1.0, scale=0.1), _rand(g, c, scale=0.1)]
        args += [_rand(g, c, 128, scale=c ** -0.5) for _ in range(k)]
        return (lambda x, s, sh, *ws: JLM.ln_matmuls(x, s, sh, *ws),
                lambda x, s, sh, *ws: LM.ln_matmuls(x, s, sh, ws),
                args, (0,), [None] * 3 + ["T"] * k)
    if op == "affine_matmul":
        args = [_tokens(g, b, n, c), _rand(g, b, c, mean=1.0, scale=0.1),
                _rand(g, b, c, scale=0.1), _rand(g, c, 128, scale=c ** -0.5),
                _rand(g, 128, scale=0.1)]
        return JLM.affine_matmul, LM.affine_matmul, args, (0,), [None] * 3 + ["T", None]
    if op in ("geglu_proj", "ln_geglu_proj"):
        inner = 128
        ln = op == "ln_geglu_proj"
        args = [_tokens(g, b, n, c)]
        if ln:
            args += [_rand(g, c, mean=1.0, scale=0.1), _rand(g, c, scale=0.1)]
        args += [_rand(g, c, inner, scale=c ** -0.5), _rand(g, c, inner, scale=c ** -0.5),
                 _rand(g, inner, scale=0.1), _rand(g, inner, scale=0.1)]
        jfn = JGG.ln_geglu_proj if ln else JGG.geglu_proj

        def port(x, *rest):  # the packed (2*inner, C) weight and bias of the module
            *norm, wh, wg, bh, bg = rest
            w = torch.cat([wh.T, wg.T])
            bias = torch.cat([bh, bg])
            return GG.ln_geglu_proj(x, *norm, w, bias) if ln else GG.geglu_proj(x, w, bias)
        return jfn, port, args, (0,), [None] * len(args)
    if op.startswith("window_attention"):
        bw, nt, heads, d = 8, 64, 3, 30
        q, k, v = (_rand(g, bw, nt, heads, d) for _ in range(3))
        bias = _rand(g, heads, nt, nt, scale=0.1)
        nw = 4 if op.endswith("masked") else None
        mask = (None if nw is None else
                np.where(g.random((nw, nt, nt)) > 0.7, -100.0, 0.0).astype(np.float32))

        def jfn(q, k, v, bias):
            return JWA.window_attention(q, k, v, bias, None if mask is None else
                                        jnp.asarray(mask), d ** -0.5)

        def port(q, k, v, bias):
            return WA.window_attention(q, k, v, bias, None if mask is None else
                                       torch.from_numpy(mask), d ** -0.5)
        return jfn, port, [q, k, v, bias], (0, 1, 2), [None] * 4
    c, hidden = 60, 120
    if op.startswith("swin_pre"):
        dd = int(op.split("_")[-1])
        args = [_tokens(g, b, SWIN["h"] * SWIN["w"], c), _rand(g, c, mean=1.0, scale=0.1),
                _rand(g, c, scale=0.1), _rand(g, c, 3 * c, scale=c ** -0.5),
                _rand(g, 3 * c, scale=0.1)]
        dims = (SWIN["h"], SWIN["w"], SWIN["win"], dd)
        return (lambda *a: JSB.swin_pre(*a, *dims), lambda *a: SB.swin_pre(*a, *dims),
                args, (0,), [None] * 3 + ["T", None])
    args = [_rand(g, b, 4, 64, c), _tokens(g, b, SWIN["h"] * SWIN["w"], c),
            _rand(g, c, c, scale=c ** -0.5), _rand(g, c, scale=0.1),
            _rand(g, c, mean=1.0, scale=0.1), _rand(g, c, scale=0.1),
            _rand(g, c, hidden, scale=c ** -0.5), _rand(g, hidden, scale=0.1),
            _rand(g, hidden, c, scale=hidden ** -0.5), _rand(g, c, scale=0.1)]
    dims = (SWIN["h"], SWIN["w"], SWIN["win"])
    return (lambda *a: JSB.swin_post(*a, *dims), lambda *a: SB.swin_post(*a, *dims),
            args, (0, 1), [None, None] + ["T", None, None, None, "T", None, "T", None])


OPS = ["ln_matmuls_1", "ln_matmuls_3", "affine_matmul", "geglu_proj", "ln_geglu_proj",
       "window_attention", "window_attention_masked", "swin_pre_4", "swin_pre_-4",
       "swin_post"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("op", OPS)
def test_function_gradients_match_jax(monkeypatch, op, dtype):
    g = np.random.default_rng(60 + OPS.index(op))
    jfn, pfn, args, tokens, layout = _case(op, g)
    for mod in (JLM, JGG, JSB):  # the Pallas kernels, in interpret mode
        monkeypatch.setattr(mod, "_FORCE_KERNEL", True)
    bf16 = dtype == "bf16"
    jargs = [jnp.asarray(a, jnp.bfloat16 if bf16 and i in tokens else jnp.float32)
             for i, a in enumerate(args)]
    targs = [torch.from_numpy(np.ascontiguousarray(a.T if lay == "T" else a))
             for a, lay in zip(args, layout)]
    targs = [t.bfloat16() if bf16 and i in tokens else t for i, t in enumerate(targs)]
    targs = [t.requires_grad_() for t in targs]
    with jax.default_matmul_precision("float32"):
        outs, vjp = jax.vjp(jfn, *jargs)
        multi = isinstance(outs, (tuple, list))
        outs = tuple(outs) if multi else (outs,)
        cots = [jnp.asarray(g.standard_normal(o.shape), o.dtype) for o in outs]
        want = vjp(tuple(cots) if multi else cots[0])
    got_outs = pfn(*targs)
    got_outs = tuple(got_outs) if isinstance(got_outs, (tuple, list)) else (got_outs,)
    assert all(o.grad_fn is not None for o in got_outs)
    tcots = [torch.from_numpy(np.array(cot.astype(jnp.float32))).to(o.dtype)
             for cot, o in zip(cots, got_outs)]
    got = torch.autograd.grad(got_outs, targs, tcots)
    for i, (a, w, lay) in enumerate(zip(got, want, layout)):
        w = np.asarray(w.astype(jnp.float32))
        w = w.T if lay == "T" else w
        if bf16 and (op, i) == ("affine_matmul", 4):  # the exact bias gradient
            w = np.asarray(cots[0].astype(jnp.float32)).sum((0, 1))
        assert a.shape == w.shape, (op, i)
        scale = np.abs(w).max()
        tol = 2 * bf16_ulp(scale) if bf16 else OP_TOL * max(scale, 1.0)
        np.testing.assert_allclose(a.detach().float().numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"{op} grad {i}")


def test_weight_copies_and_mask_get_no_gradient():
    """``w_packed``, the Swin block's packed weights and the shift mask are
    inputs of the Functions that never get a gradient, even when they ask
    for one; an output of ``ln_matmuls``/``swin_pre`` given no gradient
    counts as zero."""
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen).requires_grad_()
    x, s, sh, w = r(2, 256, 64), r(64), r(64), r(128, 64)
    wp = w.detach().clone().requires_grad_()
    q, k = LM.ln_matmuls(x, s, sh, [w, w], w_packed=wp)
    gx, gw = torch.autograd.grad(q.sum(), (x, w))  # k given no gradient: zero
    want = torch.autograd.grad(LM.plain_ln_matmuls(x, s, sh, [w])[0].sum(), (x, w))
    torch.testing.assert_close(gx, want[0], rtol=0, atol=0)
    torch.testing.assert_close(gw, want[1], rtol=0, atol=0)
    assert wp.grad is None
    q, k = LM.ln_matmuls(x, s, sh, [w, w], w_packed=wp)
    (k.sum() + q.sum()).backward()
    assert wp.grad is None and w.grad is not None

    qkv = r(8, 64, 3, 2, 30)
    bias = r(2, 64, 64)
    mask = torch.zeros((4, 64, 64), requires_grad=True)
    out = WA.window_attention(*qkv.unbind(2), bias, mask)
    out.sum().backward()
    assert qkv.grad is not None and bias.grad is not None and mask.grad is None

    xs = r(2, 256, 12)
    pre = (r(12), r(12), r(36, 12), r(36))
    packed = pre[2].detach().clone().requires_grad_()
    qkv_w, xr = SB.swin_pre(xs, *pre, 16, 16, 8, 4, w_packed=packed)
    gx = torch.autograd.grad(qkv_w.sum(), xs)[0]  # xr given no gradient: zero
    want = torch.autograd.grad(SB.plain_swin_pre(xs, *pre, 16, 16, 8, 4)[0].sum(), xs)[0]
    torch.testing.assert_close(gx, want, rtol=0, atol=0)
    assert packed.grad is None
