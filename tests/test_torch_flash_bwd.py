"""The port's flash-attention backward against ``edtr_tpu``'s, on the CPU.

* ``flash_attention`` gradients: the port's autograd Function (on CPU
  tensors its forward and backward wrappers compute the plain versions)
  against ``jax.grad`` of ``edtr_tpu.ops.flash_attention.flash_attention``,
  whose Pallas kernels run in interpret mode as the JAX package's own tests
  run them, at (N, D) = (1024, 64) (``_whole_bwd_flat``), (2048, 64)
  (``_flash_bwd_flat``: ``_dq_kernel`` + ``_dkv_kernel``) and (2048, 256)
  (``_xla_bwd_flat``), with a non-uniform cotangent as in
  tests/test_pipeline_and_kernels.py. fp32 at 2e-5; bf16 within 2 bf16
  ulps of max|grad|.
* ``plain_bwd`` against ``_xla_bwd_flat`` on identical (q, k, v, dO, lse,
  D), and the port's backward dispatch against JAX's ``_bwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.ops import flash_attention as JF
from edtr_torch.ops import flash_attention as F

OP_TOL = dict(rtol=2e-5, atol=2e-5)
# (N, D) and the backward each takes, in JAX and in the port
CASES = [((1024, 64), "whole_bwd"), ((2048, 64), "flash_bwd"), ((2048, 256), "plain_bwd")]
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test processes on a few cores; torch's own
    thread pool in each of them would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _close(got: torch.Tensor, want, dtype: str, what: str) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = OP_TOL if dtype == "f32" else dict(rtol=0, atol=2 * bf16_ulp(np.abs(want).max()))
    assert got.dtype == _TDT[dtype], what
    np.testing.assert_allclose(got.float().numpy(), want, err_msg=what, **tol)


def _inputs(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, n, 2, d)).astype(np.float32) for _ in range(3)]


def _cotangent(shape) -> np.ndarray:
    size = int(np.prod(shape))
    return np.sin(np.arange(size, dtype=np.float32)).reshape(shape)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nd,bwd", CASES)
def test_flash_attention_gradients_match_jax(nd, bwd, dtype):
    n, d = nd
    assert F.bwd_kernel_for(n, d) == bwd
    q, k, v = _inputs(n, d, seed=n + d)
    w = _cotangent(q.shape)
    scale = d ** -0.5

    def loss(q_, k_, v_):
        out = JF.flash_attention(q_, k_, v_, scale).astype(jnp.float32)
        return (out * w).sum()

    gj = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, _JDT[dtype]) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).to(_TDT[dtype]).requires_grad_() for a in (q, k, v))
    before = dict(F.launches)
    out = F.flash_attention(qt, kt, vt, scale)
    gt = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), (qt, kt, vt))
    assert F.launches == before  # CPU tensors: the plain versions, no launch
    for name, a, b in zip(("dq", "dk", "dv"), gt, gj):
        _close(a, b, dtype, f"{bwd} {dtype} {name}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(512, 64), (1024, 256)])
def test_plain_bwd_matches_xla_bwd(n, d, dtype):
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((2, n, d)).astype(np.float32) for _ in range(4))
    scale = d ** -0.5
    # lse and D as the forward and JAX's _bwd would make them (fp32)
    s = np.einsum("bqd,bkd->bqk", q, k) * scale
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    dd = rng.standard_normal((2, n)).astype(np.float32) * 0.1
    lse = lse.astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, _JDT[dtype]) for a in (q, k, v, do))
    want = JF._xla_bwd_flat(jq, jk, jv, jdo, jnp.asarray(lse)[..., None],
                            jnp.asarray(dd)[..., None], scale)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(_TDT[dtype]) for a in (q, k, v, do))
    got = F.plain_bwd(tq, tk, tv, tdo, torch.from_numpy(lse), torch.from_numpy(dd), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, dtype, f"plain_bwd {dtype} {name}")


@pytest.mark.parametrize("n", [512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_bwd_dispatch_matches_jax(n, d, monkeypatch):
    called = []
    for fn in ("_xla_bwd_flat", "_whole_bwd_flat", "_flash_bwd_flat"):
        monkeypatch.setattr(JF, fn, lambda *a, _fn=fn: called.append(_fn) or (a[0],) * 3)
    x = jax.ShapeDtypeStruct((1, n, 1, d), jnp.float32)
    xf = jax.ShapeDtypeStruct((1, n, d), jnp.float32)
    lse = jax.ShapeDtypeStruct((1, n, 1), jnp.float32)
    jax.eval_shape(lambda res, g: JF._bwd(1.0, (*res, 1, 1), g), (xf, xf, xf, xf, lse), x)
    want = {"_xla_bwd_flat": "plain_bwd", "_whole_bwd_flat": "whole_bwd",
            "_flash_bwd_flat": "flash_bwd"}[called[0]]
    assert F.bwd_kernel_for(n, d) == want


def test_wrappers_compute_the_plain_backward_on_cpu():
    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(rng.standard_normal((2, 1024, 64)).astype(np.float32))
           for _ in range(4)]
    lse = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32)) + 8.0
    dd = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32)) * 0.1
    want = F.plain_bwd(*ins, lse, dd, 0.125)
    before = dict(F.launches)
    for got in (F.whole_bwd(*ins, lse, dd, 0.125), F.flash_bwd(*ins, lse, dd, 0.125),
                (F.flash_bwd_dq(*ins, lse, dd, 0.125), *F.flash_bwd_dkv(*ins, lse, dd, 0.125))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert F.launches == before


# the backward kernels' p: exp2 with log2(e) folded into the scale and into
# lse (one FFMA and one ex2 an element, csrc/flash_bwd_wgmma.cuh)
LOG2E = 1.4426950408889634


def exp2_bwd(qf, kf, vf, dof, lse, dd, scale):
    """``plain_bwd`` with p taken as the kernels take it, exp2(s * scale *
    log2(e) - lse * log2(e)); every other cast and product as
    ``plain_bwd``'s."""
    f32 = torch.float32
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2))
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    dv = torch.matmul(p.to(dof.dtype).to(f32).transpose(1, 2), dof.float()).to(vf.dtype)
    dp = torch.matmul(dof.float(), vf.float().transpose(1, 2))
    ds = (p * (dp - dd[..., None])).to(qf.dtype).to(f32)
    dq = (torch.matmul(ds, kf.float()) * scale).to(qf.dtype)
    dk = (torch.matmul(ds.transpose(1, 2), qf.float()) * scale).to(kf.dtype)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,jax_fn", [(256, "_whole_bwd_flat"), (1024, "_flash_bwd_flat")])
def test_exp2_formula_matches_plain_bwd_and_pallas(n, jax_fn, dtype):
    """The kernels' exp2 form of p against ``plain_bwd`` and against JAX's
    Pallas backward (``_whole_bwd_kernel``; ``_dq_kernel`` + ``_dkv_kernel``)
    in interpret mode, on the lse and D of a forward, with the logits scaled
    up (q x 3) so that p spans many binades: fp32 within 2e-5, bf16 within
    2 bf16 ulps of max|grad| (a rounding of p or dS may flip)."""
    rng = np.random.default_rng(n)
    q, k, v, do = (rng.standard_normal((1, n, 64)).astype(np.float32) for _ in range(4))
    q *= 3
    scale = 0.125
    tq, tk, tv, tdo = (torch.from_numpy(a).to(_TDT[dtype]) for a in (q, k, v, do))
    out, lse = F.plain_fwd(tq, tk, tv, scale)
    dd = (tdo.float() * out.float()).sum(-1)
    got = exp2_bwd(tq, tk, tv, tdo, lse, dd, scale)
    want = getattr(JF, jax_fn)(*(jnp.asarray(a, _JDT[dtype]) for a in (q, k, v, do)),
                               jnp.asarray(lse.numpy())[..., None],
                               jnp.asarray(dd.numpy())[..., None], scale)
    plain = F.plain_bwd(tq, tk, tv, tdo, lse, dd, scale)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, plain):
        _close(a, b, dtype, f"exp2 vs {jax_fn} {dtype} {name}")
        _close(a, c.float().numpy(), dtype, f"exp2 vs plain_bwd {dtype} {name}")


@pytest.mark.parametrize("d", [64, 128])
def test_bwd_row_tile_divides_every_supported_n(d):
    """Every N that ``shapes_supported`` admits at D <= 128 reaches a
    backward wrapper whose kernels take it (a multiple of the row tile)."""
    for n in range(64, 16385, 64):
        q = torch.empty((1, n, 2, d), device="meta")
        if F.shapes_supported(q, q, q):
            assert F.bwd_kernel_for(n, d) in ("whole_bwd", "flash_bwd")
            assert n % F.BWD_ROW_TILE == 0, n
