"""edtr_torch/ops/geglu.py and the FeedForward's two forms against
edtr_tpu, on the CPU with numpy-seeded inputs.

* Ops: the port's ``geglu_proj`` and ``ln_geglu_proj`` (their plain versions
  on CPU tensors, given the FeedForward's packed (2*inner, C) weight) against
  JAX's reference math (``_ref``, ``_ln_ref``, given the halves) and its
  Pallas kernels in interpret mode (``_FORCE_KERNEL``) in fp32 at 2e-5,
  under float32 matmul precision; and in bf16 against JAX's reference in
  bf16, within 2 bf16 ulps of max|out|.
* Eligibility: the port's ``supported`` rules are JAX's, shape by shape.
* The FeedForward in bf16 inside ``layers.fused_proj()``: the split-halves
  form at 256 tokens (JAX's ``will_fuse`` with the family forced) and the
  packed form at 64 tokens, each against the JAX FeedForward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.ops import geglu as JGG
from edtr_tpu.ops import ln_matmul as JLM

from edtr_torch.models.layers import fused_proj
from edtr_torch.ops import geglu as GG
from edtr_torch.ops import ln_matmul as LM
from torch_port_helpers import jax_tiny, port_tiny, t2n


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OP_TOL = dict(rtol=0, atol=2e-5)


def _args(b=2, n=256, c=64, inner=256, seed=0):
    g = np.random.default_rng(seed)
    x = (g.standard_normal((b, n, c)) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * g.standard_normal(c)).astype(np.float32)
    sh = (0.1 * g.standard_normal(c)).astype(np.float32)
    wh, wg = ((g.standard_normal((c, inner)) * c ** -0.5).astype(np.float32)
              for _ in range(2))
    bh, bg = ((0.1 * g.standard_normal(inner)).astype(np.float32) for _ in range(2))
    return x, s, sh, wh, wg, bh, bg


def _packed(wh, wg, bh, bg):
    """The halves as the FeedForward's ``ff.net.0.proj`` Linear holds them:
    (2*inner, C) weight, h rows first, and the (2*inner,) bias."""
    w = np.concatenate([wh.T, wg.T])
    return torch.from_numpy(np.ascontiguousarray(w)), torch.from_numpy(np.concatenate([bh, bg]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _port(ln, x, s, sh, w, b):
    if ln:
        return GG.ln_geglu_proj(x, s, sh, w, b)
    return GG.geglu_proj(x, w, b)


@pytest.mark.parametrize("ln", [False, True], ids=["geglu_proj", "ln_geglu_proj"])
def test_geglu_matches_jax(monkeypatch, ln):
    x, s, sh, wh, wg, bh, bg = _args(seed=1 + ln)
    halves = [jnp.asarray(a) for a in (wh, wg, bh, bg)]
    jx = jnp.asarray(x)
    with jax.default_matmul_precision("float32"):
        if ln:
            norm = (jnp.asarray(s), jnp.asarray(sh))
            ref = np.asarray(JGG._ln_ref(jx, *norm, *halves))
            monkeypatch.setattr(JGG, "_FORCE_KERNEL", True)
            kern = np.asarray(JGG.ln_geglu_proj(jx, *norm, *halves))
        else:
            ref = np.asarray(JGG._ref(jx, *halves))
            monkeypatch.setattr(JGG, "_FORCE_KERNEL", True)
            kern = np.asarray(JGG.geglu_proj(jx, *halves))
    got = t2n(_port(ln, _t(x), _t(s), _t(sh), *_packed(wh, wg, bh, bg)))
    assert got.shape == (2, 256, 256)
    np.testing.assert_allclose(got, ref, **OP_TOL)
    np.testing.assert_allclose(got, kern, **OP_TOL)


@pytest.mark.parametrize("ln", [False, True], ids=["geglu_proj", "ln_geglu_proj"])
def test_bf16_matches_jax_reference(ln):
    """In bf16 both sides round at the same places: the LN output, nothing
    before the GELU (both biases added to the fp32 sums), the product once."""
    x, s, sh, wh, wg, bh, bg = _args(seed=3 + ln)
    xb = jnp.asarray(x, jnp.bfloat16)
    halves = [jnp.asarray(a) for a in (wh, wg, bh, bg)]
    if ln:
        ref = JGG._ln_ref(xb, jnp.asarray(s), jnp.asarray(sh), *halves)
    else:
        ref = JGG._ref(xb, *halves)
    got = _port(ln, _t(x).bfloat16(), _t(s), _t(sh), *_packed(wh, wg, bh, bg))
    assert got.dtype == torch.bfloat16
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(t2n(got), r, rtol=0, atol=2 * bf16_ulp(np.abs(r).max()))


def test_cpu_wrappers_take_the_plain_versions():
    x, s, sh, wh, wg, bh, bg = _args(seed=5)
    x, s, sh = _t(x), _t(s), _t(sh)
    w, b = _packed(wh, wg, bh, bg)
    before = dict(GG.launches)
    torch.testing.assert_close(GG.geglu_proj(x, w, b), GG.plain_geglu_proj(x, w, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(GG.ln_geglu_proj(x, s, sh, w, b),
                               GG.plain_ln_geglu_proj(x, s, sh, w, b), rtol=0, atol=0)
    assert GG.launches == before


@pytest.mark.parametrize("n,c,inner", [
    (4096, 320, 1280), (1024, 640, 2560), (256, 1280, 5120),  # the 512² flagship levels
    (64, 1280, 5120),                                          # the mid block
    (256, 32, 128), (512, 96, 384), (256, 8192, 8192), (256, 4096, 1408)])
def test_supported_is_jax_rule(n, c, inner):
    assert GG.supported(n, c, inner) == JGG.supported(n, c, inner)
    assert GG._col_tile(c, inner) == JGG._col_tile(c, inner)
    assert LM.supported(n) == JLM.supported(n)


@pytest.mark.parametrize("n", [256, 64], ids=["split_halves", "packed"])
def test_feedforward_forms_match_jax_bf16(monkeypatch, n):
    """bf16 shows which form ran: the split-halves form adds both biases in
    fp32 before the GELU, the packed one rounds the projection first and
    adds its bias in bf16. JAX takes the split form where ``will_fuse``
    holds (forced: 256 tokens) and the packed form elsewhere; so must the
    port inside ``fused_proj()``."""
    from edtr_tpu.models.attention import FeedForward as JFF

    from edtr_torch.models.attention import FeedForward

    _, params = jax_tiny()
    src = port_tiny().cldm.unet.input_blocks[1][1].transformer_blocks[0]
    ff = FeedForward(32, dtype=torch.bfloat16)
    ff.load_state_dict(src.ff.state_dict(), strict=True)
    norm = src.norm3
    x = (np.random.default_rng(40 + n).standard_normal((2, n, 32)) * 2 + 0.5).astype(np.float32)
    xb = _t(x).bfloat16()

    monkeypatch.setattr(JGG, "_FORCE_KERNEL", True)
    pre = (jnp.asarray(t2n(norm.weight)), jnp.asarray(t2n(norm.bias)))
    y_j = JFF(dim=32, dtype=jnp.bfloat16).apply(
        {"params": params["unet"]["input_blocks_1_1"]["blocks_0"]["ff"]},
        jnp.asarray(x, jnp.bfloat16), pre_norm=pre)
    calls = []
    plain = GG.plain_ln_geglu_proj

    def rec(*args, **kwargs):
        calls.append(args[0].shape[1])
        return plain(*args, **kwargs)
    monkeypatch.setattr(GG, "plain_ln_geglu_proj", rec)
    with torch.no_grad(), fused_proj():
        y_t = ff(xb, pre_norm=norm)
    assert calls == ([n] if n == 256 else [])
    assert y_t.dtype == torch.bfloat16
    r = np.asarray(y_j.astype(jnp.float32))
    np.testing.assert_allclose(t2n(y_t), r, rtol=0, atol=2 * bf16_ulp(np.abs(r).max()))
    if n == 256:
        # the split form rounds where JAX's does, so (nearly) every element is
        # equal; the packed form at this shape leaves ~4% a bf16 ulp apart
        assert (t2n(y_t) == r).mean() >= 0.99


# (N, C, inner) of calls around the GEGLU kernels' conditions: the
# flagship's three levels, JAX's rule (the 64-token mid block), C % 32, C
# within a block's shared memory (<= 1600), inner % 32 (80 passes JAX's
# rule and not the kernels'), inner % 64 (64-row weight tiles)
GEGLU_CALLS = [(4096, 320, 1280), (1024, 640, 2560), (256, 1280, 5120), (64, 320, 1280),
               (256, 32, 80), (256, 48, 192), (256, 1600, 640), (256, 1632, 640),
               (512, 96, 224)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["geglu_proj", "ln_geglu_proj"])
@pytest.mark.parametrize("n,c,inner", GEGLU_CALLS)
def test_launchers_raise_exactly_where_geglu_takes_refuses(monkeypatch, n, c, inner, name,
                                                           dtype):
    """``geglu_takes`` holds exactly where both GEGLU launchers take a call
    (bf16, JAX's ``supported``, C % 32 up to 1600, inner % 32): the
    launcher, on meta tensors with a stub for the kernel, launches once
    where it holds and raises ValueError where it does not."""
    import contextlib
    import types

    monkeypatch.setattr(GG, "_symbol", lambda: (lambda *args: 0))
    monkeypatch.setattr(GG, "on_device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    takes = GG.geglu_takes(dtype, n, c, inner)
    assert takes == (dtype == torch.bfloat16 and GG.supported(n, c, inner) and c % 32 == 0
                     and c <= 1600 and inner % 32 == 0)

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, device="meta", dtype=dt)
    x, w, b = meta(1, n, c, dt=dtype), meta(2 * inner, c), meta(2 * inner)
    wp = meta(2 * inner, c, dt=torch.bfloat16)
    if name == "geglu_proj":
        def call():
            return GG.geglu_proj(x, w, b, w_packed=wp)
    else:
        def call():
            return GG.ln_geglu_proj(x, meta(c), meta(c), w, b, w_packed=wp)
    before = GG.launches[name]
    if takes:
        call()
        assert GG.launches[name] == before + 1
    else:
        with pytest.raises(ValueError):
            call()
        assert GG.launches[name] == before


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n,c,inner,plan", [
    (4096, 320, 1280, (128, 128, 4)), (1024, 640, 2560, (128, 128, 16)),
    (256, 1280, 5120, (64, 128, 33)), (512, 96, 224, (128, 64, 7))])
def test_geglu_proj_plan(b, n, c, inner, plan):
    """K7a's tile plan (``lnproj_plan(..., "geglu_proj")``): 128-token blocks
    where the (128, C) tokens fit beside a 2-stage weight ring (C <= 640),
    else 64; 128 weight rows a tile (64 h + 64 gate) where inner % 64 == 0;
    as many column groups as one wave of 132 blocks takes. The plan fits
    the block's shared memory and never asks for more blocks than SMs."""
    from edtr_torch.ops import _proj

    m = b * n
    bm, bn, groups = _proj.lnproj_plan(m, c, 2 * inner, "geglu_proj")
    if b == 1:
        assert (bm, bn, groups) == plan
    assert (bm, bn) == plan[:2]
    assert m % bm == 0 and (2 * inner) % bn == 0 and inner % (bn // 2) == 0
    assert 1 <= groups <= 2 * inner // bn and (m // bm) * groups <= _proj.SMS
    assert _proj.lnproj_stages(bn, c, bm) >= 2
    assert _proj.lnproj_smem(bn, c, _proj.lnproj_stages(bn, c, bm), bm) <= _proj.SMEM_LIMIT
