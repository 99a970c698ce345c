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
