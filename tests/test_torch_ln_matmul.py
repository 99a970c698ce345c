"""edtr_torch/ops/ln_matmul.py, the fused-projection configuration and the
channels-last GroupNorm statistics against edtr_tpu, on the CPU with
numpy-seeded inputs.

* Ops: the port's ``ln_matmuls`` (K = 1 and 3) and ``affine_matmul`` (their
  plain versions on CPU tensors) against JAX's reference math (``_ref``,
  ``_aff_ref``) and its Pallas kernels in interpret mode (``_FORCE_KERNEL``)
  in fp32 at 2e-5, under float32 matmul precision; and in bf16 against
  JAX's reference in bf16, within 2 bf16 ulps of max|out|.
* Modules: ``BasicTransformerBlock`` and ``SpatialTransformer`` at 16 x 16
  tokens inside ``layers.fused_proj()`` against the JAX blocks with the
  geglu and ln_matmul families forced, at 3e-3 (tests/test_torch_modules.py).
* The slice: the tiny restore in the conv+proj configuration against the
  port's stock restore, which ``test_torch_pipeline.py`` holds to JAX's at
  the same tolerances; the tiny UNet's transformers have 64 tokens, so the
  port takes 64-token tiles there (``SEQ_TILE``).
* The switch routes a block and only inside ``fused_proj()``; the
  SpatialTransformer copies strided (NCHW) tokens and counts it; the
  cached bf16 weight copies follow their parameters.
* ``gn_stats`` on channels-last tensors equals the NCHW path and JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.ops import geglu as JGG
from edtr_tpu.ops import ln_matmul as JLM

from edtr_torch.models.layers import Linear, fused_proj
from edtr_torch.ops import geglu as GG
from edtr_torch.ops import ln_matmul as LM
from torch_port_helpers import (CTX, IMAGE, jax_tiny, load_port, nchw, nhwc, port_tiny,
                                stock_restore, t2n)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OP_TOL = dict(rtol=0, atol=2e-5)
MOD_TOL = dict(rtol=3e-3, atol=3e-3)


def _tokens(g, b, n, c):
    # a mean and a spread per row, as a residual stream has
    return (g.standard_normal((b, n, c)) * 2 + 0.5).astype(np.float32)


def _ln_args(k, b=2, n=256, c=64, o=128, seed=0):
    g = np.random.default_rng(seed)
    x = _tokens(g, b, n, c)
    s = (1 + 0.1 * g.standard_normal(c)).astype(np.float32)
    sh = (0.1 * g.standard_normal(c)).astype(np.float32)
    ws = [(g.standard_normal((c, o)) * c ** -0.5).astype(np.float32) for _ in range(k)]
    return x, s, sh, ws


def _aff_args(b=2, n=256, c=64, o=128, seed=1):
    g = np.random.default_rng(seed)
    x = _tokens(g, b, n, c)
    mul = (1 + 0.1 * g.standard_normal((b, c))).astype(np.float32)
    add = (0.1 * g.standard_normal((b, c))).astype(np.float32)
    w = (g.standard_normal((c, o)) * c ** -0.5).astype(np.float32)
    bias = (0.1 * g.standard_normal(o)).astype(np.float32)
    return x, mul, add, w, bias


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("k", [1, 3])
def test_ln_matmuls_matches_jax(monkeypatch, k):
    x, s, sh, ws = _ln_args(k, seed=k)
    jargs = [jnp.asarray(a) for a in (x, s, sh, *ws)]
    with jax.default_matmul_precision("float32"):
        ref = [np.asarray(o) for o in JLM._ref(*jargs)]
        monkeypatch.setattr(JLM, "_FORCE_KERNEL", True)
        kern = [np.asarray(o) for o in JLM.ln_matmuls(*jargs)]
    got = LM.ln_matmuls(_t(x), _t(s), _t(sh), [_t(w.T) for w in ws])
    assert len(got) == k
    for gt, r, kn in zip(got, ref, kern):
        np.testing.assert_allclose(t2n(gt), r, **OP_TOL)
        np.testing.assert_allclose(t2n(gt), kn, **OP_TOL)


def test_affine_matmul_matches_jax(monkeypatch):
    args = _aff_args()
    jargs = [jnp.asarray(a) for a in args]
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(JLM._aff_ref(*jargs))
        monkeypatch.setattr(JLM, "_FORCE_KERNEL", True)
        kern = np.asarray(JLM.affine_matmul(*jargs))
    x, mul, add, w, bias = args
    got = t2n(LM.affine_matmul(_t(x), _t(mul), _t(add), _t(w.T), _t(bias)))
    np.testing.assert_allclose(got, ref, **OP_TOL)
    np.testing.assert_allclose(got, kern, **OP_TOL)


@pytest.mark.parametrize("op", ["ln_matmuls_1", "ln_matmuls_3", "affine_matmul"])
def test_bf16_matches_jax_reference(op):
    """In bf16 both sides round at the same places (the LN or affine, each
    product once; the affine's output again after the bf16 bias add)."""
    bf = jnp.bfloat16
    if op == "affine_matmul":
        x, mul, add, w, bias = _aff_args(seed=4)
        ref = [JLM._aff_ref(jnp.asarray(x, bf), jnp.asarray(mul), jnp.asarray(add),
                            jnp.asarray(w), jnp.asarray(bias))]
        got = [LM.affine_matmul(_t(x).bfloat16(), _t(mul), _t(add), _t(w.T), _t(bias))]
    else:
        k = int(op[-1])
        x, s, sh, ws = _ln_args(k, seed=5)
        ref = JLM._ref(jnp.asarray(x, bf), jnp.asarray(s), jnp.asarray(sh),
                       *[jnp.asarray(w) for w in ws])
        got = LM.ln_matmuls(_t(x).bfloat16(), _t(s), _t(sh), [_t(w.T) for w in ws])
    for gt, r in zip(got, ref):
        assert gt.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(t2n(gt), r, rtol=0, atol=2 * bf16_ulp(np.abs(r).max()))


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers compute the plain versions and launch
    nothing; the token rule is JAX's (N a multiple of 256)."""
    assert (LM.supported(256), LM.supported(1024), LM.supported(64)) == (True, True, False)
    x, s, sh, ws = _ln_args(3, seed=6)
    x, s, sh, ws = _t(x), _t(s), _t(sh), [_t(w.T) for w in ws]
    before = dict(LM.launches)
    for got, want in zip(LM.ln_matmuls(x, s, sh, ws), LM.plain_ln_matmuls(x, s, sh, ws)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    x, mul, add, w, bias = (_t(a) for a in _aff_args(seed=7))
    torch.testing.assert_close(LM.affine_matmul(x, mul, add, w.T, bias),
                               LM.plain_affine_matmul(x, mul, add, w.T, bias), rtol=0, atol=0)
    assert LM.launches == before


def _record_plain(monkeypatch):
    """Records the calls that reach the wrappers' plain versions (on CPU
    tensors: the fused path; the stock path runs stock modules)."""
    calls, depth = [], [0]
    for mod, name in ((LM, "plain_ln_matmuls"), (LM, "plain_affine_matmul"),
                      (GG, "plain_geglu_proj"), (GG, "plain_ln_geglu_proj")):
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, **kwargs):
            tag = _name[len("plain_"):]
            if tag == "ln_matmuls":
                tag += f"_k{len(args[3])}"
            if not depth[0]:  # plain_ln_geglu_proj calls plain_geglu_proj
                calls.append(tag)
            depth[0] += 1
            try:
                return _fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(mod, name, rec)
    return calls


def _jax_forced(monkeypatch):
    for mod in (JLM, JGG):
        monkeypatch.setattr(mod, "_FORCE_KERNEL", True)


def test_spatial_transformer_fused_matches_jax(monkeypatch):
    from edtr_tpu.models.attention import SpatialTransformer as JST

    from edtr_torch.models.attention import SpatialTransformer

    _, params = jax_tiny()
    src = port_tiny().cldm.unet.input_blocks[1][1]  # 32 ch, 2 heads x 16, context 64
    st = SpatialTransformer(32, 2, 16, context_dim=CTX[1])
    st.load_state_dict(src.state_dict(), strict=True)
    g = np.random.default_rng(31)
    x = g.standard_normal((2, 16, 16, 32)).astype(np.float32)
    ctx = g.standard_normal((2,) + CTX).astype(np.float32)
    _jax_forced(monkeypatch)
    with jax.default_matmul_precision("float32"):
        y_j = JST(in_channels=32, n_heads=2, d_head=16, context_dim=CTX[1]).apply(
            {"params": params["unet"]["input_blocks_1_1"]}, jnp.asarray(x), jnp.asarray(ctx))
    calls = _record_plain(monkeypatch)
    with torch.no_grad(), fused_proj():
        y_t = st(nchw(x), _t(ctx))
    assert calls == ["affine_matmul", "ln_matmuls_k3", "ln_matmuls_k1", "ln_geglu_proj"]
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), **MOD_TOL)


def test_transformer_block_fused_matches_jax(monkeypatch):
    from edtr_tpu.models.attention import BasicTransformerBlock as JBlock

    from edtr_torch.models.attention import BasicTransformerBlock

    _, params = jax_tiny()
    src = port_tiny().cldm.unet.input_blocks[1][1].transformer_blocks[0]
    blk = BasicTransformerBlock(32, 2, 16, CTX[1])
    blk.load_state_dict(src.state_dict(), strict=True)
    g = np.random.default_rng(32)
    x = _tokens(g, 2, 256, 32)
    ctx = g.standard_normal((2,) + CTX).astype(np.float32)
    _jax_forced(monkeypatch)
    with jax.default_matmul_precision("float32"):
        y_j = JBlock(dim=32, n_heads=2, d_head=16, context_dim=CTX[1]).apply(
            {"params": params["unet"]["input_blocks_1_1"]["blocks_0"]}, jnp.asarray(x),
            jnp.asarray(ctx))
    with torch.no_grad(), fused_proj():
        y_t = blk(_t(x), _t(ctx))
    np.testing.assert_allclose(t2n(y_t), np.asarray(y_j), **MOD_TOL)


@functools.lru_cache(maxsize=1)
def _conv_proj_restore():
    """The port's tiny restore in the conv+proj configuration (64-token
    tiles, so the tiny transformers take the fused path) on
    ``stock_restore``'s inputs and noise: (outputs as numpy, the plain
    versions' calls, layout copies)."""
    from edtr_torch.pipeline import build_flagship

    _, params = jax_tiny()
    port = build_flagship(tiny=True, dtype=None, device="cpu", fused_conv=True,
                          fused_proj=True)
    load_port(port, params)
    assert (port.fused_conv, port.fused_proj) == (True, True)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(LM, "SEQ_TILE", 64)
        mp.setattr(GG, "SEQ_TILE", 64)
        calls = _record_plain(mp)
        LM.layout_copies["count"] = 0
        out = port.eval().restore(*stock_restore()[0])
        copies = LM.layout_copies["count"]
    return {k: t2n(v) for k, v in out.items()}, tuple(calls), copies


def test_tiny_restore_conv_proj_matches_jax():
    """The slice as a whole: the port's tiny restore in the conv+proj
    configuration against its stock restore on the same inputs and noise
    (``torch_port_helpers.stock_restore``, which
    ``test_torch_pipeline.py::test_tiny_restore_matches_jax`` holds to
    JAX's restore at these tolerances), so held to JAX through it; JAX's
    ln_matmul and geglu Pallas kernels themselves are held op by op and
    block by block above. Each of the port's four main-path wrappers is
    reached."""
    out_t, calls, copies = _conv_proj_restore()
    out_j = stock_restore()[1]
    for name, tol in (("pre_restored", 2e-3), ("z", 5e-3), ("restored", 1e-2)):
        a, b = out_t[name], out_j[name]
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
    # 4 steps x (UNet 3 + ControlNet 1) transformers at 64 tokens; the
    # 16-token mid blocks stay on the plain math
    assert sorted(set(calls)) == ["affine_matmul", "ln_geglu_proj", "ln_matmuls_k1",
                                  "ln_matmuls_k3"]
    assert all(calls.count(c) == 16 for c in set(calls)), calls
    assert copies == 0


def test_fused_proj_switch_routes_a_block(monkeypatch):
    """Inside ``fused_proj()`` a SpatialTransformer at a supported token
    count reaches the four wrappers; outside any block, or in a nested
    ``fused_proj(False)``, none does, and leaving a block restores the
    configuration around it. Both paths compute the same function."""
    from edtr_torch.models import layers
    from edtr_torch.models.attention import SpatialTransformer

    calls = _record_plain(monkeypatch)
    st = SpatialTransformer(32, 2, 16, context_dim=16)
    g = np.random.default_rng(33)
    with torch.no_grad():
        for p in st.parameters():
            p.copy_(_t(g.standard_normal(tuple(p.shape)).astype(np.float32) * 0.1))
    x = nchw(g.standard_normal((1, 16, 16, 32)).astype(np.float32))
    ctx = _t(g.standard_normal((1, 7, 16)).astype(np.float32))
    with torch.no_grad():
        y_stock = st(x, ctx)
        assert calls == []
        with fused_proj():
            y_fused = st(x, ctx)
            assert len(calls) == 4
            with fused_proj(False):
                st(x, ctx)
                assert not layers.fused_proj_on()
            assert layers.fused_proj_on()
            st(x[:, :, :8, :8], ctx)  # 64 tokens: not a size the kernels take
        assert not layers.fused_proj_on()
    assert len(calls) == 4
    torch.testing.assert_close(y_fused, y_stock, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_stages_run_in_its_proj_configuration(monkeypatch, fused):
    """``EDTRPipeline(fused_proj=)`` sets the configuration around each
    stage (here the denoise walk) and only there."""
    from edtr_torch.models import layers
    from edtr_torch.pipeline import EDTRPipeline

    base = port_tiny()
    pipe = EDTRPipeline(base.swinir, base.cldm, base.diffusion, device="cpu",
                        fused_proj=fused)
    monkeypatch.setattr(LM, "SEQ_TILE", 64)
    monkeypatch.setattr(GG, "SEQ_TILE", 64)
    calls = _record_plain(monkeypatch)
    g = np.random.default_rng(34)
    hw = IMAGE // 8
    z = _t(g.standard_normal((1, 4, hw, hw)).astype(np.float32))
    c_txt = _t(g.standard_normal((1,) + CTX).astype(np.float32))
    out = pipe.denoise(z, c_txt, torch.zeros_like(z), torch.zeros((4,) + tuple(z.shape)))
    assert out.shape == z.shape
    assert len(calls) == (64 if fused else 0)
    assert not layers.fused_proj_on()


def test_spatial_transformer_copies_strided_tokens_and_counts():
    """NCHW activations give a strided token view: the fused path copies it
    once per call and counts the copy; channels-last ones give none."""
    from edtr_torch.models.attention import SpatialTransformer

    st = SpatialTransformer(32, 2, 16, context_dim=16)
    x = torch.randn(1, 32, 16, 16)
    ctx = torch.randn(1, 7, 16)
    LM.layout_copies["count"] = 0
    with torch.no_grad(), fused_proj():
        y_nchw = st(x, ctx)
        assert LM.layout_copies["count"] == 1
        y_cl = st(x.contiguous(memory_format=torch.channels_last), ctx)
        assert LM.layout_copies["count"] == 1
    # the GroupNorm statistics of the two layouts sum in different orders
    torch.testing.assert_close(y_cl, y_nchw, rtol=0, atol=1e-5)


def test_packed_weights_follow_the_weights():
    """``Linear.packed_weight`` and the q/k/v concatenation are cached and
    made again when any weight they come from changes."""
    from edtr_torch.models.attention import CrossAttention

    lin = Linear(32, 64)
    p1 = lin.packed_weight(torch.bfloat16)
    assert p1.shape == (64, 32) and p1.dtype == torch.bfloat16 and p1.is_contiguous()
    assert lin.packed_weight(torch.bfloat16) is p1
    with torch.no_grad():
        lin.weight.mul_(2.0)
    p2 = lin.packed_weight(torch.bfloat16)
    assert p2 is not p1
    torch.testing.assert_close(p2, lin.weight.detach().bfloat16(), rtol=0, atol=0)

    attn = CrossAttention(32, None, 2, 16)
    qkv = attn.qkv_weight(torch.bfloat16)
    assert qkv.shape == (96, 32) and attn.qkv_weight(torch.bfloat16) is qkv
    for i, lin in enumerate((attn.to_q, attn.to_k, attn.to_v)):
        with torch.no_grad():
            lin.weight.add_(1.0)
        new = attn.qkv_weight(torch.bfloat16)
        assert new is not qkv
        torch.testing.assert_close(new[32 * i:32 * (i + 1)], lin.weight.detach().bfloat16(),
                                   rtol=0, atol=0)
        qkv = new
    attn.to_v.load_state_dict({"weight": torch.zeros(32, 32)})
    assert not attn.qkv_weight(torch.bfloat16)[64:].any()


@pytest.mark.parametrize("shape", [(2, 64, 8, 8), (1, 128, 16, 24), (2, 320, 4, 4)])
def test_gn_stats_channels_last_matches_nchw_and_jax(shape):
    from edtr_tpu.ops.gn_conv import gn_stats as jax_gn_stats

    from edtr_torch.ops._norms import gn_stats

    x = (np.random.default_rng(35).standard_normal(shape) * 3 + 1).astype(np.float32)
    t = _t(x)
    cl = t.contiguous(memory_format=torch.channels_last)
    assert not cl.is_contiguous()
    _, mean_j, var_j = jax_gn_stats(jnp.asarray(x.transpose(0, 2, 3, 1)))
    for got, want_nchw, want_j in zip(gn_stats(cl), gn_stats(t), (mean_j, var_j)):
        np.testing.assert_allclose(t2n(got), t2n(want_nchw), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t2n(got), np.asarray(want_j), rtol=1e-5, atol=1e-6)
    # bf16 channels-last activations, as the fused configuration has them
    tb = t.bfloat16()
    for got, want in zip(gn_stats(tb.contiguous(memory_format=torch.channels_last)),
                         gn_stats(tb)):
        np.testing.assert_allclose(t2n(got), t2n(want), rtol=1e-5, atol=1e-6)


def test_profile_books_the_projection_kernels():
    from edtr_torch.profile_restore import _family

    # the wgmma kernel of K8a, K7b, K8b and K7a (PRO_NONE, 128-row blocks)
    for tmpl in ("64, 160, 0, 0", "64, 128, 0, 1", "32, 160, 1, 2", "128, 128, 2, 1",
                 "64, 64, 2, 1"):
        assert (_family(f"void edtr_lnproj::lnproj_kernel<{tmpl}>(CUtensorMap_st, "
                        "CUtensorMap_st, edtr_lnproj::Args)") == "proj (edtr_torch)")
    assert _family("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm (cuBLAS)"
    # cuBLAS's Hopper GEMMs, which the stock projections run
    assert _family("nvjet_tst_64x64_64x13_4x2_h_bz_TNT") == "gemm (cuBLAS)"


def test_conv_and_proj_configurations_restore_alike(monkeypatch):
    """All three configurations load the same state dict and, on the CPU,
    restore the same image (the same plain math; 64-token tiles, so the
    tiny transformers take the fused path): stock, conv (restored here) and
    conv+proj on ``stock_restore``'s inputs."""
    from edtr_torch.pipeline import build_flagship

    monkeypatch.setattr(LM, "SEQ_TILE", 64)
    monkeypatch.setattr(GG, "SEQ_TILE", 64)
    _, params = jax_tiny()
    pipe = build_flagship(tiny=True, dtype=None, device="cpu", fused_conv=True,
                          fused_proj=False)
    load_port(pipe, params)
    assert (pipe.fused_conv, pipe.fused_proj) == (True, False)
    args, stock = stock_restore()
    with torch.no_grad():
        conv = {k: t2n(v) for k, v in pipe.eval().restore(*args).items()}
    for out in (conv, _conv_proj_restore()[0]):
        for name in ("pre_restored", "z", "restored"):
            np.testing.assert_allclose(out[name], stock[name], rtol=0, atol=1e-5, err_msg=name)


# (N, C, O) of calls around the projection kernels' conditions: the
# flagship's three levels, JAX's token rule (N % 256), C % 32, C within a
# block's shared memory (<= 1600), O % 64 (the tiny flagship's 32-wide
# heads)
PROJ_CALLS = [(4096, 320, 320), (1024, 640, 640), (256, 1280, 1280), (64, 320, 320),
              (256, 48, 64), (256, 32, 32), (512, 1600, 64), (256, 1632, 64), (768, 96, 192)]


def _stub_launch(monkeypatch, mod):
    """A wrapper's launcher on meta tensors: its checks run as on the card,
    and the kernel's C entry point is a stub that returns 0."""
    import contextlib
    import types

    monkeypatch.setattr(mod, "_symbol", lambda *a: (lambda *args: 0))
    monkeypatch.setattr(mod, "on_device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["ln_matmuls", "affine_matmul"])
@pytest.mark.parametrize("n,c,o", PROJ_CALLS)
def test_launchers_raise_exactly_where_the_predicates_refuse(monkeypatch, n, c, o, name,
                                                             dtype):
    """``ln_matmuls_takes`` / ``affine_matmul_takes`` hold exactly where the
    launchers take a call (bf16, N % 256, C % 32 up to 1600, O % 64): the
    launcher, on meta tensors with a stub for the kernel, launches once
    where the predicate holds and raises ValueError where it does not."""
    _stub_launch(monkeypatch, LM)
    takes = getattr(LM, name + "_takes")(dtype, n, c, o)
    assert takes == (dtype == torch.bfloat16 and n % 256 == 0 and c % 32 == 0 and c <= 1600
                     and o % 64 == 0)

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, device="meta", dtype=dt)
    x, w, wp = meta(1, n, c, dt=dtype), meta(o, c), meta(o, c, dt=torch.bfloat16)
    if name == "ln_matmuls":
        def call():
            return LM.ln_matmuls(x, meta(c), meta(c), [w], w_packed=wp)
    else:
        def call():
            return LM.affine_matmul(x, meta(1, c), meta(1, c), w, meta(o), w_packed=wp)
    before = LM.launches[name]
    if takes:
        call()
        assert LM.launches[name] == before + 1
    else:
        with pytest.raises(ValueError):
            call()
        assert LM.launches[name] == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_proj_route_reads_the_predicates(dtype):
    """Off the CPU (a meta tensor here) a fused-projection call goes to its
    wrapper exactly where the kernel's predicate holds; on the CPU, where
    the wrappers are the plain versions, always."""
    from edtr_torch.models.attention import proj_route

    for n, c, o in PROJ_CALLS:
        for takes in (LM.ln_matmuls_takes, LM.affine_matmul_takes):
            x = torch.empty((1, n, c), device="meta", dtype=dtype)
            assert proj_route(x, takes, n, c, o) == takes(dtype, n, c, o)
            assert proj_route(torch.empty((1, n, c), dtype=dtype), takes, n, c, o)
        x = torch.empty((1, n, c), device="meta", dtype=dtype)
        assert proj_route(x, GG.geglu_takes, n, c, 4 * c) == GG.geglu_takes(dtype, n, c, 4 * c)


@pytest.mark.parametrize("refused", [False, True], ids=["kernels", "refused"])
def test_fused_proj_routes_send_refused_calls_to_the_plain_versions(monkeypatch, refused):
    """Inside ``fused_proj()`` at a token count JAX fuses, a call whose
    kernel refuses it (the predicates patched to refuse, the route as on
    the card) runs the wrapper's plain version in JAX's form: the same
    split-halves GEGLU, LN+q/k/v, LN+query and folded-affine calls, with
    the numbers of the wrapper path, and no wrapper is called."""
    from edtr_torch.models import attention
    from edtr_torch.models.attention import FeedForward, SpatialTransformer

    g = np.random.default_rng(34)
    st, ff = SpatialTransformer(32, 2, 16, context_dim=16), FeedForward(32)
    with torch.no_grad():
        for p in [*st.parameters(), *ff.parameters()]:
            p.copy_(_t(g.standard_normal(tuple(p.shape)).astype(np.float32) * 0.1))
    x = nchw(g.standard_normal((1, 16, 16, 32)).astype(np.float32))
    ctx = _t(g.standard_normal((1, 7, 16)).astype(np.float32))
    t = _t(_tokens(g, 1, 256, 32))
    with torch.no_grad(), fused_proj():
        want = st(x, ctx), ff(t)
    seen = []
    if refused:
        for mod, name in ((LM, "ln_matmuls"), (LM, "affine_matmul"), (GG, "geglu_proj"),
                          (GG, "ln_geglu_proj")):
            monkeypatch.setattr(mod, name, None)
            if hasattr(mod, name + "_takes"):
                monkeypatch.setattr(mod, name + "_takes",
                                    lambda *a, _n=name: seen.append(_n) and False)
        monkeypatch.setattr(GG, "geglu_takes", lambda *a: seen.append("geglu") and False)
        monkeypatch.setattr(attention, "proj_route",
                            lambda x, takes, *dims: takes(x.dtype, *dims))
    calls = _record_plain(monkeypatch)
    with torch.no_grad(), fused_proj():
        got = st(x, ctx), ff(t)
    assert calls == ["affine_matmul", "ln_matmuls_k3", "ln_matmuls_k1", "ln_geglu_proj",
                     "geglu_proj"]
    assert seen == (["affine_matmul", "ln_matmuls", "ln_matmuls", "geglu", "geglu"]
                    if refused else [])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
