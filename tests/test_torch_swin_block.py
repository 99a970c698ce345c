"""edtr_torch/ops/{window_attention,swin_block}.py and the fused-Swin
configuration against edtr_tpu, on the CPU with numpy-seeded inputs.

* Ops: the port's ``window_attention`` (its plain version on CPU tensors)
  against JAX's Pallas ``_win_fwd`` in interpret mode at (16, 64, 3, 30) with
  mask periods None, 4 and 16 (fp32 at 2e-5; bf16 within 2 bf16 ulps of
  max|out|); ``swin_pre`` / ``swin_post`` against JAX's with
  ``_FORCE_KERNEL`` (Pallas interpret) at SwinIR's odd widths scaled down
  (C 60 = 2 heads x 30, hidden 120, 16 x 16 tokens, window 8, B 2), roll
  d in {0, 4, -4}, fp32 at 2e-5 (bf16 within 2 ulps).
* Modules: one fused block (with and without an input roll) and one RSTB
  inside ``layers.fused_swin()`` against JAX's fused modules at 3e-3.
* The slice: the tiny SwinIR in the fused-Swin configuration against JAX's
  ``SwinIR(fused=True)`` with ``_FORCE_KERNEL`` (fp32 3e-3; bf16 within
  JAX's own 3e-2 between its fused and module paths); the switch through
  ``EDTRPipeline(fused_swin=)``, with the CPU wrappers on the plain
  versions; the device caches of the relative-position bias and the shift
  masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.models import swinir as JS
from edtr_tpu.ops import swin_block as JSB
from edtr_tpu.ops import window_attention as JWA

from edtr_torch.models.layers import Linear, fused_swin
from edtr_torch.models.swinir import (RSTB, SwinIR, SwinTransformerBlock, WindowAttention,
                                      shift_attention_mask, shift_mask)
from edtr_torch.ops import swin_block as SB
from edtr_torch.ops import window_attention as WA
from edtr_torch.pipeline import flagship_configs
from edtr_torch.utils.convert import from_jax
from torch_port_helpers import IMAGE, jax_tiny, nchw, nhwc, port_tiny, t2n

OP_TOL = dict(rtol=0, atol=2e-5)
MOD_TOL = dict(rtol=3e-3, atol=3e-3)
TINY = dict(dim=32, heads=2, win=4, hw=(IMAGE // 8, IMAGE // 8))  # tiny SwinIR blocks


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _close(got: torch.Tensor, want, dtype) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "bf16":
        assert got.dtype == torch.bfloat16
        tol = dict(rtol=0, atol=2 * bf16_ulp(np.abs(want).max()))
    else:
        tol = OP_TOL
    np.testing.assert_allclose(t2n(got), want, **tol)


def _cast(arrays, dtype):
    """numpy fp32 -> (JAX arrays, torch tensors) in the test's token dtype."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)
    return [jnp.asarray(a, jdt) for a in arrays], [_t(a).to(tdt) for a in arrays]


def _tokens(g, *shape):
    # a mean and a spread per row, as a residual stream has
    return (g.standard_normal(shape) * 2 + 0.5).astype(np.float32)


def _vec(g, n, scale=0.1, mean=0.0):
    return (mean + scale * g.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nw_mask", [None, 4, 16])
def test_window_attention_matches_jax_kernel(nw_mask, dtype):
    bw, n, h, d = 16, 64, 3, 30
    g = np.random.default_rng(40 + (nw_mask or 0))
    (q, k, v), (qt, kt, vt) = _cast([g.standard_normal((bw, n, h, d)) for _ in range(3)], dtype)
    bias = (0.1 * g.standard_normal((h, n, n))).astype(np.float32)
    mask = (None if nw_mask is None else
            np.where(g.random((nw_mask, n, n)) > 0.7, -100.0, 0.0).astype(np.float32))
    with jax.default_matmul_precision("float32"):
        want = JWA._win_fwd(q, k, v, jnp.asarray(bias),
                            None if mask is None else jnp.asarray(mask), d ** -0.5)
    got = WA.window_attention(qt, kt, vt, _t(bias), None if mask is None else _t(mask))
    assert got.shape == (bw, n, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_window_attention_matches_jax_kernel_on_packed_slices(dtype):
    """As above, on q/k/v that are the three strided slices of one packed
    (BW, N, 3C) tensor, as swin_pre writes them (the layout the card kernel
    brings in by one bulk copy a window, ``packed_layout``), with a mask
    period of 4 over 8 windows."""
    bw, n, h, d, nw = 8, 64, 3, 30, 4
    g = np.random.default_rng(46)
    packed = g.standard_normal((bw, n, 3, h, d)).astype(np.float32)
    (pj,), (pt,) = _cast([packed], dtype)
    qt, kt, vt = pt.view(bw, n, 3 * h * d).view(bw, n, 3, h, d).unbind(2)
    assert WA.packed_layout(qt, kt, vt) and not qt.is_contiguous()
    bias = (0.1 * g.standard_normal((h, n, n))).astype(np.float32)
    mask = (g.standard_normal((nw, n, n)) * 2).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = JWA._win_fwd(pj[:, :, 0], pj[:, :, 1], pj[:, :, 2], jnp.asarray(bias),
                            jnp.asarray(mask), d ** -0.5)
    got = WA.window_attention(qt, kt, vt, _t(bias), _t(mask))
    assert got.shape == (bw, n, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("bw,heads,split", [(64, 6, 2), (128, 6, 1), (66, 6, 2), (67, 6, 1),
                                            (64, 1, 1), (8, 2, 2)])
def test_window_split_fills_the_card(bw, heads, split):
    """K9 gives a window to two blocks of half its heads where two blocks a
    window still fit an H100's 132 SMs one block an SM (the restore's 64
    windows), else one block (the step's 128)."""
    assert WA.window_split(bw, heads) == split


@pytest.mark.parametrize("n,d,heads,takes", [(64, 30, 6, True), (64, 6, 53, True),
                                             (64, 32, 10, False), (64, 32, 11, False),
                                             (64, 16, 19, True), (64, 31, 6, False),
                                             (16, 16, 2, False), (64, 36, 5, False),
                                             (64, 2, 1, True)])
def test_window_attention_kernel_takes(n, d, heads, takes):
    """The window kernel takes bf16 windows of 64 tokens with an even head
    dim up to 32 and C = heads * d up to 318, the widest C whose block (the
    window's packed rows, its output rows, three warpgroups' K/V tiles, the
    mask rows) fits the shared memory the launcher allows; fp32 never."""
    assert WA.MAX_C == 318
    assert WA.smem_bytes(WA.MAX_C) <= WA.SMEM_LIMIT < WA.smem_bytes(WA.MAX_C + 2)
    assert WA.kernel_takes(torch.bfloat16, n, d, heads) == takes
    assert not WA.kernel_takes(torch.float32, n, d, heads)


@pytest.mark.parametrize("layout", ["packed", "contiguous", "heads_first"])
@pytest.mark.parametrize("bw", [64, 128])
def test_window_attention_launch_reads_the_layout(monkeypatch, layout, bw):
    """On meta tensors with a stub for the kernel, the wrapper hands the
    kernel the packed rows (one bulk copy a window), the shape and
    ``window_split``'s blocks a window; q/k/v in any other layout it
    refuses, launching nothing."""
    import contextlib
    import types

    seen = []
    monkeypatch.setattr(WA, "_symbol", lambda: (lambda *a: seen.append(a) or 0))
    monkeypatch.setattr(WA, "on_device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    h, d = 6, 30
    packed = torch.empty((bw, 64, 3 * h * d), device="meta", dtype=torch.bfloat16)
    q, k, v = packed.view(bw, 64, 3, h, d).unbind(2)
    if layout == "contiguous":
        q, k, v = (torch.empty((bw, 64, h, d), device="meta", dtype=torch.bfloat16)
                   for _ in range(3))
    elif layout == "heads_first":
        q, k, v = (torch.empty((bw, h, 64, d), device="meta",
                               dtype=torch.bfloat16).transpose(1, 2) for _ in range(3))
    mask = torch.empty((64, 64, 64), device="meta")
    bias = torch.empty((h, 64, 64), device="meta")
    if layout != "packed":
        assert not WA.packed_layout(q, k, v)
        with pytest.raises(ValueError, match="packed"):
            WA.window_attention(q, k, v, bias, mask)
        assert not seen
        return
    out = WA.window_attention(q, k, v, bias, mask)
    assert out.shape == (bw, 64, h, d) and out.is_contiguous()
    (args,) = seen
    assert args[0] == q.data_ptr() and args[4:8] == (bw, h, d, 64)
    assert args[9] == WA.window_split(bw, h)


def _pre_args(g, b, h, w, c):
    return (_tokens(g, b, h * w, c), _vec(g, c, mean=1.0), _vec(g, c),
            (g.standard_normal((c, 3 * c)) * c ** -0.5).astype(np.float32), _vec(g, 3 * c))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [0, 4, -4])
def test_swin_pre_matches_jax_kernel(monkeypatch, d, dtype):
    b, h, w, win, c = 2, 16, 16, 8, 60
    x, s, sh, wqkv, bqkv = _pre_args(np.random.default_rng(41), b, h, w, c)
    (xj,), (xt,) = _cast([x], dtype)
    jargs = [jnp.asarray(a) for a in (s, sh, wqkv, bqkv)]
    monkeypatch.setattr(JSB, "_FORCE_KERNEL", True)
    with jax.default_matmul_precision("float32"):
        want = JSB.swin_pre(xj, *jargs, h, w, win, d)
    got = SB.swin_pre(xt, _t(s), _t(sh), _t(wqkv.T), _t(bqkv), h, w, win, d)
    assert got[0].shape == (b, 4, win * win, 3 * c) and got[1].shape == (b, h * w, c)
    for gt, wt in zip(got, want):
        _close(gt, wt, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_swin_post_matches_jax_kernel(monkeypatch, dtype):
    b, h, w, win, c, hidden = 2, 16, 16, 8, 60, 120
    g = np.random.default_rng(42)
    attn, xr = g.standard_normal((b, 4, win * win, c)), _tokens(g, b, h * w, c)
    ws = [(g.standard_normal((c, c)) * c ** -0.5).astype(np.float32), _vec(g, c),
          _vec(g, c, mean=1.0), _vec(g, c),
          (g.standard_normal((c, hidden)) * c ** -0.5).astype(np.float32), _vec(g, hidden),
          (g.standard_normal((hidden, c)) * hidden ** -0.5).astype(np.float32), _vec(g, c)]
    (aj, xj), (at, xt) = _cast([attn, xr], dtype)
    monkeypatch.setattr(JSB, "_FORCE_KERNEL", True)
    with jax.default_matmul_precision("float32"):
        want = JSB.swin_post(aj, xj, *[jnp.asarray(a) for a in ws], h, w, win)
    tw = [_t(a.T) if a.ndim == 2 else _t(a) for a in ws]  # nn.Linear layout
    got = SB.swin_post(at, xt, *tw, h, w, win)
    assert got.shape == (b, h * w, c)
    _close(got, want, dtype)


@pytest.mark.parametrize("d", [0, 4, -4, 13])
def test_roll2d_matches_jax(d):
    from edtr_tpu.ops.swin_block import _roll2d

    h, w = 16, 24
    x = np.random.default_rng(43).standard_normal((h * w, 5)).astype(np.float32)
    got = SB.roll2d(_t(x)[None], d, h, w)[0]
    np.testing.assert_array_equal(t2n(got), np.asarray(_roll2d(jnp.asarray(x), d, h, w)))


def test_supported_is_jax_rule_without_vmem():
    for h, w, win in ((64, 64, 8), (16, 24, 8), (8, 8, 4), (12, 16, 8), (4, 8, 8), (8, 8, 8)):
        assert SB.supported(h, w, win) == JSB.supported(h, w, win), (h, w, win)


def _jax_block(j):
    dim, heads, win = TINY["dim"], TINY["heads"], TINY["win"]
    return JS.SwinTransformerBlock(dim=dim, num_heads=heads, win=win,
                                   shift=0 if j % 2 == 0 else win // 2, mlp_ratio=2.0,
                                   fused=True)


@pytest.mark.parametrize("j,in_offset", [(0, 0), (1, 0), (0, 2)])
def test_fused_block_matches_jax(monkeypatch, j, in_offset):
    _, params = jax_tiny()
    src = port_tiny().swinir.layers[0].residual_group.blocks[j]
    blk = SwinTransformerBlock(TINY["dim"], TINY["heads"], TINY["win"], src.shift, 2.0)
    blk.load_state_dict(src.state_dict(), strict=True)
    h, w = TINY["hw"]
    x = _tokens(np.random.default_rng(44 + j), 2, h * w, TINY["dim"])
    monkeypatch.setattr(JSB, "_FORCE_KERNEL", True)
    with jax.default_matmul_precision("float32"):
        want = _jax_block(j).apply({"params": params["swinir"]["layers_0"][f"blocks_{j}"]},
                                   jnp.asarray(x), (h, w), in_offset=in_offset)
    with torch.no_grad(), fused_swin():
        got = blk(_t(x), (h, w), in_offset)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **MOD_TOL)


def test_fused_rstb_matches_jax(monkeypatch):
    _, params = jax_tiny()
    dim, heads, win = TINY["dim"], TINY["heads"], TINY["win"]
    rstb = RSTB(dim, 2, heads, win, 2.0)
    rstb.load_state_dict(port_tiny().swinir.layers[0].state_dict(), strict=True)
    h, w = TINY["hw"]
    x = _tokens(np.random.default_rng(45), 2, h * w, dim)
    monkeypatch.setattr(JSB, "_FORCE_KERNEL", True)
    with jax.default_matmul_precision("float32"):
        want = JS.RSTB(dim=dim, depth=2, num_heads=heads, win=win, mlp_ratio=2.0,
                       fused=True).apply({"params": params["swinir"]["layers_0"]},
                                         jnp.asarray(x), (h, w))
    with torch.no_grad():
        stock = rstb(_t(x), (h, w))
        with fused_swin():
            got = rstb(_t(x), (h, w))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **MOD_TOL)
    # the last block's roll is undone before the conv: the same image as stock
    np.testing.assert_allclose(t2n(got), t2n(stock), rtol=0, atol=1e-5)


def _record_plain(monkeypatch):
    """Records the calls that reach the three wrappers' plain versions (on
    CPU tensors: the fused path; the stock path runs stock modules)."""
    calls = []
    for mod, name in ((SB, "plain_swin_pre"), (WA, "plain_window_attention"),
                      (SB, "plain_swin_post")):
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, **kwargs):
            calls.append(_name[len("plain_"):])
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, rec)
    return calls


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tiny_swinir_fused_swin_matches_jax(monkeypatch, dtype):
    """The slice as a whole: JAX's tiny SwinIR with its swin_pre/swin_post
    Pallas kernels (interpret mode) against the port's in the fused-Swin
    configuration, on the same weights; each of the port's three wrappers
    is reached once per block."""
    import jax.experimental.pallas as pl

    _, params = jax_tiny()
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    lq = np.random.default_rng(46).random((1, IMAGE, IMAGE, 3)).astype(np.float32)
    monkeypatch.setattr(JSB, "_FORCE_KERNEL", True)
    kernels = set()
    pallas_call = pl.pallas_call

    def rec_pallas(kernel, *args, **kwargs):
        fn = getattr(kernel, "func", kernel)
        kernels.add(f"{fn.__module__}.{fn.__name__}")
        return pallas_call(kernel, *args, **kwargs)
    monkeypatch.setattr(pl, "pallas_call", rec_pallas)
    net_j = JS.SwinIR(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4, mlp_ratio=2,
                      sf=8, upsampler="nearest+conv", unshuffle=True, unshuffle_scale=8,
                      dtype=jdt, fused=True)
    with jax.default_matmul_precision("float32"):
        want = net_j.apply({"params": params["swinir"]}, jnp.asarray(lq))
    assert {"edtr_tpu.ops.swin_block._pre_kernel",
            "edtr_tpu.ops.swin_block._post_kernel"} <= kernels, kernels

    net = SwinIR(dtype=tdt, **flagship_configs(tiny=True)["swinir"])
    net.load_state_dict(from_jax(params["swinir"], "swinir"), strict=True)
    calls = _record_plain(monkeypatch)
    with torch.no_grad(), fused_swin():
        got = net(nchw(lq))
    assert calls == ["swin_pre", "window_attention", "swin_post"] * 2
    tol = 3e-2 if dtype == "bf16" else 3e-3
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_runs_swinir_in_its_swin_configuration(monkeypatch, fused):
    """``EDTRPipeline(fused_swin=)`` sets the configuration around the
    pre-restoration stage and only there; on the CPU both configurations
    restore the same image (the same math in fp32)."""
    from edtr_torch.models import layers
    from edtr_torch.pipeline import EDTRPipeline

    base = port_tiny()
    pipe = EDTRPipeline(base.swinir, base.cldm, base.diffusion, device="cpu",
                        fused_swin=fused)
    assert pipe.fused_swin is fused
    lq = nchw(np.random.default_rng(47).random((1, IMAGE, IMAGE, 3)).astype(np.float32))
    with torch.no_grad():
        stock = base.swinir(lq)  # a module called outside any block: stock
    calls = _record_plain(monkeypatch)
    out = pipe.pre_restore(lq)
    assert calls == (["swin_pre", "window_attention", "swin_post"] * 2 if fused else [])
    assert not layers.fused_swin_on()
    np.testing.assert_allclose(t2n(out), t2n(stock), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):  # rolled tokens reach a block outside the configuration
        base.swinir.layers[0].residual_group.blocks[0](torch.zeros(1, 64, 32), (8, 8), 2)


def test_bias_and_masks_are_made_once_on_the_device():
    attn = WindowAttention(32, 4, 2)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_()
        b1 = attn.bias()
        assert b1.shape == (2, 16, 16) and b1.dtype == torch.float32 and b1.is_contiguous()
        assert attn.bias() is b1
        want = JS._rel_pos_bias(jnp.asarray(t2n(attn.relative_position_bias_table)), 4)
        np.testing.assert_array_equal(t2n(b1), np.asarray(want))
        attn.relative_position_bias_table.add_(1.0)
        b2 = attn.bias()
        assert b2 is not b1
        torch.testing.assert_close(b2, b1 + 1.0)
    # a call that differentiates the table gets a bias with its graph
    attn.bias().sum().backward()
    assert attn.relative_position_bias_table.grad is not None
    m = shift_mask(8, 8, 4, 2, torch.device("cpu"))
    assert shift_mask(8, 8, 4, 2, torch.device("cpu")) is m
    np.testing.assert_array_equal(t2n(m), JS.shift_attention_mask(8, 8, 4, 2))
    np.testing.assert_array_equal(t2n(m), shift_attention_mask(8, 8, 4, 2))



@pytest.mark.parametrize("c", [60, 180, 192])
def test_padded_qkv_pack(c):
    """``Linear.padded_weight``, the qkv weight ``swin_pre``'s kernel reads:
    ``packed_weight`` in its first C columns, zeros after them up to a
    multiple of 64 (rows of a multiple of 128 bytes, which TMA can read)."""
    lin = Linear(c, 3 * c)
    wp = lin.padded_weight(torch.bfloat16)
    assert wp.shape == (3 * c, -(-c // 64) * 64) and wp.dtype == torch.bfloat16
    assert wp.is_contiguous()
    assert torch.equal(wp[:, :c], lin.packed_weight(torch.bfloat16))
    assert not wp[:, c:].any()
    assert torch.equal(SB.pad_weight(lin.weight.detach()), wp)


def test_padded_qkv_pack_is_made_once_and_again_after_a_weight_change():
    lin = Linear(180, 540)
    wp = lin.padded_weight(torch.bfloat16)
    assert lin.padded_weight(torch.bfloat16) is wp
    with torch.no_grad():
        lin.weight.mul_(2.0)
    wp2 = lin.padded_weight(torch.bfloat16)
    assert wp2 is not wp
    assert torch.equal(wp2[:, :180], lin.weight.detach().to(torch.bfloat16))
    assert not wp2[:, 180:].any()


def test_fused_block_passes_the_padded_pack(monkeypatch):
    """The fused block hands ``swin_pre`` its qkv weight's padded pack."""
    blk = SwinTransformerBlock(60, 2, 8, 0)
    seen = {}
    real = SB.swin_pre

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)
    monkeypatch.setattr(SB, "swin_pre", spy)
    x = torch.randn(1, 16 * 16, 60)
    with fused_swin():
        blk(x, (16, 16))
    assert seen["w_packed"] is blk.attn.qkv.padded_weight(torch.float32)
    assert seen["w_packed"].shape == (180, 64)


@pytest.mark.parametrize("c", [60, 180, 192])
def test_padded_post_packs(c):
    """``Linear.padded_weight`` of proj (C -> C), fc1 (C -> 2C) and fc2
    (2C -> C), the weights ``swin_post``'s kernel reads: ``packed_weight``
    in the first ``in`` columns, zeros after them up to a multiple of 64."""
    for lin in (Linear(c, c), Linear(c, 2 * c), Linear(2 * c, c)):
        out, cin = lin.weight.shape
        wp = lin.padded_weight(torch.bfloat16)
        assert wp.shape == (out, -(-cin // 64) * 64) and wp.dtype == torch.bfloat16
        assert wp.is_contiguous()
        assert torch.equal(wp[:, :cin], lin.packed_weight(torch.bfloat16))
        assert not wp[:, cin:].any()
        assert lin.padded_weight(torch.bfloat16) is wp
        assert torch.equal(SB.pad_weight(lin.weight.detach()), wp)


def test_fused_block_passes_the_padded_post_packs(monkeypatch):
    """The fused block hands ``swin_post`` the padded packs of proj, fc1 and
    fc2."""
    blk = SwinTransformerBlock(60, 2, 8, 4)
    seen = {}
    real = SB.swin_post

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)
    monkeypatch.setattr(SB, "swin_post", spy)
    x = torch.randn(1, 16 * 16, 60)
    with fused_swin():
        blk(x, (16, 16))
    lins = (blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2)
    assert all(p is lin.padded_weight(torch.float32) for p, lin in zip(seen["packed"], lins))
    assert [tuple(p.shape) for p in seen["packed"]] == [(60, 64), (120, 64), (60, 128)]


# (B, h, w, C, window, heads, hidden) of the flagship's SwinIR blocks (C 180
# = 6 x 30, window 8, hidden 360), of the tiny flagship's (C 32 = 2 x 16,
# window 4) and of widths the kernels take at their edges
SWIN_ROUTES = [((1, 64, 64, 180, 8, 6, 360), True), ((2, 64, 64, 180, 8, 6, 360), True),
               ((1, 8, 8, 32, 4, 2, 64), False), ((1, 16, 16, 60, 8, 2, 120), True),
               ((1, 16, 16, 192, 8, 6, 384), True), ((1, 16, 16, 180, 8, 5, 360), False),
               ((1, 16, 16, 200, 8, 10, 400), False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dims,takes", SWIN_ROUTES)
def test_swin_kernel_route_follows_the_predicates(dims, takes, dtype):
    """Off the CPU (a meta tensor here), a fused Swin block goes to the three
    kernel wrappers exactly where ``swin_pre_takes``, ``swin_post_takes``
    and the window attention's ``kernel_takes`` all hold: bf16, window 8,
    C <= 192 (a multiple of 4) with an even head dim up to 32, hidden <=
    384; else to their plain versions. On the CPU the wrappers, the plain
    versions there, take every block."""
    from edtr_torch.models.swinir import swin_kernel_route

    b, h, w, c, win, heads, hidden = dims
    x = torch.empty((b, h * w, c), device="meta", dtype=dtype)
    want = takes and dtype == torch.bfloat16
    assert swin_kernel_route(x, h, w, win, hidden, heads) == want
    assert SB.swin_post_takes(dtype, h, w, win, c, hidden) == (
        dtype == torch.bfloat16 and win == 8 and c <= 192 and c % 4 == 0 and hidden <= 384
        and hidden % 4 == 0)
    assert swin_kernel_route(torch.empty((b, h * w, c), dtype=dtype), h, w, win, hidden, heads)


@pytest.mark.parametrize("b,h,hidden,split", [(1, 64, 360, 2), (2, 64, 360, 1),
                                              (1, 64, 120, 1), (1, 24, 384, 2),
                                              (4, 32, 360, 2), (4, 48, 360, 1)])
def test_post_split_fills_the_card(b, h, hidden, split):
    """``swin_post`` gives a window to a two-block cluster where the hidden
    has two 192-column slabs and two blocks a window fit an H100's 132 SMs
    one block an SM (the restore's 64 windows), else one block (the step's
    128)."""
    assert SB.post_split(b, h, h, 8, hidden) == split


def test_a_block_routed_to_the_plain_versions_matches_the_wrappers(monkeypatch):
    """A fused block whose route says plain (as an fp32 or window-4 block on
    the card) runs the plain versions of the three kernels in the same
    rolled space: the wrappers' numbers on the CPU, where they are the
    plain versions, and no wrapper is called."""
    from edtr_torch.models import swinir

    blk = SwinTransformerBlock(60, 2, 8, 4)
    x = torch.from_numpy(_tokens(np.random.default_rng(45), 1, 16 * 16, 60))
    with torch.no_grad(), fused_swin():
        want = blk(x, (16, 16), 2)
        for name in ("swin_pre", "swin_post"):
            monkeypatch.setattr(SB, name, None)
        monkeypatch.setattr(swinir, "window_attention", None)
        monkeypatch.setattr(swinir, "swin_kernel_route", lambda *a: False)
        got = blk(x, (16, 16), 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
