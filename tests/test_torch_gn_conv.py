"""edtr_torch/ops/gn_conv.py and the fused-conv configuration against
edtr_tpu/ops/gn_conv.py, on the CPU in fp32 with numpy-seeded inputs.

* Ops: the port's ``gn_silu_conv`` / ``upsample_conv`` (their plain
  versions on CPU tensors) against JAX's reference math (``_ref``,
  ``_ups_ref``, ``_ups_subpixel``) and its Pallas kernels in interpret mode
  (``_FORCE_KERNEL``; the whole-image tier with the band budget zeroed, the
  band tier with the whole-image budget zeroed), at JAX's own tolerance
  2e-5. JAX runs at float32 matmul precision: this platform's default CPU
  conv is reduced-precision (tests/test_gn_conv_fused.py).
* Modules: a VAE ResnetBlock and a UNet ResBlock run inside
  ``layers.fused_conv()`` against the JAX blocks with ``fused=True`` and
  the kernels forced, at 3e-3 (tests/test_torch_modules.py); the switch
  routes every conv of a block and of a pipeline stage, and only there.
* The slice: the tiny restore with ``fused_conv=True`` against the JAX
  tiny restore with ``_FORCE_KERNEL`` and ``EDTR_UPS_SUBPIX=0``, at the
  tolerances of tests/test_torch_pipeline.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.ops import gn_conv as JG

from edtr_torch.models.layers import Conv2d, fused_conv
from edtr_torch.ops import gn_conv as G
from proj_bench import GN_SHAPES
from torch_port_helpers import CTX, IMAGE, jax_tiny, load_port, nchw, nhwc, port_tiny, t2n

OP_TOL = dict(rtol=0, atol=2e-5)
MOD_TOL = dict(rtol=3e-3, atol=3e-3)


def _args(b=2, h=16, w=8, cin=64, cout=128, emb=True, res=True, seed=0):
    """JAX's test inputs (tests/test_gn_conv_fused.py:_args), as numpy."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    x = g.standard_normal((b, h, w, cin)).astype(f32)
    mul = (g.standard_normal((b, cin)) * 0.5 + 1.0).astype(f32)
    add = (g.standard_normal((b, cin)) * 0.1).astype(f32)
    wk = (g.standard_normal((3, 3, cin, cout)) * 0.05).astype(f32)
    bk = (g.standard_normal(cout) * 0.1).astype(f32)
    e = (g.standard_normal((b, cout)) * 0.2).astype(f32) if emb else None
    r = g.standard_normal((b, h, w, cout)).astype(f32) if res else None
    return x, mul, add, wk, bk, e, r


def _oihw(wk):  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))


def _port_gn(x, mul, add, wk, bk, e, r):
    out = G.gn_silu_conv(nchw(x), torch.from_numpy(mul), torch.from_numpy(add), _oihw(wk),
                         torch.from_numpy(bk), None if e is None else torch.from_numpy(e),
                         None if r is None else nchw(r))
    return nhwc(out)


def _jax_pair(fn, args, monkeypatch, **budgets):
    """(reference, Pallas kernel in interpret mode) of a JAX gn_conv op."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(fn(*jargs, force=False))
        for name, value in budgets.items():
            monkeypatch.setattr(JG, name, value)
        monkeypatch.setattr(JG, "_FORCE_KERNEL", True)
        kern = np.asarray(fn(*jargs, force=True))
    return ref, kern


def _jax_gn(*args, force):
    return (JG.gn_silu_conv if force else JG._ref)(*args)


@pytest.mark.parametrize("tier", ["whole", "band"])
@pytest.mark.parametrize("emb,res", [(True, True), (True, False), (False, True),
                                     (False, False)])
def test_gn_silu_conv_matches_jax(monkeypatch, tier, emb, res):
    # the band tier's halo rows are the risk: h spans 4 row blocks there
    h = 16 if tier == "whole" else 32
    args = _args(h=h, emb=emb, res=res, seed=6)
    budgets = {"_BAND_BUDGET": 100} if tier == "whole" else {"_BUDGET": 100}
    plan = (JG._plan if tier == "whole" else JG._band_plan)(h, 8, 64, 128, res, es=4)
    assert plan is not None
    ref, kern = _jax_pair(_jax_gn, args, monkeypatch, **budgets)
    got = _port_gn(*args)
    np.testing.assert_allclose(got, ref, **OP_TOL)
    np.testing.assert_allclose(got, kern, **OP_TOL)


def test_gn_silu_conv_nonsquare(monkeypatch):
    args = _args(h=8, w=24, cin=32, cout=64, seed=2)
    ref, kern = _jax_pair(_jax_gn, args, monkeypatch)
    got = _port_gn(*args)
    np.testing.assert_allclose(got, ref, **OP_TOL)
    np.testing.assert_allclose(got, kern, **OP_TOL)


@pytest.mark.parametrize("act", [None, "lrelu"])
def test_upsample_conv_matches_jax(monkeypatch, act):
    g = np.random.default_rng(11)
    x = g.standard_normal((2, 16, 8, 32)).astype(np.float32)
    wk = (g.standard_normal((3, 3, 32, 64)) * 0.05).astype(np.float32)
    bk = (g.standard_normal(64) * 0.1).astype(np.float32)
    assert JG._ups_plan(32, 16, 32, 64, es=4, strict_lanes=False) is not None
    monkeypatch.setenv("EDTR_UPS_SUBPIX", "0")

    def ups(x, w, b, force):
        return JG.upsample_conv(x, w, b, act) if force else JG._ups_ref(x, w, b, act)
    ref, kern = _jax_pair(ups, (x, wk, bk), monkeypatch)
    with jax.default_matmul_precision("float32"):
        sub = np.asarray(JG._ups_subpixel(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bk),
                                          act))
    got = nhwc(G.upsample_conv(nchw(x), _oihw(wk), torch.from_numpy(bk), act))
    assert got.shape == (2, 32, 16, 64)
    for other in (ref, kern, sub):
        np.testing.assert_allclose(got, other, **OP_TOL)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers compute the plain versions and launch
    nothing; the tier follows ``_call``'s rule (h >= 16: row bands)."""
    assert (G.tier(8), G.tier(15), G.tier(16)) == ("gn_conv_whole", "gn_conv_whole",
                                                   "gn_conv_band")
    x, mul, add, wk, bk, e, r = (None if a is None else torch.from_numpy(a)
                                 for a in _args(seed=3))
    x, r = x.permute(0, 3, 1, 2), r.permute(0, 3, 1, 2)
    before = dict(G.launches)
    torch.testing.assert_close(G.gn_silu_conv(x, mul, add, _oihw(wk.numpy()), bk, e, r),
                               G.plain_gn_silu_conv(x, mul, add, _oihw(wk.numpy()), bk, e, r),
                               rtol=0, atol=0)
    torch.testing.assert_close(G.upsample_conv(x, _oihw(wk.numpy()), bk, "lrelu"),
                               G.plain_upsample_conv(x, _oihw(wk.numpy()), bk, "lrelu"),
                               rtol=0, atol=0)
    assert G.launches == before


@pytest.mark.parametrize("h", [8, 16])  # JAX's whole-image and band tiers
def test_unet_resblock_fused_matches_jax(monkeypatch, h):
    from edtr_tpu.models.unet import ResBlock as JResBlock

    from edtr_torch.models.unet import ResBlock

    _, params = jax_tiny()
    src = port_tiny().cldm.unet.input_blocks[3][0]  # 32 -> 64 ch, 1x1 skip
    blk = ResBlock(32, 128, 64)
    blk.load_state_dict(src.state_dict(), strict=True)
    g = np.random.default_rng(12)
    x = g.standard_normal((2, h, 8, 32)).astype(np.float32)
    emb = g.standard_normal((2, 128)).astype(np.float32)
    monkeypatch.setattr(JG, "_FORCE_KERNEL", True)
    with jax.default_matmul_precision("float32"):
        y_j = JResBlock(out_channels=64, fused=True).apply(
            {"params": params["unet"]["input_blocks_3_0"]}, jnp.asarray(x), jnp.asarray(emb))
    with torch.no_grad(), fused_conv():
        y_t = blk(nchw(x), torch.from_numpy(emb))
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), **MOD_TOL)


@pytest.mark.parametrize("h", [8, 16])
def test_vae_resnetblock_fused_matches_jax(monkeypatch, h):
    from edtr_tpu.models.vae import ResnetBlock as JResnetBlock

    from edtr_torch.models.vae import ResnetBlock

    _, params = jax_tiny()
    src = port_tiny().cldm.vae.encoder.down[1].block[0]  # 32 -> 64 ch, nin_shortcut
    blk = ResnetBlock(32, 64)
    blk.load_state_dict(src.state_dict(), strict=True)
    x = np.random.default_rng(13).standard_normal((2, h, 8, 32)).astype(np.float32)
    monkeypatch.setattr(JG, "_FORCE_KERNEL", True)
    with jax.default_matmul_precision("float32"):
        y_j = JResnetBlock(out_channels=64, fused=True).apply(
            {"params": params["vae"]["encoder"]["down_1_block_0"]}, jnp.asarray(x))
    with torch.no_grad(), fused_conv():
        y_t = blk(nchw(x))
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), **MOD_TOL)


def test_tiny_restore_fused_matches_jax(monkeypatch):
    """The slice as a whole: JAX with every gn_conv call on its Pallas
    kernels (interpret mode) and the nearest-2x upsample form, the port in
    the fused-conv configuration; every ResBlock half and upsample of the
    port keeps channels-last activations (no layout copy on the card)."""
    from edtr_torch.pipeline import build_flagship
    from test_torch_pipeline import _replay_noise

    pipe, params = jax_tiny()
    port = build_flagship(tiny=True, dtype=None, device="cpu", fused_conv=True)
    load_port(port, params)
    port.eval()
    g = np.random.default_rng(21)
    lq = g.random((1, IMAGE, IMAGE, 3)).astype(np.float32)
    c_txt = g.standard_normal((1,) + CTX).astype(np.float32)
    rng = jax.random.PRNGKey(231)
    monkeypatch.setenv("EDTR_UPS_SUBPIX", "0")
    monkeypatch.setattr(JG, "_FORCE_KERNEL", True)
    out_j = jax.jit(lambda p, x, r, c: pipe.restore(p, x, r, c_txt=c))(
        params, jnp.asarray(lq), rng, jnp.asarray(c_txt))

    calls = []
    plain_gn, plain_up = G.plain_gn_silu_conv, G.plain_upsample_conv

    def rec_gn(x, mul, add, w, b, emb=None, res=None):
        calls.append((G.tier(x.shape[2]), x, res))
        return plain_gn(x, mul, add, w, b, emb, res)

    def rec_up(x, w, b, act=None):
        calls.append(("upsample_conv", x, None))
        return plain_up(x, w, b, act)
    monkeypatch.setattr(G, "plain_gn_silu_conv", rec_gn)
    monkeypatch.setattr(G, "plain_upsample_conv", rec_up)
    hw = IMAGE // 8
    noise, step_noise = _replay_noise(rng, (1, hw, hw, 4), len(pipe.used_timesteps))
    out_t = port.restore(torch.from_numpy(lq), torch.from_numpy(c_txt),
                         noise=torch.from_numpy(noise), step_noise=torch.from_numpy(step_noise))

    for name, tol in (("pre_restored", 2e-3), ("z", 5e-3), ("restored", 1e-2)):
        a, b = t2n(out_t[name]), np.asarray(out_j[name])
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
    # the tiny restore at 64²: latents 8² (whole-image tier), VAE 8²-64²,
    # SwinIR tail 16²-64²; every call on channels-last memory
    tiers = {t for t, _, _ in calls}
    assert tiers == {"gn_conv_whole", "gn_conv_band", "upsample_conv"}, tiers
    for t, x, res in calls:
        assert x.is_contiguous(memory_format=torch.channels_last), (t, tuple(x.shape))
        assert res is None or res.is_contiguous(memory_format=torch.channels_last), t


def test_tiny_restore_stock_matches_fused():
    """Both conv configurations load the same state dict and, on the CPU
    (the same plain math, NCHW against channels-last memory), restore the
    same image."""
    from edtr_torch.pipeline import build_flagship

    _, params = jax_tiny()
    g = np.random.default_rng(22)
    args = (torch.from_numpy(g.random((1, IMAGE, IMAGE, 3)).astype(np.float32)),
            torch.from_numpy(g.standard_normal((1,) + CTX).astype(np.float32)),
            torch.from_numpy(g.standard_normal((1, IMAGE // 8, IMAGE // 8, 4))
                             .astype(np.float32)),
            torch.from_numpy(g.standard_normal((4, 1, IMAGE // 8, IMAGE // 8, 4))
                             .astype(np.float32)))
    outs = []
    for fused in (False, True):
        pipe = build_flagship(tiny=True, dtype=None, device="cpu", fused_conv=fused)
        load_port(pipe, params)
        assert pipe.fused_conv is fused
        outs.append(pipe.eval().restore(*args))
    for name in ("pre_restored", "z", "restored"):
        np.testing.assert_allclose(t2n(outs[1][name]), t2n(outs[0][name]), rtol=0, atol=1e-5,
                                   err_msg=name)


def _record_wrappers(monkeypatch):
    """Counts the calls that reach the kernel wrappers (the fused path);
    the stock path calls the plain versions directly."""
    calls = []
    gn, up = G.gn_silu_conv, G.upsample_conv

    def rec_gn(x, *args, **kwargs):
        calls.append(("gn", x.is_contiguous(memory_format=torch.channels_last)))
        return gn(x, *args, **kwargs)

    def rec_up(x, *args, **kwargs):
        calls.append(("up", x.is_contiguous(memory_format=torch.channels_last)))
        return up(x, *args, **kwargs)
    monkeypatch.setattr(G, "gn_silu_conv", rec_gn)
    monkeypatch.setattr(G, "upsample_conv", rec_up)
    return calls


def test_fused_conv_switch_routes_a_block(monkeypatch):
    """Inside ``fused_conv()`` both halves of a ResBlock reach the kernel
    wrapper; outside any block, or in a nested ``fused_conv(False)``, none
    does, and leaving a block restores the configuration around it."""
    from edtr_torch.models import layers
    from edtr_torch.models.unet import ResBlock

    calls = _record_wrappers(monkeypatch)
    blk = ResBlock(32, 128, 64)
    g = np.random.default_rng(14)
    x = torch.from_numpy(g.standard_normal((1, 32, 8, 8)).astype(np.float32))
    emb = torch.from_numpy(g.standard_normal((1, 128)).astype(np.float32))
    with torch.no_grad():
        y_stock = blk(x, emb)
        assert calls == []
        with fused_conv():
            y_fused = blk(x, emb)
            assert [k for k, _ in calls] == ["gn", "gn"]
            with fused_conv(False):
                blk(x, emb)
                assert not layers._fused_conv
            assert layers._fused_conv
        assert not layers._fused_conv
    assert len(calls) == 2
    torch.testing.assert_close(y_fused, y_stock, rtol=0, atol=1e-5)
    assert layers.to_conv_layout(x) is x  # the stock layout is left alone
    with fused_conv():
        assert layers.to_conv_layout(x).is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_stages_run_in_its_configuration(monkeypatch, fused):
    """``EDTRPipeline(fused_conv=)`` sets the configuration around each
    stage and only there: the SwinIR tail's three upsample convs reach the
    wrapper (on channels-last memory) only in the fused pipeline, and the
    module-level default is stock again afterwards."""
    from edtr_torch.models import layers
    from edtr_torch.pipeline import EDTRPipeline

    base = port_tiny()
    pipe = EDTRPipeline(base.swinir, base.cldm, base.diffusion, device="cpu",
                        fused_conv=fused)
    calls = _record_wrappers(monkeypatch)
    lq = np.random.default_rng(15).random((1, 3, IMAGE, IMAGE)).astype(np.float32)
    out = pipe.pre_restore(torch.from_numpy(lq))
    assert out.shape == (1, 3, IMAGE, IMAGE)
    assert calls == ([("up", True)] * 3 if fused else [])
    assert not layers._fused_conv


def test_packed_weight_follows_the_weight():
    conv = Conv2d(32, 64, 3, padding=1)
    p1 = conv.packed_weight(torch.bfloat16)
    assert p1.shape == (3, 3, 64, 32) and p1.dtype == torch.bfloat16
    assert conv.packed_weight(torch.bfloat16) is p1  # cached
    torch.testing.assert_close(p1, conv.weight.detach().to(torch.bfloat16).permute(2, 3, 0, 1),
                               rtol=0, atol=0)
    with torch.no_grad():
        conv.weight.mul_(2.0)  # in place: the version moves
    p2 = conv.packed_weight(torch.bfloat16)
    assert p2 is not p1
    torch.testing.assert_close(p2.float(), (conv.weight.detach().to(torch.bfloat16)
                                            .permute(2, 3, 0, 1).float()), rtol=0, atol=0)
    conv.load_state_dict({"weight": torch.zeros(64, 32, 3, 3), "bias": torch.zeros(64)})
    assert not conv.packed_weight(torch.bfloat16).any()


# (B, H, W, Cin, Cout, bm) of the fused 512² restore's launches: the 8²
# latents (whole-image tier), UNet/ControlNet 16²-64², VAE 64²-512²,
# upsamples (output sizes)
@pytest.mark.parametrize("b,h,w,cin,cout,bm", [
    (1, 8, 8, 2560, 1280, 64), (1, 8, 8, 1280, 1280, 64), (1, 16, 16, 1920, 1280, 128),
    (1, 32, 32, 960, 640, 128), (1, 64, 64, 320, 320, 128), (1, 512, 512, 256, 128, 128),
    (1, 256, 256, 512, 512, 128), (1, 128, 128, 64, 64, 128), (2, 24, 40, 64, 128, 128)])
def test_plan_covers_k_once(b, h, w, cin, cout, bm):
    name = "gn_conv_whole" if bm == 64 else "gn_conv_band"  # 64-pixel tiles: one 8² image
    wn, th, splits, per = G.gn_plan(b, h, w, cin, cout, name)
    bn = G.GN_TILES[wn, th]
    chunks = cin // G.GN_KC
    assert cout % bn == 0 and (th == 8) == (bm == 64)
    assert (splits - 1) * per < chunks <= splits * per  # no empty split
    tiles = b * -(-h // th) * -(-w // 8) * (cout // bn)
    assert splits == 1 or tiles * splits <= G.SMS
    assert splits == 1 or tiles < G.SMS  # the counters cover every tile


def test_chip_smoke_lists_every_kernel():
    """chip_smoke.py's ``kernels`` line has one row per kernel wrapper of the
    port, the ones off the 512² path included (it once listed only the
    kernels on that path)."""
    import chip_smoke
    from edtr_torch.ops import flash_attention as FA

    listed = (list(chip_smoke.KERNELS) + list(chip_smoke.BWD_KERNELS)
              + list(chip_smoke.CONV_KERNELS))
    assert sorted(listed) == sorted(list(FA.launches) + list(G.launches))
    assert chip_smoke.KERNELS["flash_fwd"][2] is None  # held, not launched at 512²
    assert [n for _, n in chip_smoke.CONV_KERNELS.values()] == [88, 216, 18]


def test_so_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header gives a new library name, so a stale
    build is never loaded."""
    from edtr_torch.ops import _cuda

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    first = _cuda.so_path("k")
    assert _cuda.so_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _cuda.so_path("k") != first


# ---- the phase-folded nearest-2x conv (K6) and the kernel plans ----------


def _folds_from_jax(wk):
    """JAX's folds ``_fold_subpixel_weights(w)`` ((2, 2, cin, 4*cout), HWIO,
    phase p the channel block [p*cout, (p+1)*cout)) in the port's layout:
    (4 phases, 2, 2, cout, cin), each tap's (in, out) transposed to (out,
    in)."""
    cin, cout = wk.shape[2], wk.shape[3]
    fj = np.asarray(JG._fold_subpixel_weights(jnp.asarray(wk)))
    return fj.reshape(2, 2, cin, 4, cout).transpose(3, 0, 1, 4, 2)


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 128)])
def test_fold_subpixel_weights_bit_identical_to_jax(cin, cout):
    """The port folds OIHW weights with the same fp32 sums, rows first,
    then columns, as JAX's ``_fold_subpixel_weights`` folds HWIO ones."""
    wk = (np.random.default_rng(cin).standard_normal((3, 3, cin, cout)) * 0.05
          ).astype(np.float32)
    got = G.fold_subpixel_weights(_oihw(wk), torch.float32).numpy()
    assert got.shape == (4, 2, 2, cout, cin)
    want = _folds_from_jax(wk)
    assert np.array_equal(got.view(np.uint32), np.ascontiguousarray(want).view(np.uint32))
    bf = G.fold_subpixel_weights(_oihw(wk), torch.bfloat16)  # rounded once, from fp32
    assert bf.dtype == torch.bfloat16 and bf.is_contiguous()
    assert torch.equal(bf, torch.from_numpy(got).to(torch.bfloat16))


def _phase_conv(x, folds):
    """``conv3x3(nearest2x(x))`` from the folds, as the kernel computes it:
    output phase (a, b) = (2i+a, 2j+b) is the VALID 2x2 conv of the
    1-padded low-res input at rows i+a-1.., columns j+b-1.. with the taps
    ``folds[2a+b]`` ((dr, dc, out, in)); the phases interleaved. x (B, C,
    H, W) fp32 -> (B, out, 2H, 2W) fp32, sums in fp32."""
    b, _, h, w = x.shape
    z = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = torch.empty(b, folds.shape[3], 2 * h, 2 * w)
    for a in (0, 1):
        for bb in (0, 1):
            taps = folds[2 * a + bb].permute(2, 3, 0, 1).float()  # (out, in, dr, dc)
            out[:, :, a::2, bb::2] = torch.nn.functional.conv2d(
                z[:, :, a:a + h + 1, bb:bb + w + 1], taps)
    return out


@pytest.mark.parametrize("act", [None, "lrelu"])
def test_folded_phases_match_jax_subpixel(act):
    """The phase order and tap offsets the K6 kernel relies on: in fp32 the
    folded-phase conv is the plain nearest-2x conv (1e-5); in bf16, from the
    port's packed folds with the kernel's roundings (fp32 sums rounded, the
    bias added in bf16, LeakyReLU on the rounded value), it is JAX's
    ``_ups_subpixel`` within 2 bf16 ulps."""
    g = np.random.default_rng(13)
    x = g.standard_normal((2, 8, 6, 32)).astype(np.float32)            # NHWC, low-res
    wk = (g.standard_normal((3, 3, 32, 64)) * 0.05).astype(np.float32)
    bk = (g.standard_normal(64) * 0.1).astype(np.float32)
    xt, wt, bt = nchw(x), _oihw(wk), torch.from_numpy(bk)
    o32 = _phase_conv(xt, G.fold_subpixel_weights(wt, torch.float32)) + bt[:, None, None]
    if act == "lrelu":
        o32 = torch.nn.functional.leaky_relu(o32, 0.2)
    np.testing.assert_allclose(t2n(o32), t2n(G.plain_upsample_conv(xt, wt, bt, act)),
                               rtol=1e-5, atol=1e-5)

    bf = torch.bfloat16
    xb = xt.to(bf)
    o = _phase_conv(xb.float(), G.fold_subpixel_weights(wt, bf)).to(bf) + bt.to(bf)[:, None, None]
    if act == "lrelu":
        o = torch.nn.functional.leaky_relu(o.float(), 0.2).to(bf)
    want = np.asarray(JG._ups_subpixel(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk),
                                       jnp.asarray(bk), act).astype(jnp.float32))
    got = nhwc(o.float())
    assert got.shape == want.shape == (2, 16, 12, 64)
    # one bf16 ulp at |want| (8 significant bits; 2^-10 the floor near zero)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -10))) - 7)
    assert np.all(np.abs(got - want) <= 2 * ulp), np.max(np.abs(got - want) / ulp)


# the main path's K6 launches (LOW-res input: UNet 8²-32², VAE decoder
# 64²-256², SwinIR tail 64²-256²) and K8b's (tokens, C = O)
_K6_SHAPES = [(1, 8, 8, 1280, 1280), (1, 16, 16, 1280, 1280), (1, 32, 32, 640, 640),
              (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 256, 256),
              (1, 64, 64, 64, 64), (1, 128, 128, 64, 64), (1, 256, 256, 64, 64)]
_K8B_SHAPES = [(4096, 320), (1024, 640), (256, 1280)]


# K5a/K5b: every shape of the fused restore (bs 1) and of the training
# step (bs 2), (B, H, W, Cin, Cout) by tier
_K5_SHAPES = [(k[0], (bs, k[3], k[4], k[2], k[5])) for bs in (1, 2)
              for k in sorted(set((k[:6] for k in GN_SHAPES)), key=str)]


@pytest.mark.parametrize("kind,shape", [("upsample_conv", s) for s in _K6_SHAPES]
                         + [("affine_matmul", s) for s in _K8B_SHAPES] + _K5_SHAPES)
def test_kernel_plans_fit(kind, shape):
    """Each redesigned kernel's plan at its main-path shapes: tiles divide
    the output, a block's shared memory fits the 232,448 bytes a block may
    use, and the split-K chunks of K5 and K6 cover Cin exactly once, with no
    empty split, within the arrival counters, in one wave."""
    from edtr_torch.ops import _proj

    if kind in ("gn_conv_whole", "gn_conv_band"):
        b, h, w, cin, cout = shape
        wn, th, splits, per = G.gn_plan(b, h, w, cin, cout, kind)
        bn = G.GN_TILES[wn, th]
        chunks = cin // G.GN_KC
        assert cin % G.GN_KC == 0 and cout % bn == 0
        assert (th == 8) == (kind == "gn_conv_whole")
        assert (splits - 1) * per < chunks <= splits * per  # every chunk once, no empty split
        tiles = b * -(-h // th) * -(-w // 8) * (cout // bn)
        assert tiles * 8 * th * bn >= b * h * w * cout  # the tiles cover the output
        assert splits == 1 or tiles * splits <= G.SMS
        assert splits == 1 or tiles <= 4 * G.SMS  # one arrival counter a tile
        assert G.gn_smem(wn, th) <= G.SMEM_LIMIT
    elif kind == "upsample_conv":
        b, h, w, cin, cout = shape
        tw, splits, per = G.ups_plan(b, h, w, cin, cout)
        chunks = -(-cin // G.UPS_KC)
        assert tw in (8, 16) and cout % G.UPS_BN == 0
        assert (splits - 1) * per < chunks <= splits * per  # every chunk once, no empty split
        tiles = b * -(-h // (128 // tw)) * -(-w // tw) * (cout // G.UPS_BN)
        assert splits == 1 or tiles * splits <= G.SMS
        assert splits == 1 or tiles <= 4 * G.SMS  # one arrival counter a tile
        assert G.UPS_SMEM <= G.SMEM_LIMIT
    else:
        m, c = shape
        bm, bn, groups = _proj.lnproj_plan(m, c, c, kind)
        assert m % bm == 0 and 256 % bm == 0  # a block inside one batch element
        assert c % bn == 0 and groups == c // bn  # one weight tile a block
        stages = _proj.lnproj_stages(bn, c)
        assert stages >= 2 and _proj.lnproj_smem(bn, c, stages) <= _proj.SMEM_LIMIT
        assert (m // bm) * groups <= G.SMS


def test_folded_weight_follows_the_weight():
    conv = Conv2d(32, 64, 3, padding=1)
    f1 = conv.folded_weight(torch.bfloat16)
    assert f1.shape == (4, 2, 2, 64, 32) and f1.dtype == torch.bfloat16
    assert conv.folded_weight(torch.bfloat16) is f1  # cached
    assert torch.equal(f1, G.fold_subpixel_weights(conv.weight, torch.bfloat16))
    with torch.no_grad():
        conv.weight.mul_(2.0)  # in place: the version moves
    f2 = conv.folded_weight(torch.bfloat16)
    assert f2 is not f1 and torch.equal(f2, G.fold_subpixel_weights(conv.weight,
                                                                    torch.bfloat16))
    assert conv.packed_weight(torch.bfloat16).shape == (3, 3, 64, 32)  # its own cache


# (Cin, Cout) of the flagship's fused convs (UNet/ControlNet 320-2560, the
# VAE 128-512, SwinIR's tail 64) and of the tiny flagship's (32, 64); the
# nearest-2x conv keeps its channels
ROUTE_CONVS = [(320, 320), (640, 1280), (2560, 1280), (1920, 640), (128, 256), (512, 512),
               (64, 64), (32, 32), (32, 64), (64, 32), (96, 96)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout", ROUTE_CONVS)
def test_conv_route_follows_the_kernel_predicates(cin, cout, dtype):
    """Off the CPU (a meta tensor here), a fused-configuration conv goes to
    its wrapper exactly where its kernel takes the call: K5 bf16 with Cin
    and Cout multiples of 64, K6 bf16 with Cin a multiple of 32 and Cout of
    64; else the plain version (JAX's ``_ref``). On the CPU the wrapper,
    which is the plain version there, takes every call."""
    from edtr_torch.models import layers

    conv = Conv2d(cin, cout, 3, padding=1)
    x = torch.empty((1, cin, 16, 16), device="meta", dtype=dtype)
    bf16 = dtype == torch.bfloat16
    assert layers.conv_route(x, conv) == (bf16 and cin % 64 == 0 and cout % 64 == 0)
    assert layers.conv_route(x, conv, upsample=True) == (bf16 and cin % 32 == 0
                                                         and cout % 64 == 0)
    assert G.gn_conv_takes(dtype, cin, cout) == layers.conv_route(x, conv)
    assert G.upsample_conv_takes(dtype, cin, cout) == layers.conv_route(x, conv, upsample=True)
    assert layers.conv_route(torch.empty((1, cin, 16, 16), dtype=dtype), conv)


def test_a_conv_routed_to_the_plain_version_matches_the_wrapper(monkeypatch):
    """A ResBlock and a nearest-2x conv inside ``fused_conv()`` whose route
    says plain (as a fp32 or 32-channel call on the card) give the
    wrapper's numbers: the wrappers are the plain versions on the CPU."""
    from edtr_torch.models import layers
    from edtr_torch.models.unet import ResBlock

    blk = ResBlock(32, 128, 64)
    up = Conv2d(32, 64, 3, padding=1)
    g = np.random.default_rng(15)
    x = torch.from_numpy(g.standard_normal((1, 32, 8, 8)).astype(np.float32))
    emb = torch.from_numpy(g.standard_normal((1, 128)).astype(np.float32))
    with torch.no_grad(), fused_conv():
        want = blk(x, emb), layers.upsample_conv3x3(x, up, "lrelu")
        calls = _record_wrappers(monkeypatch)
        monkeypatch.setattr(layers, "conv_route", lambda *a, **k: False)
        got = blk(x, emb), layers.upsample_conv3x3(x, up, "lrelu")
    assert calls == []
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
