"""edtr_torch's kernel wrappers on the card: a CUDA tensor at a supported
shape launches the hand-written kernel (its launch count rises by one), and
one no kernel takes raises. (``chip_smoke.py`` holds each kernel against its
plain version; here the projection kernels are also held to theirs at the
main path's token counts and widths.) The flash backward wrappers match
``plain_bwd``; the K5/K6 and K7-K10 autograd Functions give the plain
versions' gradients. The detector's NMS and rankings on the card equal
the CPU's, and the full-width detector runs on the card with no
host-to-device copy.
The kernels have no CPU mode: without a card this test skips. This file
imports no JAX, so on a card host without JAX it runs alone, without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_card.py
"""

import pytest
import torch

from edtr_torch.ops import attention as A
from edtr_torch.ops import flash_attention as F
from edtr_torch.ops import geglu as GG
from edtr_torch.ops import gn_conv as G
from edtr_torch.ops import ln_matmul as LM
from edtr_torch.ops import swin_block as SB
from edtr_torch.ops import window_attention as WA
from proj_bench import GN_SHAPES


@pytest.mark.cuda
def test_cuda_call_launches_or_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q = torch.randn((1, 1024, 2, 64), device="cuda", dtype=torch.bfloat16)
    before = F.launches["whole_fwd"]
    A.dot_product_attention(q, q, q)
    assert F.launches["whole_fwd"] == before + 1
    # fp32, or D 128, at a shape JAX's Pallas kernels take: no port kernel
    # takes it, so the route takes the plain math (no launch)
    before = dict(F.launches)
    qf = q.float()
    torch.testing.assert_close(A.dot_product_attention(qf, qf, qf),
                               A.plain_attention(qf, qf, qf, 64 ** -0.5))
    q128 = torch.randn((1, 1024, 2, 128), device="cuda", dtype=torch.bfloat16)
    torch.testing.assert_close(A.dot_product_attention(q128, q128, q128),
                               A.plain_attention(q128, q128, q128, 128 ** -0.5))
    assert F.launches == before
    with pytest.raises(ValueError):  # the wrapper called directly still raises
        F.whole_fwd(*(t.reshape(2, 1024, 64).contiguous() for t in (qf, qf, qf)), 0.125)


def _conv_args(cin=64, cout=64, h=8):
    def rnd(*shape):
        return torch.randn(shape, device="cuda")
    x = rnd(1, cin, h, h).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return x, rnd(1, cin), rnd(1, cin), rnd(cout, cin, 3, 3) * 0.05, rnd(cout)


@pytest.mark.cuda
@pytest.mark.parametrize("name,h", [("gn_conv_whole", 8), ("gn_conv_band", 16),
                                    ("upsample_conv", 8)])
def test_conv_call_launches(name, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, mul, add, w, b = _conv_args(h=h)
    before = G.launches[name]
    if name == "upsample_conv":
        out = G.upsample_conv(x, w, b, "lrelu")
        assert out.shape == (1, 64, 2 * h, 2 * h)
    else:
        emb = torch.randn((1, 64), device="cuda", dtype=torch.bfloat16)
        out = G.gn_silu_conv(x, mul, add, w, b, emb, torch.zeros_like(x))
        assert out.shape == x.shape
    torch.cuda.synchronize()
    assert G.launches[name] == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
def test_conv_unsupported_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, mul, add, w, b = _conv_args()
    with pytest.raises(ValueError):  # fp32 activations: no kernel takes them
        G.gn_silu_conv(x.float(), mul, add, w, b)
    with pytest.raises(ValueError):  # Cin 48: not a multiple of 64
        G.gn_silu_conv(x[:, :48], mul[:, :48], add[:, :48], w[:, :48], b)
    x96, mul96, add96, w96, b96 = _conv_args(cin=96, cout=96)
    for h in (8, 16):  # both tiers
        xh = torch.randn((1, 96, h, h), device="cuda").to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        with pytest.raises(ValueError):  # Cin 96: not a multiple of 64
            G.gn_silu_conv(xh, mul96, add96, w96[:64], b96[:64])
        with pytest.raises(ValueError):  # Cout 96: not a multiple of 64
            G.gn_silu_conv(xh[:, :64], mul96[:, :64], add96[:, :64], w96[:, :64], b96)
    with pytest.raises(ValueError):  # Cout 96: not a multiple of 64
        G.upsample_conv(x, torch.cat([w, w[:32]]), torch.cat([b, b[:32]]))
    with pytest.raises(ValueError):  # the 9-tap pack: the kernel reads the folded one
        G.upsample_conv(x, w, b, w_packed=G.pack_weight(w, torch.bfloat16))
    with pytest.raises(ValueError):  # fp32 activations
        G.upsample_conv(x.float(), w, b)


# the fused 512² restore's nearest-2x convs (low-res input, Cin = Cout, act)
# and the training step's bs-2 UNet one
UPS_SHAPES = [(1, 8, 1280, None), (1, 16, 1280, None), (1, 32, 640, None), (1, 64, 512, None),
              (1, 128, 512, None), (1, 256, 256, None), (1, 64, 64, "lrelu"),
              (1, 128, 64, "lrelu"), (1, 256, 64, "lrelu"), (2, 8, 1280, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,c,act", UPS_SHAPES)
def test_upsample_conv_matches_plain_at_main_path_shapes(b, h, c, act):
    """K6 (the phase-folded wgmma conv) against its plain version at every
    main-path shape, with chip_smoke.py's conv limits: the folds round once
    where the plain version rounds each tap, an ulp or two of the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(h + c)
    x = torch.randn((b, c, h, h), generator=gen, device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn((c, c, 3, 3), generator=gen, device="cuda") * (9 * c) ** -0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.05
    before = G.launches["upsample_conv"]
    out = G.upsample_conv(x, w, bias, act,
                          w_packed=G.fold_subpixel_weights(w, torch.bfloat16))
    want = G.plain_upsample_conv(x, w, bias, act)
    torch.cuda.synchronize()
    assert G.launches["upsample_conv"] == before + 1
    assert out.shape == want.shape == (b, c, 2 * h, 2 * h)
    assert out.is_contiguous(memory_format=torch.channels_last)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL_CONV_MAX * want.float().abs().max().item(), err
    rel = ((out.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= TOL_CONV_L2, rel


def _gn_case(key, seed, add_shift=0.0, bias_scale=0.05):
    """K5 at a ``gn_conv.shapes`` key against its plain version: the
    kernel's output, the plain one's, and the wrapper that launched."""
    name, b, cin, h, w, cout, has_emb, has_res, _ = key
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x = rnd(b, cin, h, w).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    mul, add = 1 + rnd(b, cin, scale=0.1), add_shift + rnd(b, cin, scale=0.1)
    wt, bias = rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(cout, scale=bias_scale)
    emb = rnd(b, cout, scale=0.5).to(torch.bfloat16) if has_emb else None
    res = (rnd(b, cout, h, w).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
           if has_res else None)
    before = dict(G.launches)
    out = G.gn_silu_conv(x, mul, add, wt, bias, emb, res,
                         w_packed=G.pack_weight(wt, torch.bfloat16))
    want = G.plain_gn_silu_conv(x, mul, add, wt, bias, emb, res)
    torch.cuda.synchronize()
    launched = [n for n in G.launches if G.launches[n] != before[n]]
    return out, want, launched


def _assert_conv_close(out, want):
    assert out.shape == want.shape and out.dtype == want.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=torch.channels_last)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL_CONV_MAX * want.float().abs().max().item(), err
    rel = ((out.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= TOL_CONV_L2, rel


# every K5 shape of the fused 512² restore (bs 1) and of the training step
# (bs 2), as proj_bench.py pins them
K5_KEYS = [(k[0], bs, *k[2:]) for bs in (1, 2) for k in sorted(GN_SHAPES, key=str)]


@pytest.mark.cuda
@pytest.mark.parametrize("key", K5_KEYS, ids=str)
def test_gn_conv_matches_plain_at_main_path_shapes(key):
    """K5a/K5b (gnconv_wgmma_kernel) against the plain version at every
    main-path shape, with chip_smoke.py's conv limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out, want, launched = _gn_case(key, seed=sum(key[1:6]))
    assert launched == [key[0]]
    _assert_conv_close(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,h,w", [("gn_conv_band", 24, 40), ("gn_conv_band", 20, 13),
                                      ("gn_conv_band", 16, 24), ("gn_conv_whole", 8, 12),
                                      ("gn_conv_whole", 5, 7)])
def test_gn_conv_halo_is_zero_after_the_activation(name, h, w):
    """H and W that are not tile multiples, with add ~ 2: silu(x*mul + add)
    is ~1.8 where x = 0, so a halo that was activated instead of zeroed
    (outside the image, or past the tile's last row or column) moves the
    edge pixels by O(|out|); the bias is small beside it. At 16 x 24 (three
    row-band tiles of 128 channels) the chunks also split in two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    key = (name, 2, 128, h, w, 128, True, True, None)
    out, want, launched = _gn_case(key, seed=h * w, add_shift=2.0, bias_scale=0.0)
    assert launched == [name]
    _assert_conv_close(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("key", [("gn_conv_whole", 1, 2560, 8, 8, 1280, True, False, None),
                                 ("gn_conv_band", 1, 2560, 16, 16, 1280, True, False, None)],
                         ids=str)
def test_gn_conv_split_k_is_deterministic(key):
    """Two launches at a split-K shape give bit-identical outputs: the last
    block of a tile sums the partials in split order, whatever order the
    blocks arrive in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert G.gn_plan(key[1], key[3], key[4], key[2], key[5], key[0])[2] > 1  # split K
    first, want, _ = _gn_case(key, seed=3)
    second, _, _ = _gn_case(key, seed=3)
    assert torch.equal(first, second)
    _assert_conv_close(first, want)


def _proj_args(n=256, c=64, o=128, b=2):
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device="cuda") * scale
    x = (rnd(b, n, c, scale=2.0) + 0.5).to(torch.bfloat16)
    return x, 1 + rnd(c, scale=0.1), rnd(c, scale=0.1), rnd(o, c, scale=c ** -0.5), rnd(o)


# the projection and conv kernels vs their plain versions: chip_smoke.py's
# limits
TOL_PROJ_MAX = 2.0 ** -6
TOL_CONV_MAX = 2.0 ** -6
TOL_CONV_L2 = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,c", [
    *((name, 256, 64) for name in ("ln_matmuls_1", "ln_matmuls_3", "affine_matmul",
                                   "geglu_proj", "ln_geglu_proj")),
    # the main path's token counts and widths (bs 1)
    *((name, n, c) for name in ("ln_matmuls_1", "ln_matmuls_3", "ln_geglu_proj",
                                "affine_matmul")
      for n, c in ((4096, 320), (1024, 640), (256, 1280)))])
def test_proj_call_launches(name, n, c):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    b = 2 if c == 64 else 1
    o = 128 if c == 64 else (4 * c if "geglu" in name else c)
    x, s, sh, w, bias = _proj_args(n, c, (2 if "geglu" in name else 1) * o, b)
    key = name[:-2] if name[-1].isdigit() else name
    mod = GG if "geglu" in key else LM
    before = mod.launches[key]
    if key == "ln_matmuls":
        k = int(name[-1])
        ws = [w] + [torch.randn_like(w) * c ** -0.5 for _ in range(k - 1)]
        out = torch.cat(LM.ln_matmuls(x, s, sh, ws), -1)
        want = torch.cat(LM.plain_ln_matmuls(x, s, sh, ws), -1)
        assert out.shape == (b, n, k * o)
    elif key == "affine_matmul":
        mul, add = s.expand(b, -1).contiguous(), sh.expand(b, -1).contiguous()
        out = LM.affine_matmul(x, mul, add, w, bias)
        want = LM.plain_affine_matmul(x, mul, add, w, bias)
    elif key == "geglu_proj":
        out, want = GG.geglu_proj(x, w, bias), GG.plain_geglu_proj(x, w, bias)
    else:
        out = GG.ln_geglu_proj(x, s, sh, w, bias)
        want = GG.plain_ln_geglu_proj(x, s, sh, w, bias)
    torch.cuda.synchronize()
    assert mod.launches[key] == before + 1
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL_PROJ_MAX * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_proj_unsupported_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, s, sh, w, b = _proj_args()
    with pytest.raises(ValueError):  # fp32 tokens: no kernel takes them
        LM.ln_matmuls(x.float(), s, sh, [w])
    with pytest.raises(ValueError):  # 64 tokens: not a size the kernels take
        GG.ln_geglu_proj(x[:, :64], s, sh, w, b)
    with pytest.raises(ValueError):  # strided tokens
        LM.affine_matmul(x.transpose(1, 2).contiguous().transpose(1, 2), s[None].expand(2, -1),
                         sh[None].expand(2, -1), w, b)
    mul, add = s[None].expand(2, -1).contiguous(), sh[None].expand(2, -1).contiguous()
    with pytest.raises(ValueError):  # 64 tokens a batch element: not a size it takes
        LM.affine_matmul(x[:, :64].contiguous(), mul, add, w, b)
    with pytest.raises(ValueError):  # one (C) row of mul/add for two batch elements
        LM.affine_matmul(x, mul[:1], add[:1], w, b)
    with pytest.raises(ValueError):  # O 96: not a multiple of 64
        LM.affine_matmul(x, mul, add, w[:96], b[:96])


def _swin_args(h=16, w=16, c=60, hidden=120):
    """Tokens and weights of one Swin block at window 8, SwinIR's odd widths
    scaled down (2 heads x 30)."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device="cuda") * scale
    x = rnd(2, h * w, c).to(torch.bfloat16)
    pre = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1), rnd(3 * c, c, scale=c ** -0.5),
           rnd(3 * c, scale=0.1))
    post = (rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1), 1 + rnd(c, scale=0.1),
            rnd(c, scale=0.1), rnd(hidden, c, scale=c ** -0.5), rnd(hidden, scale=0.1),
            rnd(c, hidden, scale=hidden ** -0.5), rnd(c, scale=0.1))
    return x, pre, post


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0, 4, -4])
def test_swin_calls_launch(d):
    """A fused block's three wrappers at a supported shape launch their
    kernels: swin_pre, window_attention on the strided q/k/v slices of its
    windows (masked when the block is shifted), swin_post."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, pre, post = _swin_args()
    before = {**SB.launches, **WA.launches}
    qkv, xr = SB.swin_pre(x, *pre, 16, 16, 8, d)
    assert qkv.shape == (2, 4, 64, 180) and xr.shape == x.shape
    q, k, v = qkv.view(8, 64, 3, 2, 30).unbind(2)
    bias = torch.randn((2, 64, 64), device="cuda")
    mask = torch.zeros((4, 64, 64), device="cuda") if d else None
    out = WA.window_attention(q, k, v, bias, mask)
    assert out.shape == (8, 64, 2, 30) and out.is_contiguous()
    y = SB.swin_post(out.view(2, 4, 64, 60), xr, *post, 16, 16, 8)
    assert y.shape == x.shape
    torch.cuda.synchronize()
    assert {**SB.launches, **WA.launches} == {k: n + 1 for k, n in before.items()}


@pytest.mark.cuda
def test_swin_unsupported_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, pre, post = _swin_args()
    with pytest.raises(ValueError):  # fp32 tokens: no kernel takes them
        SB.swin_pre(x.float(), *pre, 16, 16, 8, 0)
    with pytest.raises(ValueError):  # h % win != 0
        SB.swin_pre(x[:, :12 * 16], *pre, 12, 16, 8, 0)
    qkv, xr = SB.swin_pre(x, *pre, 16, 16, 8, 0)
    with pytest.raises(ValueError):  # h % win != 0
        SB.swin_post(qkv[..., :60].contiguous(), xr[:, :12 * 16].contiguous(), *post, 12, 16, 8)
    q, k, v = qkv.view(8, 64, 3, 2, 30).unbind(2)
    bias = torch.randn((2, 64, 64), device="cuda")
    with pytest.raises(ValueError):  # fp32 q/k/v
        WA.window_attention(q.float(), k.float(), v.float(), bias)
    with pytest.raises(ValueError):  # 16 tokens a window (window 4)
        WA.window_attention(q[:, :16], k[:, :16], v[:, :16], bias[:, :16, :16])
    with pytest.raises(ValueError):  # separate q/k/v, not one packed tensor's slices
        WA.window_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias)


# flash forward vs plain_fwd (chip_smoke.py's limits): both round O to bf16
# and the kernel rounds the unnormalised P where plain_fwd rounds the
# normalised one, so a right kernel differs by about a bf16 ulp of max|O|;
# lse is fp32 on both sides (exp2 against exp, other summation orders)
TOL_O_MAX = 2.0 ** -6
TOL_O_L2 = 1e-2
TOL_LSE = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [0, 1])
@pytest.mark.parametrize("name,bh,n", [("wholekv_fwd", 1, 2048), ("wholekv_fwd", 5, 4096),
                                       ("wholekv_fwd", 10, 4096), ("flash_fwd", 5, 8192),
                                       ("whole_fwd", 10, 1024), ("whole_fwd", 20, 1024)])
def test_flash_fwd_matches_plain(name, bh, n, plan, monkeypatch):
    """The wgmma forward (K1, K4 and K2's wrappers) in each tile plan
    against ``plain_fwd``, with the logits scaled up (q x 4, scale 1/8) so
    that the row max moves between K/V tiles and the online rescale runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(F, "flash_plan", lambda *a: plan)
    g = torch.Generator(device="cuda").manual_seed(n + bh)
    q, k, v = (torch.randn((bh, n, 64), generator=g, device="cuda") for _ in range(3))
    q, k, v = (q * 4).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
    before = F.launches[name]
    o, lse = F.FWD[name](q, k, v, 0.125)
    assert F.launches[name] == before + 1
    o_p, lse_p = F.plain_fwd(q, k, v, 0.125)
    o_max = o_p.float().abs().max()
    assert (o.float() - o_p.float()).abs().max() <= TOL_O_MAX * o_max
    assert ((o.float() - o_p.float()).norm() / o_p.float().norm()) <= TOL_O_L2
    assert (lse - lse_p).abs().max() <= TOL_LSE


# swin_pre vs plain_swin_pre (chip_smoke.py's Swin limits): the same fp32
# LayerNorm and bias, rounded to bf16 at the same places; the products in
# fp32 in another order
TOL_SWIN_MAX = 2.0 ** -6
TOL_SWIN_L2 = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [60, 180, 192])
@pytest.mark.parametrize("h,w", [(64, 64), (24, 40)])
@pytest.mark.parametrize("d", [0, 4, -4, 2])
def test_swin_pre_matches_plain(d, h, w, c):
    """The wgmma ``swin_pre`` (K10a) at bs 2 against ``plain_swin_pre``:
    window grids 8 x 8 and 3 x 5, rolls that wrap at the image edge, C with
    one chunk of K (60), 180 (padded to 192) and 192 (unpadded); qkv and xr
    bit-identical across two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(c + h + d)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = (rnd(2, h * w, c, scale=2.0) + 0.5).to(torch.bfloat16)
    ln_s, ln_b = 1 + rnd(c, scale=0.1), rnd(c, scale=0.1)
    wq, bias = rnd(3 * c, c, scale=c ** -0.5), rnd(3 * c, scale=0.05)
    wp = SB.pad_weight(wq)
    before = SB.launches["swin_pre"]
    qkv, xr = SB.swin_pre(x, ln_s, ln_b, wq, bias, h, w, 8, d, w_packed=wp)
    qkv2, xr2 = SB.swin_pre(x, ln_s, ln_b, wq, bias, h, w, 8, d, w_packed=wp)
    assert SB.launches["swin_pre"] == before + 2
    assert torch.equal(qkv, qkv2) and torch.equal(xr, xr2)
    q_p, xr_p = SB.plain_swin_pre(x, ln_s, ln_b, wq, bias, h, w, 8, d)
    assert torch.equal(xr, xr_p)
    err = (qkv.float() - q_p.float()).abs().max()
    assert err <= TOL_SWIN_MAX * q_p.float().abs().max()
    assert ((qkv.float() - q_p.float()).norm() / q_p.float().norm()) <= TOL_SWIN_L2


# flash backward vs plain_bwd: both round p and dS to bf16 at the same places
# and accumulate in fp32 in other orders, so a right kernel differs by about
# a bf16 ulp of the largest gradient (chip_smoke.py's limits)
TOL_BWD_MAX = 2.0 ** -6
TOL_BWD_L2 = 1e-2


def _bwd_args(bh, n, seed=0, q_mul=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((bh, n, 64), generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    q = (q.float() * q_mul).to(torch.bfloat16)
    out, lse = F.plain_fwd(q, k, v, 0.125)
    dd = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, dd


@pytest.mark.cuda
@pytest.mark.parametrize("name,bh,n", [("whole_bwd", 20, 1024), ("flash_bwd", 10, 4096),
                                       ("whole_bwd", 4, 1024), ("whole_bwd", 2, 256),
                                       ("whole_bwd", 2, 512), ("whole_bwd", 1, 64),
                                       ("flash_bwd", 2, 2048), ("flash_bwd", 1, 4096)])
def test_flash_bwd_matches_plain(name, bh, n):
    """The wgmma backward pair at the training step's shapes ((20, 1024):
    K11a; (10, 4096): K11b + K11c) and smaller ones, with the logits scaled
    up (q x 3), against ``plain_bwd``; two calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    args = _bwd_args(bh, n, q_mul=3.0)
    before = dict(F.launches)
    got = F.BWD[name](*args, 0.125)
    again = F.BWD[name](*args, 0.125)
    want = F.plain_bwd(*args, 0.125)
    torch.cuda.synchronize()
    launched = {k: F.launches[k] - before[k] for k in before}
    assert launched == {
        k: 2 * int(k == name or (name == "flash_bwd" and k.startswith("flash_bwd")))
        for k in before}
    for what, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.equal(a, c), what
        err = (a.float() - b.float()).abs().max().item()
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert err <= TOL_BWD_MAX * b.float().abs().max().item(), (what, err)
        assert rel <= TOL_BWD_L2, (what, rel)


@pytest.mark.cuda
def test_flash_bwd_unsupported_raises():
    """Shapes and layouts the wgmma backward does not take raise on CUDA
    tensors: N not a multiple of the row tile (64), head dim 32, a tensor
    that is not 16-byte aligned (TMA), fp32 q/k/v/dO, bf16 lse, lse of the
    wrong shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do, lse, dd = _bwd_args(2, 256)
    fns = (F.whole_bwd, F.flash_bwd_dq, F.flash_bwd_dkv)
    buf = torch.empty(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
    q_off = buf[1:].view_as(q)  # contiguous, 2 bytes past a 16-byte boundary
    q_off.copy_(q)
    c = [t[:, :160].contiguous() for t in (q, k, v, do, lse, dd)]
    n32 = [t[..., :32].contiguous() for t in (q, k, v, do)]
    cases = [c, (*n32, lse, dd), (q_off, k, v, do, lse, dd),
             (q.float(), k.float(), v.float(), do.float(), lse, dd),
             (q, k, v, do, lse.to(torch.bfloat16), dd),
             (q, k, v, do, lse[:, :128].contiguous(), dd)]
    before = dict(F.launches)
    for args in cases:
        for fn in fns:
            with pytest.raises(ValueError):
                fn(*args, 0.125)
    assert F.launches == before


# the Function against autograd through plain_attention: autograd rounds dP
# to bf16 (the gradient of the bf16 probabilities) and takes dS from the
# fp32 softmax, where the kernels keep dP in fp32 and round dS; each is a
# bf16 ulp of an element here and there, so the limits are the kernel
# limits with twice the max abs error
TOL_FN_MAX = 2.0 ** -5


@pytest.mark.cuda
def test_flash_attention_backward_launches_the_kernels():
    """Attention at a flash shape under grad: the forward and backward
    kernels launch once each, and the gradients reaching q, k and v through
    the Function (the (B, N, H, D) <-> (BH, N, D) moves, dO made contiguous,
    D from the saved output) match autograd through the plain math."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, launched in ((4096, ("wholekv_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
                        (1024, ("whole_fwd", "whole_bwd"))):
        q, k, v = (torch.randn((2, n, 3, 64), generator=g, device="cuda",
                               dtype=torch.bfloat16).requires_grad_() for _ in range(3))
        # a non-uniform cotangent, not contiguous in the flat layout
        cot = torch.randn((2, n, 3, 64), generator=g, device="cuda", dtype=torch.bfloat16)
        before = dict(F.launches)
        out = A.dot_product_attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), cot)
        torch.cuda.synchronize()
        assert {name: F.launches[name] - before[name] for name in before} == {
            name: int(name in launched) for name in before}
        want = torch.autograd.grad(A.plain_attention(q, k, v, 0.125), (q, k, v), cot)
        for what, a, b in zip(("dq", "dk", "dv"), grads, want):
            assert a.dtype == torch.bfloat16 and a.shape == q.shape, what
            assert bool(torch.isfinite(a).all()), what
            err = (a.float() - b.float()).abs().max().item()
            rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
            assert err <= TOL_FN_MAX * b.float().abs().max().item(), (n, what, err)
            assert rel <= TOL_BWD_L2, (n, what, rel)


def _close_grads(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL_BWD_MAX * b.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("name,h", [("gn_conv_whole", 8), ("gn_conv_band", 16),
                                    ("upsample_conv", 8)])
def test_conv_functions_give_the_plain_gradients(name, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, mul, add, w, b = (t.requires_grad_() for t in _conv_args(h=h))
    before = G.launches[name]
    if name == "upsample_conv":
        ins = (x, w, b)
        out = G.upsample_conv(x, w, b)
        plain = G.plain_upsample_conv(x, w, b)
    else:
        emb = torch.randn((1, 64), device="cuda", dtype=torch.bfloat16, requires_grad=True)
        res = torch.randn(x.shape, device="cuda", dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        ins = (x, mul, add, w, b, emb, res)
        out = G.gn_silu_conv(*ins)
        plain = G.plain_gn_silu_conv(*ins)
    assert G.launches[name] == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, device="cuda", dtype=out.dtype)
    _close_grads(torch.autograd.grad(out, ins, cot), torch.autograd.grad(plain, ins, cot))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ln_matmuls", "affine_matmul", "geglu_proj",
                                  "ln_geglu_proj", "window_attention", "swin_pre",
                                  "swin_post"])
def test_proj_and_swin_functions_give_the_plain_gradients(name):
    """Each K7-K10 wrapper under grad on the card: it launches its kernel,
    its output carries the Function's backward, and the gradients reaching
    every differentiable input are the plain version's (the backward
    recomputes it); the bf16 weight copy and the shift mask get none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, s, sh, w, b = (t.requires_grad_() for t in _proj_args())
    if name == "ln_matmuls":
        w2 = (torch.randn_like(w) * 0.125).requires_grad_()
        wp = torch.cat([w, w2]).detach().to(torch.bfloat16).requires_grad_()
        ins, mod, kw = (x, s, sh, w, w2), LM, dict(w_packed=wp)

        def fn(x, s, sh, w, w2, **kw):
            return torch.cat(LM.ln_matmuls(x, s, sh, [w, w2], **kw), -1)

        def plain(x, s, sh, w, w2):
            return torch.cat(LM.plain_ln_matmuls(x, s, sh, [w, w2]), -1)
    elif name == "affine_matmul":
        mul = (1 + 0.1 * torch.randn((2, 64), device="cuda")).requires_grad_()
        add = (0.1 * torch.randn((2, 64), device="cuda")).requires_grad_()
        wp = w.detach().to(torch.bfloat16).requires_grad_()
        ins, mod, kw = (x, mul, add, w, b), LM, dict(w_packed=wp)
        fn, plain = LM.affine_matmul, LM.plain_affine_matmul
    elif name in ("geglu_proj", "ln_geglu_proj"):
        wp = w.detach().to(torch.bfloat16).requires_grad_()
        ins = (x, w, b) if name == "geglu_proj" else (x, s, sh, w, b)
        mod, kw = GG, dict(w_packed=wp)
        fn, plain = getattr(GG, name), getattr(GG, "plain_" + name)
    elif name == "window_attention":
        xs, pre, _ = _swin_args()
        qkv, _ = SB.swin_pre(xs, *pre, 16, 16, 8, 4)
        qkv = qkv.detach().view(8, 64, 3, 2, 30).requires_grad_()
        bias = torch.randn((2, 64, 64), device="cuda", requires_grad=True)
        wp = torch.zeros((4, 64, 64), device="cuda", requires_grad=True)  # the mask
        ins, mod, kw = (qkv, bias), WA, {}

        def fn(qkv, bias):
            return WA.window_attention(*qkv.unbind(2), bias, wp)

        def plain(qkv, bias):
            return WA.plain_window_attention(*qkv.unbind(2), bias, wp.detach(), 30 ** -0.5)
    elif name == "swin_pre":
        xs, pre, _ = _swin_args()
        pre = tuple(t.requires_grad_() for t in pre)
        wp = SB.pad_weight(pre[2].detach()).requires_grad_()
        ins, mod, kw = (xs.requires_grad_(), *pre), SB, dict(w_packed=wp)

        def fn(*a, **kw):
            return torch.cat([t.flatten() for t in SB.swin_pre(*a, 16, 16, 8, 4, **kw)])

        def plain(*a):
            return torch.cat([t.flatten() for t in SB.plain_swin_pre(*a, 16, 16, 8, 4)])
    else:
        xs, _, post = _swin_args()
        post = tuple(t.requires_grad_() for t in post)
        attn = torch.randn((2, 4, 64, 60), device="cuda").to(torch.bfloat16).requires_grad_()
        wp = SB.pad_weight(post[0].detach()).requires_grad_()
        packed = [wp, SB.pad_weight(post[4].detach()), SB.pad_weight(post[6].detach())]
        ins, mod, kw = (attn, xs.requires_grad_(), *post), SB, dict(packed=packed)

        def fn(*a, **kw):
            return SB.swin_post(*a, 16, 16, 8, **kw)

        def plain(*a):
            return SB.plain_swin_post(*a, 16, 16, 8)
    before = mod.launches[name]
    out = fn(*ins, **kw)
    assert mod.launches[name] == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, device="cuda", dtype=out.dtype)
    _close_grads(torch.autograd.grad(out, ins, cot), torch.autograd.grad(plain(*ins), ins, cot))
    out = fn(*ins, **kw)
    out.backward(cot)
    assert wp.grad is None, name


# (h, w, C, hidden, split) of swin_post's card checks: window grids 8 x 8
# and 3 x 5, C with one chunk of K (60), 180 (padded to 192) and 192; a
# hidden of one 192-column slab or two, the latter at one and at two blocks
# a window (a two-block cluster)
POST_CASES = [(h, w, c, hidden, split) for h, w in ((64, 64), (24, 40))
              for c, hidden in ((60, 120), (60, 240), (180, 360), (192, 384))
              for split in ((1, 2) if hidden > 192 else (1,))]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0, 4, -4])
@pytest.mark.parametrize("h,w,c,hidden,split", POST_CASES)
def test_swin_post_matches_plain(h, w, c, hidden, split, d, monkeypatch):
    """The wgmma ``swin_post`` (K10b) at bs 2 against ``plain_swin_post``
    (chip_smoke.py's Swin limits), its shortcut as ``swin_pre`` hands it
    at each roll d of a block, bit-identical across two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(SB, "post_split", lambda *a: split)
    g = torch.Generator(device="cuda").manual_seed(c + h + hidden + split + d)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = SB.roll2d((rnd(2, h * w, c, scale=2.0) + 0.5).to(torch.bfloat16), d, h, w).contiguous()
    attn = rnd(2, (h // 8) * (w // 8), 64, c).to(torch.bfloat16)
    ws = [rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.05), 1 + rnd(c, scale=0.1),
          rnd(c, scale=0.1), rnd(hidden, c, scale=c ** -0.5), rnd(hidden, scale=0.05),
          rnd(c, hidden, scale=hidden ** -0.5), rnd(c, scale=0.05)]
    packed = [SB.pad_weight(ws[i]) for i in (0, 4, 6)]
    before = SB.launches["swin_post"]
    out = SB.swin_post(attn, x, *ws, h, w, 8, packed=packed)
    again = SB.swin_post(attn, x, *ws, h, w, 8, packed=packed)
    assert SB.launches["swin_post"] == before + 2
    assert torch.equal(out, again)
    want = SB.plain_swin_post(attn, x, *ws, h, w, 8)
    err = (out.float() - want.float()).abs().max()
    assert err <= TOL_SWIN_MAX * want.float().abs().max()
    assert ((out.float() - want.float()).norm() / want.float().norm()) <= TOL_SWIN_L2


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("bh,n", [(1, 2048), (2, 2048), (1, 4096), (2, 4096)])
@pytest.mark.parametrize("d", [256, 384, 512])
def test_streamkv_fwd_matches_plain(d, bh, n, split, monkeypatch):
    """The streamed-KV wgmma forward (K3) at every head dim it takes, its KV
    range whole and split in two, against ``plain_fwd`` with the logits
    scaled up (q x 3) so that the row max moves between K/V tiles and the
    online rescale (and the split combine) runs; bit-identical across two
    calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(F, "streamkv_splits", lambda *a: split)
    g = torch.Generator(device="cuda").manual_seed(d + n + bh + split)
    q, k, v = (torch.randn((bh, n, d), generator=g, device="cuda") for _ in range(3))
    q, k, v = (q * 3).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
    scale = d ** -0.5
    before = F.launches["streamkv_fwd"]
    (o, lse), (o2, lse2) = F.streamkv_fwd(q, k, v, scale), F.streamkv_fwd(q, k, v, scale)
    assert F.launches["streamkv_fwd"] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_p, lse_p = F.plain_fwd(q, k, v, scale)
    o_max = o_p.float().abs().max()
    assert (o.float() - o_p.float()).abs().max() <= TOL_O_MAX * o_max
    assert ((o.float() - o_p.float()).norm() / o_p.float().norm()) <= TOL_O_L2
    assert (lse - lse_p).abs().max() <= TOL_LSE


@pytest.mark.cuda
def test_streamkv_and_swin_post_refuse_what_their_predicates_refuse():
    """K3's and K10b's wrappers called directly raise on what
    ``kernel_takes`` / ``swin_post_takes`` refuse, and on weights not in
    the padded form the kernel reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q = torch.randn((1, 2048, 512), device="cuda", dtype=torch.bfloat16)
    for bad in (q.float(), q[..., :128].contiguous(), q[:, :1000].contiguous()):
        assert not F.kernel_takes("streamkv_fwd", bad.dtype, *bad.shape)
        with pytest.raises(ValueError):
            F.streamkv_fwd(bad, bad, bad, 0.05)
    x, _, post = _swin_args(c=60, hidden=120)
    attn = torch.randn((2, 4, 64, 60), device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError):  # fp32 tokens
        SB.swin_post(attn, x.float(), *post, 16, 16, 8)
    big = [torch.randn((388, 60), device="cuda"), torch.randn(388, device="cuda"),
           torch.randn((60, 388), device="cuda")]
    assert not SB.swin_post_takes(torch.bfloat16, 16, 16, 8, 60, 388)
    with pytest.raises(ValueError):  # hidden 388 > 384
        SB.swin_post(attn, x, *post[:4], *big, post[7], 16, 16, 8)
    with pytest.raises(ValueError):  # unpadded bf16 weights
        SB.swin_post(attn, x, *post, 16, 16, 8,
                     packed=[post[i].to(torch.bfloat16) for i in (0, 4, 6)])


@pytest.mark.cuda
def test_tiny_flagship_restores_on_cuda():
    """``build_flagship(tiny=True)`` on the card (32-channel convs, window-4
    Swin blocks, 16-dim heads at 64 tokens: calls no port kernel takes)
    restores in its default configuration, the routes sending those calls
    to the plain versions, with finite outputs of the restore's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from edtr_torch.pipeline import build_flagship

    pipe = build_flagship(tiny=True, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    lq = torch.rand((1, 64, 64, 3), generator=g, device="cuda")
    c_txt = torch.randn((1, 77, 64), generator=g, device="cuda")
    with torch.no_grad():
        out = pipe.restore(lq, c_txt, generator=g)
    assert out["restored"].shape == (1, 64, 64, 3)
    assert out["pre_restored"].shape == (1, 64, 64, 3)
    for v in out.values():
        assert torch.isfinite(v.float()).all()


def _sass(source):
    """The SASS of ``csrc/<source>.cu``'s built library, one string per
    function (``cuobjdump -sass``)."""
    import subprocess
    from pathlib import Path

    from torch.utils.cpp_extension import CUDA_HOME

    from edtr_torch.ops import _cuda

    _cuda.load(source)
    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
                           str(_cuda.so_path(source))], capture_output=True, text=True,
                          check=True).stdout
    return sass.split("Function : ")[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("source,kernel", [("flash_attention", "streamkv_kernel"),
                                           ("swin_block", "swin_post_kernel"),
                                           ("window_attention", "window_attention_kernel"),
                                           ("geglu", "lnproj_kernel")])
def test_new_kernels_issue_hgmma(source, kernel):
    """The SASS of K3's, K10b's, K9's and K7a/K7b's kernels (``cuobjdump
    -sass`` on the built library) holds HGMMA, the wgmma instruction, in
    every instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    mine = [f for f in _sass(source) if kernel in f.splitlines()[0]]
    assert mine, f"no {kernel} in {source}'s SASS"
    assert all("HGMMA" in f for f in mine)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["flash_attention", "flash_attention_bwd", "gn_conv",
                                    "ln_matmul", "geglu", "window_attention", "swin_block"])
def test_no_kernel_issues_mma_sync(source):
    """No kernel of the port is left on mma.sync: no function in any built
    library's SASS holds HMMA, the instruction mma.sync compiles to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    funcs = _sass(source)
    assert funcs
    assert not [f.splitlines()[0] for f in funcs if "HMMA" in f]


# K9's card cases on the packed slices swin_pre writes: the restore's 64
# windows and the step's 128 at SwinIR's 6 heads x 30, no mask or a random
# one of period 64, one block a window and two; and the widest C the kernel
# takes (53 heads x 6 = WA.MAX_C, 318)
K9_CASES = [(bw, h, d, masked, split) for bw in (64, 128) for h, d in ((6, 30), (53, 6))
            for masked in (False, True) for split in (1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("bw,h,d,masked,split", K9_CASES)
def test_window_attention_matches_plain(bw, h, d, masked, split, monkeypatch):
    """The wgmma window attention (K9) against ``plain_window_attention``
    (chip_smoke's Swin limits), two calls bit-identical, window w taking
    mask row w mod 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(WA, "window_split", lambda *a: split)
    g = torch.Generator(device="cuda").manual_seed(bw + split)
    assert WA.kernel_takes(torch.bfloat16, 64, d, h)
    packed = torch.randn((bw, 64, 3 * h * d), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = packed.view(bw, 64, 3, h, d).unbind(2)
    assert WA.packed_layout(q, k, v)
    bias = torch.randn((h, 64, 64), generator=g, device="cuda") * 0.5
    mask = torch.randn((64, 64, 64), generator=g, device="cuda") * 2 if masked else None
    before = WA.launches["window_attention"]
    out, again = (WA.window_attention(q, k, v, bias, mask) for _ in range(2))
    want = WA.plain_window_attention(q, k, v, bias, mask, d ** -0.5)
    torch.cuda.synchronize()
    assert WA.launches["window_attention"] == before + 2
    assert out.shape == (bw, 64, h, d) and out.is_contiguous()
    assert torch.equal(out, again)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL_SWIN_MAX * want.float().abs().max().item(), err
    rel = ((out.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= TOL_SWIN_L2, rel


# the restore's Swin shapes at bs 8 (the cls test config's batch): SwinIR at
# 512² is a 64 x 64 token grid of C 180, window 8, 6 heads x 30, hidden 360;
# each kernel in the plan its wrapper picks past bs 1 (window_split,
# post_split), with the rolls of the plain and the shifted blocks
BS8 = 8


def _swin_rnd(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *shape, scale=1.0: torch.randn(shape, generator=g, device="cuda") * scale


def _swin_close(out, want):
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL_SWIN_MAX * want.float().abs().max().item(), err
    rel = ((out.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= TOL_SWIN_L2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_plain_at_bs8(masked):
    """K9 on the bs-8 restore's 512 windows (the shift mask in the shifted
    blocks) against ``plain_window_attention``, two calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from edtr_torch.models.swinir import shift_mask

    rnd = _swin_rnd(81 + masked)
    packed = rnd(BS8 * 64, 64, 540).to(torch.bfloat16)
    q, k, v = packed.view(BS8 * 64, 64, 3, 6, 30).unbind(2)
    bias = rnd(6, 64, 64, scale=0.5)
    mask = shift_mask(64, 64, 8, 4, "cuda") if masked else None
    before = WA.launches["window_attention"]
    out, again = (WA.window_attention(q, k, v, bias, mask) for _ in range(2))
    want = WA.plain_window_attention(q, k, v, bias, mask, 30 ** -0.5)
    torch.cuda.synchronize()
    assert WA.launches["window_attention"] == before + 2
    assert torch.equal(out, again)
    _swin_close(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0, 4, -4])
def test_swin_pre_matches_plain_at_bs8(d):
    """K10a at the bs-8 restore's shape against ``plain_swin_pre``, qkv and
    the rolled tokens bit-identical across two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rnd = _swin_rnd(82 + d)
    x = (rnd(BS8, 4096, 180, scale=2.0) + 0.5).to(torch.bfloat16)
    ln_s, ln_b = 1 + rnd(180, scale=0.1), rnd(180, scale=0.1)
    wq, bias = rnd(540, 180, scale=180 ** -0.5), rnd(540, scale=0.05)
    wp = SB.pad_weight(wq)
    before = SB.launches["swin_pre"]
    (qkv, xr), (qkv2, xr2) = (SB.swin_pre(x, ln_s, ln_b, wq, bias, 64, 64, 8, d, w_packed=wp)
                              for _ in range(2))
    assert SB.launches["swin_pre"] == before + 2
    assert torch.equal(qkv, qkv2) and torch.equal(xr, xr2)
    q_p, xr_p = SB.plain_swin_pre(x, ln_s, ln_b, wq, bias, 64, 64, 8, d)
    assert torch.equal(xr, xr_p)
    _swin_close(qkv, q_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0, 4, -4])
def test_swin_post_matches_plain_at_bs8(d):
    """K10b at the bs-8 restore's shape, its shortcut as ``swin_pre`` hands
    it at roll d, against ``plain_swin_post``, bit-identical across two
    calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rnd = _swin_rnd(83 + d)
    x = SB.roll2d((rnd(BS8, 4096, 180, scale=2.0) + 0.5).to(torch.bfloat16), d, 64,
                  64).contiguous()
    attn = rnd(BS8, 64, 64, 180).to(torch.bfloat16)
    ws = [rnd(180, 180, scale=180 ** -0.5), rnd(180, scale=0.05), 1 + rnd(180, scale=0.1),
          rnd(180, scale=0.1), rnd(360, 180, scale=180 ** -0.5), rnd(360, scale=0.05),
          rnd(180, 360, scale=360 ** -0.5), rnd(180, scale=0.05)]
    packed = [SB.pad_weight(ws[i]) for i in (0, 4, 6)]
    before = SB.launches["swin_post"]
    out, again = (SB.swin_post(attn, x, *ws, 64, 64, 8, packed=packed) for _ in range(2))
    assert SB.launches["swin_post"] == before + 2
    assert torch.equal(out, again)
    _swin_close(out, SB.plain_swin_post(attn, x, *ws, 64, 64, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n,c", [(4096, 320), (1024, 640), (256, 1280)])
def test_geglu_proj_matches_plain(n, c, b):
    """K7a on the wgmma projection kernel (``lnproj_kernel<.., PRO_NONE,
    EPI_GEGLU>``) at the flagship's three token levels, inner 4C, against
    ``plain_geglu_proj`` (chip_smoke's limits), two calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, _, _, w, bias = _proj_args(n, c, 8 * c, b)
    before = GG.launches["geglu_proj"]
    out, again = GG.geglu_proj(x, w, bias), GG.geglu_proj(x, w, bias)
    want = GG.plain_geglu_proj(x, w, bias)
    torch.cuda.synchronize()
    assert GG.launches["geglu_proj"] == before + 2
    assert out.shape == (b, n, 4 * c) and torch.equal(out, again)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL_PROJ_MAX * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_projection_wrappers_refuse_what_their_predicates_refuse():
    """The projection wrappers called directly raise where
    ``ln_matmuls_takes`` / ``affine_matmul_takes`` / ``geglu_takes`` refuse
    (fp32 tokens, O 32, inner 80), as the routes' plain fallback assumes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, s, sh, w, b = _proj_args(256, 64, 160, 2)  # 160 rows: inner 80 for GEGLU
    mul, add = s[None].expand(2, -1).contiguous(), sh[None].expand(2, -1).contiguous()
    assert not LM.ln_matmuls_takes(torch.float32, 256, 64, 128)
    with pytest.raises(ValueError):
        LM.ln_matmuls(x.float(), s, sh, [w[:128]])
    assert not LM.affine_matmul_takes(torch.bfloat16, 256, 64, 32)
    with pytest.raises(ValueError):
        LM.affine_matmul(x, mul, add, w[:32], b[:32])
    assert not GG.geglu_takes(torch.bfloat16, 256, 64, 80)
    with pytest.raises(ValueError):
        GG.geglu_proj(x, w, b)
    with pytest.raises(ValueError):
        GG.ln_geglu_proj(x, s, sh, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_proj_flagship_restores_on_cuda(dtype):
    """``build_flagship(tiny=True, fused_proj=True)`` on the card in bf16 and
    in fp32, at 128²: the tiny UNet's 16 transformer blocks see 256 tokens,
    a size JAX fuses, with 32-wide heads (O 32) and, in fp32, tokens the
    projection kernels do not take. The routes run those calls as the plain
    versions in JAX's form (no LN+q/k/v, LN+query or affine launch; in fp32
    no launch at all), the bf16 LN+GEGLU (C 32, inner 128) launches K7b
    once a block, and the restore matches the same pipeline with fused_proj
    off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from edtr_torch.pipeline import build_flagship

    pipe = build_flagship(tiny=True, dtype=dtype, fused_proj=True, device="cuda")

    def restore():
        g = torch.Generator(device="cuda").manual_seed(5)
        lq = torch.rand((1, 128, 128, 3), generator=g, device="cuda")
        c_txt = torch.randn((1, 77, 64), generator=g, device="cuda")
        with torch.no_grad():
            return pipe.restore(lq, c_txt, generator=g)
    before = {**LM.launches, **GG.launches}
    out = restore()
    taken = 16 if dtype == torch.bfloat16 else 0
    assert {**LM.launches, **GG.launches} == {**before,
                                              "ln_geglu_proj": before["ln_geglu_proj"] + taken}
    pipe.fused_proj = False
    want = restore()
    for name in ("restored", "pre_restored", "z"):
        assert torch.isfinite(out[name].float()).all()
        rel = ((out[name].float() - want[name].float()).norm() / want[name].float().norm())
        assert rel.item() <= 5e-2, (name, rel.item())


def _tied_rows(rows, n, device):
    """Rows of boxes with duplicates, scores on a coarse grid (exact ties),
    about a fifth invalid."""
    g = torch.Generator().manual_seed(n)
    xy = torch.rand((rows, n, 2), generator=g) * 100
    boxes = torch.cat([xy, xy + torch.rand((rows, n, 2), generator=g) * 33 + 1], -1)
    boxes[:, n - n // 8:] = boxes[:, torch.randint(0, n - n // 8, (n // 8,), generator=g)]
    scores = torch.randint(0, 12, (rows, n), generator=g) / 4.0
    valid = torch.rand((rows, n), generator=g) > 0.2
    return boxes.to(device), scores.to(device), valid.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 300, 1000])
def test_nms_and_top_k_on_the_card_equal_the_cpu(n):
    """The detector's rankings and NMS keep masks on the card are the CPU's
    on the same tensors, ties, duplicates and invalid entries included (the
    CPU's are held to JAX's in tests/test_torch_detection.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from edtr_torch.ops import boxes as B

    cpu = _tied_rows(3, n, "cpu")
    card = tuple(t.cuda() for t in cpu)
    for thr in (0.5, 0.7):
        keep = B.nms_mask(*card[:2], thr, card[2])
        assert keep.is_cuda
        assert torch.equal(keep.cpu(), B.nms_mask(*cpu[:2], thr, cpu[2]))
    idx, iv = B.top_k_by_score(card[1], n // 2, card[2])
    want_idx, want_iv = B.top_k_by_score(cpu[1], n // 2, cpu[2])
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(iv.cpu(), want_iv)


def _full_detector(dtype=torch.bfloat16):
    from edtr_torch.models.faster_rcnn import calibrate_heads_, fasterrcnn_mobilenet_v3_large_fpn
    from edtr_torch.models.layers import randomize_

    det = fasterrcnn_mobilenet_v3_large_fpn(num_classes=21, dtype=dtype, device="cuda")
    randomize_(det, torch.Generator(device="cuda").manual_seed(7))
    img = torch.rand((1, 3, 512, 512), generator=torch.Generator(device="cuda").manual_seed(8),
                     device="cuda")
    return calibrate_heads_(det, img), img


@pytest.mark.cuda
def test_full_width_detector_runs_on_the_card():
    """The bench's detector (21 classes, bf16, 512² -> 800²) on a CUDA
    tensor: every output on the card, of JAX's static shapes, finite, with
    valid detections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    det, img = _full_detector()
    with torch.no_grad():
        dets, losses, feats = det(img)
    assert losses == {}
    assert dets["boxes"].shape == (1, 100, 4) and dets["valid"].shape == (1, 100)
    assert feats["proposals"].shape == (1, 1000, 4)
    assert tuple(feats["features"]["0"].shape) == (1, 256, 25, 25)
    outs = [*dets.values(), feats["proposals"], feats["class_logits"],
            *feats["features"].values(), *feats["objectness"], *feats["pred_bbox_deltas"]]
    assert all(t.is_cuda for t in outs)
    assert all(torch.isfinite(t.float()).all() for t in outs if t.is_floating_point())
    assert dets["valid"].any()


@pytest.mark.cuda
def test_detect_makes_no_host_to_device_copy():
    """After its first call at a shape (the anchors, made once per shape), a
    detect call copies nothing from the host: the profiler's trace of a
    ``detect`` range holds no host-to-device copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import record_function

    from edtr_torch.profile_restore import trace_restores

    det, img = _full_detector()

    def chain():
        with record_function("detect"), torch.no_grad():
            det(img)
    chain()
    torch.cuda.synchronize()
    stage = trace_restores(chain, 2, ("detect",))["stages"]["detect"]
    assert stage["kernels"] > 0 and stage["htod_memcpy"] == 0, stage


@pytest.mark.cuda
def test_clip_on_cuda_matches_the_cpu():
    """The CLIP text tower (real vocabulary, width 64, 2 layers) on the card
    against the same tower on the CPU, fp32, the empty prompt and a
    worded one; ids outside the vocabulary raise before reaching the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from edtr_torch.models.clip import CLIPTextEncoder
    from edtr_torch.models.layers import randomize_

    cpu = randomize_(CLIPTextEncoder(width=64, heads=4, layers=2),
                     torch.Generator().manual_seed(8))
    gpu = CLIPTextEncoder(width=64, heads=4, layers=2).cuda()
    gpu.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        want = cpu.encode(["", "a restored photo"])
        got = gpu.encode(["", "a restored photo"])
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        gpu(torch.full((1, 77), 49408))


@pytest.mark.cuda
def test_tiny_step_with_a_detnet_on_cuda():
    """One EDTR step with a detector and its teacher on the card: the tiny
    flagship (train=True) and a small-knob detector, seeded targets; every
    metric finite, the ControlNet and the detnet's trainable parameters
    moved, the teacher and the frozen detnet stages unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import copy

    from edtr_torch.models.faster_rcnn import fasterrcnn_mobilenet_v3_large_fpn
    from edtr_torch.models.layers import randomize_
    from edtr_torch.pipeline import build_flagship
    from edtr_torch.train.edtr_step import (EDTRTrainState, cast_frozen_bf16,
                                            make_edtr_train_step)

    g = torch.Generator(device="cuda").manual_seed(9)
    pipe = build_flagship(tiny=True, dtype=None, device="cuda", train=True)
    det = fasterrcnn_mobilenet_v3_large_fpn(num_classes=6, device="cuda", min_size=128,
                                            rpn_pre_nms_top_n_train=64,
                                            rpn_post_nms_top_n_train=32)
    randomize_(det, g)
    teacher = copy.deepcopy(det)
    state = EDTRTrainState.create(pipe, detnet=det, teacher_detnet=teacher)
    cast_frozen_bf16(pipe, pipe.cldm.vae.train_decoder, teacher)
    step = make_edtr_train_step(pipe, detnet=det, teacher_detnet=teacher)
    boxes = torch.tensor([[[4.0, 6.0, 40.0, 50.0], [20.0, 10.0, 60.0, 44.0], [0, 0, 0, 0]]] * 2,
                         device="cuda")
    batch = dict(lq=torch.rand((2, 64, 64, 3), generator=g, device="cuda"),
                 gt=torch.rand((2, 64, 64, 3), generator=g, device="cuda"),
                 c_txt=torch.randn((2, 77, 64), generator=g, device="cuda"),
                 targets=dict(boxes=boxes, labels=torch.tensor([[1, 3, 0]] * 2, device="cuda"),
                              valid=torch.tensor([[True, True, False]] * 2, device="cuda")))
    before = {n: v.clone() for n, v in det.state_dict().items()}
    cn = {n: p.detach().clone() for n, p in pipe.cldm.controlnet.named_parameters()}
    teacher_before = {n: v.clone() for n, v in teacher.state_dict().items()}
    metrics = step(state, batch, generator=g)
    assert set(metrics) == {"loss_hlf", "loss_det", "loss_fm", "loss_objectness",
                            "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"}
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    assert all(not torch.equal(p, cn[n]) for n, p in pipe.cldm.controlnet.named_parameters())
    now = det.state_dict()
    for n, p in det.named_parameters():
        assert torch.equal(now[n], before[n]) != p.requires_grad, n
    assert all(torch.equal(v, teacher_before[n]) for n, v in teacher.state_dict().items())


@pytest.mark.cuda
def test_tiny_swinir_pre_step_kernel_vs_plain_gradients():
    """A SwinIR the Swin kernels take (C 60, two heads of 30, window 8,
    shifted at 128²) trains one swinir-pre step on the card: the kernel
    path's gradients (K10a, K9, K10b and the tail's K6 with their recompute
    backward) within 5e-2 relative L2 of the plain path's, the kernels
    launched, the loss finite and every tensor moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from edtr_torch.models.layers import randomize_
    from edtr_torch.models.swinir import SwinIR
    from edtr_torch.train import recipes as R

    sw = SwinIR(embed_dim=60, depths=(2,), num_heads=(2,), window_size=8, mlp_ratio=2, sf=8,
                dtype=torch.bfloat16).cuda()
    randomize_(sw, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    lq, gt = (torch.rand((2, 3, 128, 128), generator=g, device="cuda") for _ in range(2))

    def grads(kernel):
        sw.zero_grad(set_to_none=True)
        with R.swinir_configuration(kernel):
            R.swinir_pre_loss(sw, lq, gt).backward()
        return torch.cat([p.grad.float().flatten() for p in sw.parameters()])

    before = (dict(SB.launches), dict(WA.launches), G.launches["upsample_conv"])
    plain = grads(False)
    assert (dict(SB.launches), dict(WA.launches), G.launches["upsample_conv"]) == before
    kern = grads(True)
    assert SB.launches["swin_pre"] == before[0]["swin_pre"] + 2
    assert SB.launches["swin_post"] == before[0]["swin_post"] + 2
    assert WA.launches["window_attention"] == before[1]["window_attention"] + 2
    assert G.launches["upsample_conv"] == before[2] + 3
    rel = float((kern - plain).norm() / plain.norm())
    assert torch.isfinite(kern).all() and rel <= 5e-2, rel
    state = R.SimpleTrainState.create(sw, R.cosine_tx("adamw", 1e-4, 10, weight_decay=0.0))
    start = {n: p.detach().clone() for n, p in sw.named_parameters()}
    out = R.make_swinir_pre_train_step(sw)(state, dict(lq=lq.permute(0, 2, 3, 1),
                                                       gt=gt.permute(0, 2, 3, 1)))
    assert torch.isfinite(out["loss"])
    assert all(not torch.equal(p, start[n]) for n, p in sw.named_parameters())


@pytest.mark.cuda
def test_spaced_sampler_on_the_card_equals_the_cpu():
    """``SpacedSampler.sample`` from pure noise, with guidance, on the card
    equals the CPU's on the same x_T and step noises (fp32, 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from edtr_torch.diffusion.sampler import SpacedSampler
    from edtr_torch.diffusion.schedule import Diffusion

    betas = Diffusion.create(1000, linear_start=0.00085, linear_end=0.0120).betas
    gen = torch.Generator().manual_seed(2)
    w = torch.randn((4, 4), generator=gen) / 4
    c, u = torch.randn((2, 2, 4, 6, 6), generator=gen)
    x_T = torch.randn((2, 4, 6, 6), generator=gen)
    step_noise = torch.randn((10, 2, 4, 6, 6), generator=gen)

    def model(x, t, cond):
        return (torch.einsum("bchw,cd->bdhw", x, w.to(x.device))
                + (t.float() / 1000)[:, None, None, None] + 0.5 * cond["c"])

    outs = []
    for dev in ("cpu", "cuda"):
        sampler = SpacedSampler(betas, dev)
        x, inter = sampler.sample(model, 10, (4, 6, 6), {"c": c.to(dev)}, batch_size=2,
                                  x_T=x_T.to(dev), uncond={"c": u.to(dev)}, cfg_scale=2.5,
                                  return_intermediates=True, step_noise=step_noise.to(dev))
        assert x.device.type == dev and inter.shape == (10, 2, 4, 6, 6)
        outs.append((x.cpu(), inter.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-5, atol=1e-5)
