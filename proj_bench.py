#!/usr/bin/env python3
"""Time the projection kernels K8a (``ln_matmul.ln_matmuls``), K8b
(``ln_matmul.affine_matmul``) and K7b (``geglu.ln_geglu_proj``) at every
shape of the 512² fused+proj restore, and with ``--conv`` the conv kernels
K5a/K5b (``gn_conv.gn_silu_conv``: ``gn_conv_whole``, ``gn_conv_band``) and
K6 (``gn_conv.upsample_conv``) at every shape of the fused restore, on one
NVIDIA GPU.

    python3 proj_bench.py [--rounds R] [--plans] [--conv]

Run it from the root of a checkout: it builds that checkout's sources and
calls that checkout's ``chip_smoke.proj_case`` at each projection shape
(kernel against its plain version, with chip_smoke's error gates; device
ms of the kernel, of ``F.linear`` on the already-transformed bf16 tokens
and of the plain version; the bound). The conv kernels are held here
against their plain versions with chip_smoke's conv gates (K6 with the
weights in the form that checkout's kernel reads) and timed the same way:
device ms from a trace, so that the host's launch time does not count, and
``F.conv2d`` on the activated (K5) or upsampled (K6) bf16 input; the 9-tap
(K5) or 4-tap (K6) bound. ``--rounds`` repeats the shape walk, so that two
checkouts timed in one call can be timed in turns (parent, change, change,
parent). ``--plans`` also times each projection kernel at other tile plans
(``ops/_proj.py:lnproj_plan``'s (bm, bn, groups)) than the one the wrapper
picks, and with ``--conv`` each K5 shape at the other tiles
(``gn_conv.GN_TILES``) the kernel takes.

Prints one ``proj shape:`` (``conv shape:``) JSON line per shape and
round, then a ``proj summary:`` line per kernel: the launch-weighted device
ms per restore (the sums of chip_smoke's ``kernels`` line), with the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the fused+proj 512² restore's K8a/K8b/K7b launches per shape: 4 steps x
# (UNet 5 + ControlNet 2) transformer blocks at each of 4096, 1024 and 256
# tokens, each one GroupNorm-affine + proj_in, one LN + q/k/v (K = 3), one
# LN + query (K = 1) and one LN + GEGLU; keys as ``ln_matmul.shapes`` /
# ``geglu.shapes`` log them
TOKENS = ((4096, 320), (1024, 640), (256, 1280))
RESTORE_SHAPES = {
    **{("ln_matmuls", 1, n, c, c, k): 28 for n, c in TOKENS for k in (1, 3)},
    **{("affine_matmul", 1, n, c, c, 1): 28 for n, c in TOKENS},
    **{("ln_geglu_proj", 1, n, c, 4 * c): 28 for n, c in TOKENS},
}
# the fused 512² restore's K6 launches per shape (``gn_conv.shapes`` keys:
# wrapper, B, Cin, output H, W, Cout, emb, res, act): the UNet decoder's 3
# upsamples in each of 4 steps, the VAE decoder's 3, the SwinIR tail's 3
CONV_SHAPES = {
    ("upsample_conv", 1, 1280, 16, 16, 1280, False, False, None): 4,
    ("upsample_conv", 1, 1280, 32, 32, 1280, False, False, None): 4,
    ("upsample_conv", 1, 640, 64, 64, 640, False, False, None): 4,
    ("upsample_conv", 1, 512, 128, 128, 512, False, False, None): 1,
    ("upsample_conv", 1, 512, 256, 256, 512, False, False, None): 1,
    ("upsample_conv", 1, 256, 512, 512, 256, False, False, None): 1,
    **{("upsample_conv", 1, 64, h, h, 64, False, False, "lrelu"): 1 for h in (128, 256, 512)},
}
CONV_NAMES = ("gn_conv_whole", "gn_conv_band", "upsample_conv")


def _k5(cin, hw, cout, emb, res):
    return ("gn_conv_whole" if hw < 16 else "gn_conv_band", 1, cin, hw, hw, cout, emb, res,
            None)


# the fused 512² restore's K5 launches per shape (``gn_conv.shapes`` keys,
# which chip_smoke.py holds to these): a ResBlock is two launches, the
# first adding emb (UNet, ControlNet), the second the skip. 4 steps x (UNet
# 22 + ControlNet 10 ResBlocks): at 8² (K5a) the UNet's 2 input, 2 middle
# and 3 output blocks and the ControlNet's 2 + 2; at 16²-64² 2 input blocks
# each (both nets) and the UNet's 3 output blocks (their inputs concatenate
# a skip). The VAE's encoder (10 ResBlocks) and decoder (14) at 64²-512².
# The training step (bs 2) launches the same shapes with B = 2.
GN_SHAPES = {
    _k5(1280, 8, 1280, True, False): 32, _k5(1280, 8, 1280, False, True): 44,
    _k5(2560, 8, 1280, True, False): 12,
    _k5(640, 16, 1280, True, False): 8, _k5(1280, 16, 1280, False, True): 28,
    _k5(1280, 16, 1280, True, False): 8, _k5(2560, 16, 1280, True, False): 8,
    _k5(1920, 16, 1280, True, False): 4,
    _k5(320, 32, 640, True, False): 8, _k5(640, 32, 640, False, True): 28,
    _k5(640, 32, 640, True, False): 8, _k5(1920, 32, 640, True, False): 4,
    _k5(1280, 32, 640, True, False): 4, _k5(960, 32, 640, True, False): 4,
    _k5(320, 64, 320, True, False): 16, _k5(320, 64, 320, False, True): 28,
    _k5(960, 64, 320, True, False): 4, _k5(640, 64, 320, True, False): 8,
    _k5(512, 64, 512, False, False): 9, _k5(512, 64, 512, False, True): 9,
    _k5(256, 128, 512, False, False): 1, _k5(512, 128, 512, False, True): 5,
    _k5(512, 128, 512, False, False): 4,
    _k5(128, 256, 256, False, False): 1, _k5(256, 256, 256, False, True): 5,
    _k5(256, 256, 256, False, False): 3, _k5(512, 256, 256, False, False): 1,
    _k5(128, 512, 128, False, False): 4, _k5(128, 512, 128, False, True): 5,
    _k5(256, 512, 128, False, False): 1,
}


def plan_sweep(device, key, gen) -> None:
    """The kernel of ``key`` at each (bm, bn, groups) the kernels take and
    shared memory holds (groups of 1 to 8 tiles a block): device ms, and
    the error against the plain version."""
    import torch

    import chip_smoke
    from edtr_torch.ops import _proj
    from edtr_torch.ops import geglu as GG
    from edtr_torch.ops import ln_matmul as LM

    name, b, n, c = key[:4]
    geglu = name == "ln_geglu_proj"
    affine = name == "affine_matmul"
    x = (torch.randn((b, n, c), generator=gen, device=device) * 2 + 0.5).to(torch.bfloat16)
    s = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
    sh = 0.1 * torch.randn(c, generator=gen, device=device)
    if geglu:
        slab = 2 * key[4]
        w = torch.randn((slab, c), generator=gen, device=device) * c ** -0.5
        bias = 0.05 * torch.randn(slab, generator=gen, device=device)
        wp = w.to(torch.bfloat16)

        def kern():
            return GG.ln_geglu_proj(x, s, sh, w, bias, w_packed=wp)
        want = GG.plain_ln_geglu_proj(x, s, sh, w, bias)
    elif affine:
        slab = key[4]
        w = torch.randn((slab, c), generator=gen, device=device) * c ** -0.5
        bias = 0.05 * torch.randn(slab, generator=gen, device=device)
        mul = 1 + 0.1 * torch.randn((b, c), generator=gen, device=device)
        add = 0.1 * torch.randn((b, c), generator=gen, device=device)
        wp = w.to(torch.bfloat16)

        def kern():
            return LM.affine_matmul(x, mul, add, w, bias, w_packed=wp)
        want = LM.plain_affine_matmul(x, mul, add, w, bias)
    else:
        o, k = key[4], key[5]
        slab = k * o
        ws = [torch.randn((o, c), generator=gen, device=device) * c ** -0.5 for _ in range(k)]
        wp = torch.cat([w.to(torch.bfloat16) for w in ws])

        def kern():
            return torch.cat(LM.ln_matmuls(x, s, sh, ws, w_packed=wp), -1)
        want = torch.cat(LM.plain_ln_matmuls(x, s, sh, ws), -1)
    m = b * n
    picked = _proj.lnproj_plan(m, c, slab, name)
    for bm in (32, 64):
        for bn in (128, 64) if geglu else ((160, 128, 64) if affine else (160, 64)):
            if m % bm or slab % bn or _proj.lnproj_stages(bn, c) < 2:
                continue
            tiles = slab // bn
            for groups in sorted({-(-tiles // q) for q in range(1, min(tiles, 8) + 1)}):
                plan = (bm, bn, groups)
                real = (LM.lnproj_plan, GG.lnproj_plan)
                LM.lnproj_plan = GG.lnproj_plan = lambda *a, _p=plan: _p
                try:
                    got = kern()
                    torch.cuda.synchronize()
                    err = ((got.float() - want.float()).abs().max()
                           / want.float().abs().max()).item()
                    ms = chip_smoke.device_ms(kern, 20)
                finally:
                    LM.lnproj_plan, GG.lnproj_plan = real
                print("proj plan:", json.dumps(dict(
                    key=list(key), plan=list(plan), picked=plan == picked,
                    blocks=(m // bm) * groups, tiles_per_block=-(-tiles // groups), ms=ms,
                    max_err_share=err)), flush=True)


def conv_shape(device, key, gen) -> dict:
    """A conv kernel at one shape ``key`` (``gn_conv.shapes``' key): held
    against its plain version with chip_smoke's gates, and device ms of the
    kernel, of the plain version and of ``F.conv2d`` on the activated (K5)
    or upsampled (K6) input; the bound (chip_smoke.conv_case's: K6 counts 4
    taps). K6's weights go in the form the checkout's kernel reads: folded
    (``fold_subpixel_weights``) where it has that, else 9-tap
    (``pack_weight``)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from edtr_torch.ops import gn_conv as GC

    name, b, cin, h, w, cout, has_emb, has_res, act = key
    up = name == "upsample_conv"
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    hin, win = (h // 2, w // 2) if up else (h, w)
    x = randn(b, cin, hin, win).to(bf16).contiguous(memory_format=torch.channels_last)
    w32 = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = randn(cout, scale=0.05)
    wb = w32.to(bf16).contiguous(memory_format=torch.channels_last)
    if up:
        fold = getattr(GC, "fold_subpixel_weights", None)
        wp = fold(w32, bf16) if fold is not None else GC.pack_weight(w32, bf16)
        lib_in = F.interpolate(x, scale_factor=2.0, mode="nearest")

        def kern():
            return GC.upsample_conv(x, w32, bias, act, w_packed=wp)

        def plain():
            return GC.plain_upsample_conv(x, w32, bias, act)
    else:
        wp = GC.pack_weight(w32, bf16)
        mul, add = 1 + randn(b, cin, scale=0.1), randn(b, cin, scale=0.1)
        emb = randn(b, cout, scale=0.5).to(bf16) if has_emb else None
        res = (randn(b, cout, h, w).to(bf16).contiguous(memory_format=torch.channels_last)
               if has_res else None)
        lib_in = F.silu((x.float() * mul[:, :, None, None] + add[:, :, None, None]).to(bf16))

        def kern():
            return GC.gn_silu_conv(x, mul, add, w32, bias, emb, res, w_packed=wp)

        def plain():
            return GC.plain_gn_silu_conv(x, mul, add, w32, bias, emb, res)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    o_max = want.float().abs().max().item()
    rel = chip_smoke.rel_l2(got, want)
    chip_smoke.check(err <= chip_smoke.TOL_CONV_MAX * o_max and rel <= chip_smoke.TOL_CONV_L2,
                     f"{key} vs plain: max abs {err}, rel L2 {rel}")
    flops = 2.0 * b * h * w * (4 if up else 9) * cin * cout
    t_ops = flops / chip_smoke.PEAK_BF16_FLOPS * 1e3
    t_bytes = ((b * hin * win * cin + b * h * w * cout * (2 if has_res else 1)
                + 9 * cin * cout) * 2 / chip_smoke.PEAK_BYTES * 1e3)
    iters = max(5, min(20, int(2e12 / flops)))
    return dict(ms=chip_smoke.device_ms(kern, iters),
                plain_ms=chip_smoke.device_ms(plain, 3, 1),
                library_ms=chip_smoke.device_ms(lambda: F.conv2d(lib_in, wb, None, 1, 1), iters),
                event_ms=chip_smoke.time_ms(kern, iters), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_err_share=err / o_max, rel_l2=rel)


def gn_plan_sweep(device, key, gen) -> None:
    """K5 at ``key`` with each tile of ``gn_conv.GN_TILES`` its tier takes
    (8-row tiles for the whole-image tier, 16 rows for the band; the split
    rule of ``gn_conv.gn_split``): device ms and the error, as
    :func:`conv_shape` gives them."""
    from edtr_torch.ops import gn_conv as GC

    name, b, cin, h, w, cout = key[:6]
    real = GC.gn_plan
    picked = real(b, h, w, cin, cout, name)
    for (wn, th), bn in sorted(GC.GN_TILES.items()):
        if (th == 8) != (name == "gn_conv_whole") or cout % bn:
            continue
        plan = GC.gn_split(b, h, w, cin, cout, wn, th)
        GC.gn_plan = lambda *a, _p=plan: _p
        try:
            r = conv_shape(device, key, gen)
        finally:
            GC.gn_plan = real
        print("conv plan:", json.dumps(dict(key=list(key), plan=list(plan),
                                            picked=plan == picked, ms=r["ms"],
                                            max_err_share=r["max_err_share"])), flush=True)


def main() -> int:
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--conv", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("proj_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    from edtr_torch.ops import _cuda

    print("nvcc s:", _cuda.build_all(["ln_matmul", "geglu"] + ["gn_conv"] * args.conv),
          flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(7)
    keys = ("ms", "event_ms", "library_ms", "plain_ms", "bound_ms")
    sums = {}
    for rnd in range(args.rounds):
        for key, count in sorted(RESTORE_SHAPES.items(), key=str):
            r = chip_smoke.proj_case(device, key, gen)
            line = dict(round=rnd, key=list(key), launches=count, tile=r.get("tile"),
                        max_err_share=r["max_abs_err"] / r["out_max"], rel_l2=r["rel_l2"],
                        bound_by=r["bound_by"], **{k: r[k] for k in keys})
            print("proj shape:", json.dumps(line), flush=True)
            agg = sums.setdefault((rnd, key[0]), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
            if args.plans and rnd == 0:
                plan_sweep(device, key, gen)
        conv = {**GN_SHAPES, **CONV_SHAPES} if args.conv else {}
        for key, count in sorted(conv.items(), key=str):
            r = conv_shape(device, key, gen)
            print("conv shape:", json.dumps(dict(round=rnd, key=list(key), launches=count, **r)),
                  flush=True)
            agg = sums.setdefault((rnd, key[0]), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
            if args.plans and rnd == 0 and key[0] != "upsample_conv":
                gn_plan_sweep(device, key, gen)
    for (rnd, name), agg in sorted(sums.items()):
        print("proj summary:", json.dumps(dict(
            card=card, round=rnd, kernel=name, scope="per fused" + (
                "" if name in CONV_NAMES else "+proj") + " 512² restore", **agg)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
