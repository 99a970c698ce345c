#!/usr/bin/env python3
"""Time the projection kernels K8a (``ln_matmul.ln_matmuls``), K8b
(``ln_matmul.affine_matmul``) and K7b (``geglu.ln_geglu_proj``) at every
shape of the 512² fused+proj restore, and with ``--conv`` the nearest-2x
conv K6 (``gn_conv.upsample_conv``) at every shape of the fused restore,
on one NVIDIA GPU.

    python3 proj_bench.py [--rounds R] [--plans] [--conv]

Run it from the root of a checkout: it builds that checkout's sources and
calls that checkout's ``chip_smoke.proj_case`` at each projection shape
(kernel against its plain version, with chip_smoke's error gates; device
ms of the kernel, of ``F.linear`` on the already-transformed bf16 tokens
and of the plain version; the bound). K6 is held here against its plain
version with chip_smoke's conv gates, with the weights in the form that
checkout's kernel reads, and timed the same way (device ms from a trace, so
that the host's launch time does not count; ``F.conv2d`` on the upsampled
input; the 4-tap bound). ``--rounds`` repeats the shape walk, so that two
checkouts timed in one call can be timed in turns (parent, change, change,
parent). ``--plans`` also times each projection kernel at other tile plans
(``ops/_proj.py:lnproj_plan``'s (bm, bn, groups)) than the one the wrapper
picks.

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
    """K6 at one shape ``key``: held against the plain version with
    chip_smoke's gates, and device ms of the kernel, of the plain version
    and of ``F.conv2d`` on the upsampled input; the 4-tap bound
    (chip_smoke.conv_case's). The weights go in the form the checkout's
    kernel reads: folded (``fold_subpixel_weights``) where it has that,
    else 9-tap (``pack_weight``)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from edtr_torch.ops import gn_conv as GC

    _, b, cin, h, w, cout, _, _, act = key
    bf16 = torch.bfloat16
    x = torch.randn((b, cin, h // 2, w // 2), generator=gen, device=device).to(bf16)
    x = x.contiguous(memory_format=torch.channels_last)
    w32 = torch.randn((cout, cin, 3, 3), generator=gen, device=device) * (9 * cin) ** -0.5
    bias = 0.05 * torch.randn(cout, generator=gen, device=device)
    fold = getattr(GC, "fold_subpixel_weights", None)
    wp = fold(w32, bf16) if fold is not None else GC.pack_weight(w32, bf16)
    wb = w32.to(bf16).contiguous(memory_format=torch.channels_last)
    up = F.interpolate(x, scale_factor=2.0, mode="nearest")

    def kern():
        return GC.upsample_conv(x, w32, bias, act, w_packed=wp)
    got, want = kern(), GC.plain_upsample_conv(x, w32, bias, act)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    o_max = want.float().abs().max().item()
    rel = chip_smoke.rel_l2(got, want)
    chip_smoke.check(err <= chip_smoke.TOL_CONV_MAX * o_max and rel <= chip_smoke.TOL_CONV_L2,
                     f"{key} vs plain: max abs {err}, rel L2 {rel}")
    flops = 2.0 * b * h * w * 4 * cin * cout
    t_ops = flops / chip_smoke.PEAK_BF16_FLOPS * 1e3
    t_bytes = ((b * h * w // 4 * cin + b * h * w * cout + 9 * cin * cout) * 2
               / chip_smoke.PEAK_BYTES * 1e3)
    return dict(ms=chip_smoke.device_ms(kern, 20),
                plain_ms=chip_smoke.device_ms(
                    lambda: GC.plain_upsample_conv(x, w32, bias, act), 3, 1),
                library_ms=chip_smoke.device_ms(lambda: F.conv2d(up, wb, None, 1, 1), 20),
                event_ms=chip_smoke.time_ms(kern, 20), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_err_share=err / o_max, rel_l2=rel)


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
        for key, count in sorted(CONV_SHAPES.items(), key=str) if args.conv else ():
            r = conv_shape(device, key, gen)
            print("conv shape:", json.dumps(dict(round=rnd, key=list(key), launches=count, **r)),
                  flush=True)
            agg = sums.setdefault((rnd, key[0]), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
    for (rnd, name), agg in sorted(sums.items()):
        print("proj summary:", json.dumps(dict(
            card=card, round=rnd, kernel=name, scope="per fused" + (
                "" if name == "upsample_conv" else "+proj") + " 512² restore", **agg)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
